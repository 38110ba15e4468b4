"""The loops a configuration names: what a step of the window drives,
and the comparison of its answers with the reference."""
