"""The headless demos (``simulator_test``, ``mpc_terrain_show``,
``rl_mpc_show``): ``python -m rl_mpc_locomotion_tpu_torch.examples.<name>``.
"""
