"""Kernel launches a period (a count), in the traced window."""


def read(ctx):
    n = ctx["trace"]["kernels"]
    return n / ctx["trace"]["steps"] if n else None
