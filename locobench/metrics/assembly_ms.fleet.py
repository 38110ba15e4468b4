"""Device milliseconds a period of everything but row 1: the tick, the MPC
assembly and the copies around them."""
from locobench.metrics import kernel_seconds


def read(ctx):
    row1 = kernel_seconds(ctx, ctx["config"]["row1_kernel"]) or 0.0
    total = sum(ctx["trace"]["by_name"].values())
    return (total - row1) * 1e3 / ctx["trace"]["steps"]
