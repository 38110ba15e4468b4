"""Device milliseconds a tick inside the harness's range around
``runner.min_step``: the tick, the MPC assembly and row 1."""
from locobench.metrics import range_seconds


def read(ctx):
    sec = range_seconds(ctx, "tick.min_step")
    return None if sec is None else sec * 1e3 / ctx["trace"]["steps"]
