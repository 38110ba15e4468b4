"""Device milliseconds a tick inside the harness's range around the
articulated ``physics.step``."""
from locobench.metrics import range_seconds


def read(ctx):
    sec = range_seconds(ctx, "plant.physics_step")
    return None if sec is None else sec * 1e3 / ctx["trace"]["steps"]
