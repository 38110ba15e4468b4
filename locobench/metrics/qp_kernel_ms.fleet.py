"""Row 1's device milliseconds a period: the fused chain-QP kernel's time in
the traced window over the traced periods."""
from locobench.metrics import kernel_seconds


def read(ctx):
    sec = kernel_seconds(ctx, ctx["config"]["row1_kernel"])
    return None if sec is None else sec * 1e3 / ctx["trace"]["steps"]
