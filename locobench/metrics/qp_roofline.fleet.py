"""Row 1's share of its roofline, in %: the least time of a period's solves
(``locobench/flops.py``, operations over the float32 peak or bytes over the
memory rate, whichever is larger) over the kernel's measured time."""
from locobench import flops
from locobench.metrics import kernel_seconds


def read(ctx):
    sec = kernel_seconds(ctx, ctx["config"]["row1_kernel"])
    if sec is None or ctx["peaks"] is None:
        return None
    least = flops.least_seconds(ctx["robots"], ctx["config"]["qp_shape"],
                                ctx["peaks"])
    return 100.0 * least / (sec / ctx["trace"]["steps"])
