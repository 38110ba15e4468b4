"""The period's share of the card's float32 peak, in %: the frozen
operation count of the period's solves (``locobench/flops.py``) over the
traced period times the peak. It reads the same work whatever implements
it."""
from locobench import flops


def read(ctx):
    tr = ctx["trace"]
    if ctx["peaks"] is None or tr["kernels"] == 0:
        return None
    qp = ctx["config"]["qp_shape"]
    ops = ctx["robots"] * flops.solve_flops(qp["horizon"], qp["iters"],
                                            qp["ruiz_iters"])
    return 100.0 * ops / (tr["window_s"] / tr["steps"] * ctx["peaks"]["f32_flops"])
