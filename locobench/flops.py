"""The frozen operation and byte counts of one row-1 solve (the fused chain
QP kernel), from the QP's shapes alone.

A robot's solve, as the configuration states it (horizon h, state 13,
inputs 12 a step, n = 12 h variables, nb = 4 h cone blocks of 5 x 3,
m = 5 nb rows, ``iters`` ADMM steps, ``ruiz_iters`` Ruiz passes), counts
float32 operations (an FMA is 2) as follows:

- ``hessian``: P from the chain, the h (h + 1) / 2 blocks of its lower
  triangle, each a 12 x 12 sum over 13 state rows: 2 * 12 * 12 * 13 a block.
- ``mask``: the swing mask of P, q: 3 n^2.
- ``ruiz``: a pass reads P for the column norms, scales it and rescales it
  by the cost factor: 5 n^2 a pass.
- ``factor``: K's factor, counted as a Cholesky: n^3 / 3 (the kernel forms
  the whole inverse by Gauss-Jordan, about n^3; the least work is the
  factor).
- ``admm``: ``iters`` steps and the residual's solve at x~, each a solve
  with the factor (2 n^2, the two triangular solves, as much as a product
  with the inverse), C and C^T on the block-diagonal cone (4 * 15 a block:
  2 operations a nonzero, twice), and the vector updates (6 m + 3 n).
- ``residuals``: the residuals, the rho rescale and the unscaling: 20 (n + m).

For the production QP (h = 10, 24 steps, 2 passes) that is 1 794 520 a
solve; at 4096 robots over the H100's 67 TFLOP/s float32 peak outside the
tensor cores, 0.1097 ms, the bound that ``PERF.md``'s kernel table gives row
1. The bytes are each input read once and each output written once.
"""
from __future__ import annotations

STATE = 13
INPUTS = 12


def solve_terms(horizon: int, iters: int, ruiz_iters: int) -> dict:
    """Operations of one robot's solve, term by term."""
    n, nb = INPUTS * horizon, 4 * horizon
    m = 5 * nb
    blocks = horizon * (horizon + 1) // 2
    return {
        "hessian": 2 * blocks * INPUTS * INPUTS * STATE,
        "mask": 3 * n * n,
        "ruiz": ruiz_iters * 5 * n * n,
        "factor": n ** 3 / 3,
        "admm": (iters + 1) * (2 * n * n + 4 * nb * 15 + 6 * m + 3 * n),
        "residuals": 20 * (n + m),
    }


def solve_flops(horizon: int, iters: int, ruiz_iters: int) -> float:
    return float(sum(solve_terms(horizon, iters, ruiz_iters).values()))


def solve_bytes(horizon: int) -> int:
    """Float32 bytes a robot's solve must move: in, the chain (h, 13, 12),
    the weights, q, the cone blocks, lb, ub, the mask, the warm start x, z,
    y and rho; out, x, z, y, rho, the violation and two residuals."""
    n, nb = INPUTS * horizon, 4 * horizon
    m = 5 * nb
    floats_in = horizon * STATE * INPUTS + STATE + 3 * n + 15 * nb + 4 * m + 1
    floats_out = n + 2 * m + 4
    return 4 * (floats_in + floats_out)


def least_seconds(robots: int, qp: dict, peaks: dict) -> float:
    """The least time the card could take for one solve of every robot:
    the larger of the operations over the float32 peak and the bytes over
    the memory rate."""
    ops = robots * solve_flops(qp["horizon"], qp["iters"], qp["ruiz_iters"])
    data = robots * solve_bytes(qp["horizon"])
    return max(ops / peaks["f32_flops"], data / peaks["hbm_bytes_per_s"])
