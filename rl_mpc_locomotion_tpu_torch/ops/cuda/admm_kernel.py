"""Inverse + ADMM on an already scaled QP as one CUDA kernel, and the plain
PyTorch versions of the two building blocks the QP kernels share: the
fixed-count OSQP ADMM loop and the inverse of the SPD KKT matrix.

Counterpart of ``rl_mpc_locomotion_tpu/ops/pallas/admm_kernel.py``
(``solve_scaled_batch`` / ``_gj_admm_kernel``, ``_admm_math``,
``gj_invert_symmetric``), batch-major: every tensor has the robots on its
leading axis. The TPU kernel pads the batch to a multiple of its 128-robot
tile with identity K and rho 1; the CUDA kernel runs one thread block a
robot and needs no padding. ``gj_invert_inplace`` / ``gj_invert_symmetric``
are in-kernel helpers there; their counterpart is ``spd_invert`` in
``csrc/qp_phases.cuh`` (a Gauss-Jordan inverse in registers), which has no
panel width.

``solve_scaled_batch`` launches ``csrc/scaled_solve.cu`` for CUDA tensors,
or raises; CPU tensors take ``solve_scaled_batch_reference``
(``spd_inverse`` + ``_admm_math``), which is also what the kernel is compared
with. ``launch_count()`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_launches = 0
_bound = None


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count()``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def c_apply(c_blocks, v):
    """C v with block-diagonal C: (B,nb,5,3), (B,nb*3) -> (B,nb*5)."""
    b, nb = c_blocks.shape[:2]
    return torch.einsum('bkij,bkj->bki', c_blocks, v.reshape(b, nb, 3)
                        ).reshape(b, nb * 5)


def ct_apply(c_blocks, w):
    """C^T w: (B,nb,5,3), (B,nb*5) -> (B,nb*3)."""
    b, nb = c_blocks.shape[:2]
    return torch.einsum('bkij,bki->bkj', c_blocks, w.reshape(b, nb, 5)
                        ).reshape(b, nb * 3)


def spd_inverse(k_mat):
    """K^-1 of a batch of SPD matrices (B,n,n). The contract is the accuracy
    of a solve with it (5e-4 absolute against float64), not the scheme: the
    kernels run Gauss-Jordan without pivoting, this runs a Cholesky."""
    chol = torch.linalg.cholesky_ex(k_mat).L
    return torch.cholesky_inverse(chol)


def _admm_math(iters: int, sigma: float, relax: float, kinv_apply,
               c_blocks, q_s, l_s, u_s, rho, x, z, y):
    """``iters`` ADMM steps on scaled data; ``kinv_apply`` solves K x = rhs.

    Shapes: q_s, x (B,n); c_blocks (B,nb,5,3); l_s, u_s, rho, z, y (B,m).
    """
    rho_inv = 1.0 / rho
    for _ in range(iters):
        rhs = sigma * x - q_s + ct_apply(c_blocks, rho * z - y)
        x_t = kinv_apply(rhs)
        z_t = c_apply(c_blocks, x_t)
        x = relax * x_t + (1.0 - relax) * x
        z_r = relax * z_t + (1.0 - relax) * z
        z_new = torch.minimum(torch.maximum(z_r + rho_inv * y, l_s), u_s)
        y = y + rho * (z_r - z_new)
        z = z_new
    return x, z, y


def _library():
    global _bound
    if _bound is None:
        lib = _build.load_library()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmpc_scaled_solve.argtypes = (
            [ptr] * 12 + [i32] * 5 + [f32] * 2 + [ptr])
        lib.rlmpc_scaled_solve.restype = i32
        _bound = lib
    return _bound


def solve_scaled_batch(k_mat, q_s, c_s, l_s, u_s, rho, x, z, y, *,
                       iters: int, sigma: float, relax: float):
    """Batched solve of scaled QPs: invert K, then ``iters`` ADMM steps.

    Batch-major float32: k_mat (B,n,n) the scaled, assembled SPD
    ``K = P_s + sigma I + C_s^T diag(rho) C_s``, q_s (B,n), c_s (B,nb,5,3),
    l_s/u_s/rho (B,m), warm start x (B,n), z/y (B,m), n = 3*nb, m = 5*nb.
    ``rho`` is per row (the rho restart hands in a clipped per-row rho).
    Returns (x, z, y) of the scaled problem. ``iters = 0`` returns the warm
    start unchanged.

    CUDA tensors go through the kernel on the current stream, without a
    synchronise, or raise; CPU tensors go through the plain version.
    """
    if k_mat.dim() != 3:
        raise ValueError(f"k_mat must be (B,n,n), got {tuple(k_mat.shape)}")
    b, n = k_mat.shape[0], k_mat.shape[-1]
    if b < 1 or n < 3 or n % 3 != 0 or iters < 0:
        raise ValueError(f"need B >= 1, n divisible by 3 and iters >= 0, got "
                         f"B={b} n={n} iters={iters}")
    nb, m = n // 3, 5 * (n // 3)
    _build.check_tensors(
        {"k_mat": (b, n, n), "q_s": (b, n), "c_s": (b, nb, 5, 3),
         "l_s": (b, m), "u_s": (b, m), "rho": (b, m), "x": (b, n),
         "z": (b, m), "y": (b, m)},
        {"k_mat": k_mat, "q_s": q_s, "c_s": c_s, "l_s": l_s, "u_s": u_s,
         "rho": rho, "x": x, "z": z, "y": y})
    if _build.kernel_device(k_mat) == "cpu":
        return solve_scaled_batch_reference(k_mat, q_s, c_s, l_s, u_s, rho,
                                            x, z, y, iters=iters, sigma=sigma,
                                            relax=relax)

    lib = _library()
    _build.check_shared(lib.rlmpc_qp_shared_bytes(n, m, nb),
                        f"n={n} m={m} nb={nb}")
    dev = k_mat.device
    outs = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                 for shape in ((b, n), (b, m), (b, m)))
    tensors = (k_mat, q_s, c_s, l_s, u_s, rho, x, z, y) + outs
    with torch.cuda.device(dev):
        err = lib.rlmpc_scaled_solve(
            *[t.data_ptr() for t in tensors], b, n, m, nb, int(iters),
            float(sigma), float(relax), _build.stream_of(k_mat))
    _build.check_launch(err, "scaled_solve")
    global _launches
    _launches += 1
    return outs


def solve_scaled_batch_reference(k_mat, q_s, c_s, l_s, u_s, rho, x, z, y, *,
                                 iters: int, sigma: float, relax: float):
    """The kernel's two phases in plain PyTorch: ``spd_inverse``, then
    ``_admm_math``. Same arguments and returns as ``solve_scaled_batch``."""
    k_inv = spd_inverse(k_mat)
    return _admm_math(iters, sigma, relax,
                      lambda rhs: torch.einsum('bij,bj->bi', k_inv, rhs),
                      c_s, q_s, l_s, u_s, rho, x, z, y)
