"""Plain PyTorch versions of the two building blocks the QP kernels share:
the fixed-count OSQP ADMM loop and the inverse of the SPD KKT matrix.

Counterpart of ``rl_mpc_locomotion_tpu/ops/pallas/admm_kernel.py``
(``_admm_math``, ``gj_invert_symmetric``), batch-major: every tensor has the
robots on its leading axis. On the card both run inside the fused kernel
(``csrc/qp_phases.cuh``: ``admm``, ``spd_invert``); these versions are what
that kernel is held against and what CPU tensors go through.
"""
from __future__ import annotations

import torch


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
    kernel runs Gauss-Jordan without pivoting, this runs a Cholesky."""
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
