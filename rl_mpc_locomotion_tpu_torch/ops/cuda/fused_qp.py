"""The whole GRF-QP solve from the condensation chain as one CUDA kernel.

Counterpart of ``fused_solve_chain_batch`` in
``rl_mpc_locomotion_tpu/ops/pallas/fused_qp.py`` (``_fused_kernel_chain`` +
``_solve_phases``). For each robot the kernel builds the Hessian
``P = 2 B_qp^T Q B_qp + alpha I`` from the chain ``s[k] = A^k B``, masks the
swing variables, Ruiz-equilibrates, assembles ``K = P + sigma I + C^T rho C``,
inverts it, runs the fixed count of ADMM steps with ``K^-1`` resident, takes
the relative residuals at ``x~`` and the deferred rho rescale, and unscales.

The kernel is ``csrc/fused_qp.cu`` (phases in ``csrc/qp_phases.cuh``), one
thread block a robot with ``K`` in shared memory, written for ``sm_90a`` and
built by ``_build.py`` at first use. On an H100 it is bound by f32 arithmetic
on operands that never leave the SM (about 3 MFLOP a robot, a third of it the
inverse), not by device memory (about 15 KB a robot); the notes in
``qp_phases.cuh`` say what the design does about that.

``fused_solve_chain_batch`` launches the kernel for CUDA tensors, or raises;
for CPU tensors it takes ``fused_solve_chain_batch_reference``, the same
eight phases in plain PyTorch, which is also what the kernel is compared
with. ``launch_count()`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .admm_kernel import _admm_math, c_apply, ct_apply, spd_inverse

MAX_SHARED_BYTES = 232448   # dynamic shared memory a block may ask for on sm_90

_launches = 0
_bound = None


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count()``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _library():
    """The compiled library with its argument types set."""
    global _bound
    if _bound is None:
        lib = _build.load_library()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmpc_fused_solve_chain.argtypes = (
            [ptr] * 17 + [i32] * 9 + [f32] * 5 + [ptr])
        lib.rlmpc_fused_solve_chain.restype = i32
        lib.rlmpc_fused_chain_shared_bytes.argtypes = [i32] * 5
        lib.rlmpc_fused_chain_shared_bytes.restype = i32
        lib.rlmpc_error_string.argtypes = [i32]
        lib.rlmpc_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _check_inputs(s_chain, weights, q_vec, c_blocks, lb, ub, mask, x, z, y,
                  rho_mult):
    """Shapes, dtype, device and contiguity the kernel takes; returns the
    sizes (b, n, m, nb, h, sd)."""
    if s_chain.dim() != 4:
        raise ValueError(f"s_chain must be (B,h,sd,ad), got {tuple(s_chain.shape)}")
    b, h, sd, ad = s_chain.shape
    n = h * ad
    if b < 1 or n % 3 != 0:
        raise ValueError(f"need B >= 1 and n = h*ad divisible by 3, got B={b} n={n}")
    nb = n // 3
    m = 5 * nb
    want = {"s_chain": (b, h, sd, ad), "weights": (b, sd), "q_vec": (b, n),
            "c_blocks": (b, nb, 5, 3), "lb": (b, m), "ub": (b, m),
            "mask": (b, n), "x": (b, n), "z": (b, m), "y": (b, m),
            "rho_mult": (b,)}
    got = {"s_chain": s_chain, "weights": weights, "q_vec": q_vec,
           "c_blocks": c_blocks, "lb": lb, "ub": ub, "mask": mask, "x": x,
           "z": z, "y": y, "rho_mult": rho_mult}
    for name, shape in want.items():
        t = got[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != s_chain.device:
            raise ValueError(f"{name}: on {t.device}, s_chain on {s_chain.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    return b, n, m, nb, h, sd


def fused_solve_chain_batch(s_chain, weights, q_vec, c_blocks, lb, ub, mask,
                            x, z, y, rho_mult, *, alpha: float, iters: int,
                            sigma: float, relax: float, rho_base: float,
                            rho_eq_scale: float, ruiz_iters: int,
                            deferred_rho: bool):
    """Batched full QP solve from the condensation chain.

    Batch-major float32: s_chain (B,h,sd,ad), weights (B,sd), q_vec (B,n),
    c_blocks (B,nb,5,3), lb/ub (B,m), mask (B,n) in {0,1}, warm start x (B,n),
    z/y (B,m), rho_mult (B,), with n = h*ad = 3*nb and m = 5*nb.
    Returns (x, z, y, rho_mult, viol, res): unscaled solution (B,n)/(B,m),
    next solve's rho multiplier (B,), worst constraint violation (B,) and the
    scaled relative residuals (pri_rel, dua_rel) as (B,2).

    CUDA tensors go through the kernel on the current stream, without a
    synchronise; anything the kernel does not take raises. CPU tensors go
    through the plain version.
    """
    b, n, m, nb, h, sd = _check_inputs(s_chain, weights, q_vec, c_blocks, lb,
                                       ub, mask, x, z, y, rho_mult)
    kw = dict(alpha=alpha, iters=iters, sigma=sigma, relax=relax,
              rho_base=rho_base, rho_eq_scale=rho_eq_scale,
              ruiz_iters=ruiz_iters, deferred_rho=deferred_rho)
    if s_chain.device.type == "cpu":
        return fused_solve_chain_batch_reference(
            s_chain, weights, q_vec, c_blocks, lb, ub, mask, x, z, y,
            rho_mult, **kw)
    if s_chain.device.type != "cuda":
        raise ValueError(f"unsupported device {s_chain.device}")

    lib = _library()
    shared = lib.rlmpc_fused_chain_shared_bytes(n, m, nb, h, sd)
    if shared < 0 or shared > MAX_SHARED_BYTES:
        raise ValueError(
            f"QP sizes n={n} m={m} nb={nb} h={h} sd={sd} do not fit the "
            f"kernel (shared memory {shared} B, limit {MAX_SHARED_BYTES} B)")
    dev = s_chain.device
    x_o = torch.empty((b, n), dtype=torch.float32, device=dev)
    z_o = torch.empty((b, m), dtype=torch.float32, device=dev)
    y_o = torch.empty((b, m), dtype=torch.float32, device=dev)
    rm_o = torch.empty((b,), dtype=torch.float32, device=dev)
    viol_o = torch.empty((b,), dtype=torch.float32, device=dev)
    res_o = torch.empty((b, 2), dtype=torch.float32, device=dev)
    tensors = (s_chain, weights, q_vec, c_blocks, lb, ub, mask, x, z, y,
               rho_mult, x_o, z_o, y_o, rm_o, viol_o, res_o)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rlmpc_fused_solve_chain(
            *[t.data_ptr() for t in tensors], b, n, m, nb, h, sd, int(iters),
            int(ruiz_iters), int(bool(deferred_rho)), float(alpha),
            float(sigma), float(relax), float(rho_base), float(rho_eq_scale),
            stream)
    if err != 0:
        raise RuntimeError(
            "fused_solve_chain kernel launch failed: "
            f"{lib.rlmpc_error_string(err).decode()} (cudaError {err})")
    global _launches
    _launches += 1
    return x_o, z_o, y_o, rm_o, viol_o, res_o


def _hessian_from_chain_blocks(s_chain, weights, alpha):
    """P (B,n,n): lower block (a,b) = 2 sum_{k<=h-1-a} s[k]^T Q s[k+a-b],
    upper blocks by symmetry, alpha on the diagonal."""
    b, h, sd, ad = s_chain.shape
    sw = s_chain * weights[:, None, :, None]
    # m4[k, l] = s[k]^T Q s[l]
    m4 = torch.einsum('bkci,blcj->bklij', sw, s_chain)
    rows = []
    for a in range(h):
        row = []
        for bb in range(h):
            hi, lo = max(a, bb), min(a, bb)
            d = hi - lo
            blk = sum(m4[:, k, k + d] for k in range(h - hi))
            row.append(blk if a >= bb else blk.transpose(-1, -2))
        rows.append(torch.cat(row, dim=-1))
    p = 2.0 * torch.cat(rows, dim=-2)
    return p + alpha * torch.eye(h * ad, dtype=p.dtype, device=p.device)


def fused_solve_chain_batch_reference(s_chain, weights, q_vec, c_blocks, lb,
                                      ub, mask, x, z, y, rho_mult, *,
                                      alpha: float, iters: int, sigma: float,
                                      relax: float, rho_base: float,
                                      rho_eq_scale: float, ruiz_iters: int,
                                      deferred_rho: bool):
    """The kernel's eight phases, one after another, on (B, ...) tensors.
    Same arguments and returns as ``fused_solve_chain_batch``. The yardstick
    of correctness for the kernel, and the path of CPU tensors."""
    b, h, sd, ad = s_chain.shape
    n = h * ad
    nb = n // 3
    m = 5 * nb
    eye = torch.eye(n, dtype=s_chain.dtype, device=s_chain.device)

    # 0. Hessian from the chain
    k_mat = _hessian_from_chain_blocks(s_chain, weights, alpha)

    # 1. swing masking
    k_mat = k_mat * mask[:, :, None] * mask[:, None, :]
    k_mat = k_mat + eye * (1.0 - mask)[:, None, :]
    q_s = q_vec * mask

    # 2. Ruiz equilibration with cost scaling (rsqrt, as the kernel)
    cs = c_blocks
    d = torch.ones_like(q_vec)
    e = torch.ones_like(lb)
    c_cost = torch.ones((b, 1), dtype=q_vec.dtype, device=q_vec.device)
    for _ in range(ruiz_iters):
        col_p = k_mat.abs().amax(dim=1)
        col_c = cs.abs().amax(dim=2).reshape(b, n)
        col = torch.maximum(col_p, col_c)
        row_c = cs.abs().amax(dim=3).reshape(b, m)
        dd = torch.rsqrt(col.clamp_min(1e-8))
        de = torch.rsqrt(row_c.clamp_min(1e-8))
        k_mat = k_mat * dd[:, :, None] * dd[:, None, :]
        q_s = q_s * dd
        cs = cs * de.reshape(b, nb, 5, 1) * dd.reshape(b, nb, 1, 3)
        d = d * dd
        e = e * de
        colp = k_mat.abs().amax(dim=1).mean(dim=1, keepdim=True)
        qinf = q_s.abs().amax(dim=1, keepdim=True)
        gamma = 1.0 / torch.maximum(colp, qinf).clamp_min(1e-8)
        k_mat = k_mat * gamma[:, :, None]
        q_s = q_s * gamma
        c_cost = c_cost * gamma
    l_s = e * lb
    u_s = e * ub

    # 3. per-row rho with equality boost, K = P + sigma I + C^T rho C
    rm = rho_mult.reshape(b, 1)
    base = rho_base * rm
    rho = torch.where((ub - lb) < 1e-9, base * rho_eq_scale, base.expand(b, m))
    blk = torch.einsum('bkri,bkr,bkrj->bkij', cs, rho.reshape(b, nb, 5), cs)
    blk = blk + sigma * torch.eye(3, dtype=cs.dtype, device=cs.device)
    eye_nb = torch.eye(nb, dtype=cs.dtype, device=cs.device)
    k_mat = k_mat + torch.einsum('kc,bkij->bkicj', eye_nb, blk
                                 ).reshape(b, n, n)

    # 4. warm start into the scaled problem
    xs = x / d
    zs = z * e
    ys = y * (c_cost / e)

    # 5./6. invert, iterate
    k_inv = spd_inverse(k_mat)

    def kinv_apply(rhs):
        return torch.einsum('bij,bj->bi', k_inv, rhs)

    xs, zs, ys = _admm_math(iters, sigma, relax, kinv_apply, cs, q_s, l_s,
                            u_s, rho, xs, zs, ys)

    # 7. relative residuals at x~ (P x~ from the ADMM identity), deferred rho
    rhs_f = sigma * xs - q_s + ct_apply(cs, rho * zs - ys)
    x_t = kinv_apply(rhs_f)
    cx = c_apply(cs, x_t)
    px = rhs_f - sigma * x_t - ct_apply(cs, rho * cx)

    def absmax(v):
        return v.abs().amax(dim=1, keepdim=True)

    pri_rel = absmax(cx - zs) / torch.maximum(absmax(cx), absmax(zs)
                                              ).clamp_min(1e-8)
    cty = ct_apply(cs, ys)
    dua_rel = absmax(px + q_s + cty) / torch.maximum(
        absmax(px), torch.maximum(absmax(cty), absmax(q_s))).clamp_min(1e-8)
    if deferred_rho:
        scale = torch.sqrt(pri_rel / dua_rel.clamp_min(1e-10)).clamp(1e-2, 1e2)
        new_rm = (rm * scale).clamp(1e-3, 1e3)
    else:
        new_rm = rm

    # 8. unscale, primal violation
    x_u = xs * d
    z_u = c_apply(c_blocks, x_u)
    y_u = ys * (e / c_cost)
    viol = torch.maximum(lb - z_u, z_u - ub).amax(dim=1).clamp_min(0.0)
    return (x_u, z_u, y_u, new_rm.reshape(b), viol,
            torch.cat([pri_rel, dua_rel], dim=1))
