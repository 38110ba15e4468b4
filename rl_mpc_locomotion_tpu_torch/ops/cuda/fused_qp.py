"""The whole GRF-QP solve as one CUDA kernel, from the condensation chain or
from a prebuilt Hessian.

Counterpart of ``fused_solve_chain_batch`` (``_fused_kernel_chain``) and
``fused_solve_batch`` (``_fused_kernel``) in
``rl_mpc_locomotion_tpu/ops/pallas/fused_qp.py``, which share
``_solve_phases``. For each robot the kernel takes the Hessian ``P`` (built
from the chain ``s[k] = A^k B`` as ``2 B_qp^T Q B_qp + alpha I``, or read
from device memory), masks the swing variables, Ruiz-equilibrates, assembles
``K = P + sigma I + C^T rho C``, inverts it, runs the fixed count of ADMM
steps with ``K^-1`` resident, takes the relative residuals at ``x~`` and the
deferred rho rescale, and unscales.

The kernels are ``csrc/fused_qp.cu`` (phases in ``csrc/qp_phases.cuh``), one
thread block a robot with ``K`` in registers, written for ``sm_90a`` and
built by ``_build.py`` at first use. On an H100 they are bound by f32
arithmetic on operands that never leave the SM (about 3 MFLOP a robot, a
third of it the inverse); the prebuilt-P entry also reads 57.6 KB of ``P`` a
robot. The notes in ``qp_phases.cuh`` say what the design does about that.

Row 1 adapts to the mask. A foot-step whose three mask entries are all
exactly 0 (swing) gives unit rows and columns of the masked ``P``, and
``sigma I + C^T rho C`` is block-diagonal in the same 3 x 3 blocks, so with
the live foot-steps ordered first ``K`` is exactly block-diagonal: a dense
block of the ``n_s`` stance variables and one 3 x 3 block a swing
foot-step. Where ``n_s <= 64`` (a trot has ``n_s = 60``) the kernel gathers
the problem in that order and inverts the stance block alone, over at most 8
panels and a quarter of the tile, and each swing block by itself; ADMM
applies ``K^-1`` the same way, and the outputs go back in the input's order.
Otherwise (standing, ``n_s = 120``; three legs down, ``n_s = 90``) it takes
the dense path, the one row 2 always takes. The choice is per robot; no flag
selects it. The compact path is bound more by the inverse's barriers and
dependent chains than by its arithmetic.

Each wrapper launches its kernel for CUDA tensors, or raises; for CPU
tensors it takes its plain version (``*_reference``), the same phases in
plain PyTorch, which is also what the kernel is compared with. The two plain
versions share one body, ``_solve_phases_reference``, which is dense for
every mask. ``launch_count()`` counts kernel launches and nothing else;
``compact_count()`` reads the card's count of row-1 robot-solves that took
the compact path.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .admm_kernel import _admm_math, c_apply, ct_apply, spd_inverse

_launches = {"fused_solve_chain": 0, "fused_solve": 0}
_bound = None


def launch_count(entry: str | None = None) -> int:
    """Kernel launches since the last ``reset_launch_count()``: of one entry
    (``"fused_solve_chain"``, ``"fused_solve"``) or of both."""
    return sum(_launches.values()) if entry is None else _launches[entry]


def reset_launch_count() -> None:
    for k in _launches:
        _launches[k] = 0


def compact_count(device=None) -> int:
    """Robot-solves of row 1 that took the compact path (``n_s <= 64``) on
    ``device`` (the current card by default) since the last
    ``reset_compact_count()``: a 64-bit counter on the card, one atomic add a
    robot. The read waits for the card's queued work, so never call it
    inside a timed window."""
    lib = _library()
    out = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        _check_counter(lib.rlmpc_compact_solves(ctypes.byref(out)))
    return out.value


def reset_compact_count(device=None) -> None:
    """Set the card's count of compact row-1 solves to 0 (waits for the
    card's queued work)."""
    lib = _library()
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        _check_counter(lib.rlmpc_reset_compact_solves())


def _check_counter(err: int) -> None:
    if err != 0:
        msg = _library().rlmpc_error_string(err).decode()
        raise RuntimeError(f"the compact count could not be read or reset: "
                           f"{msg} (cudaError {err})")


def _library():
    """The compiled library with this module's argument types set."""
    global _bound
    if _bound is None:
        lib = _build.load_library()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmpc_fused_solve_chain.argtypes = (
            [ptr] * 17 + [i32] * 9 + [f32] * 5 + [ptr])
        lib.rlmpc_fused_solve_chain.restype = i32
        lib.rlmpc_fused_solve.argtypes = (
            [ptr] * 16 + [i32] * 7 + [f32] * 4 + [ptr])
        lib.rlmpc_fused_solve.restype = i32
        lib.rlmpc_fused_chain_shared_bytes.argtypes = [i32] * 5
        lib.rlmpc_fused_chain_shared_bytes.restype = i32
        lib.rlmpc_compact_solves.argtypes = [ptr]
        lib.rlmpc_compact_solves.restype = i32
        lib.rlmpc_reset_compact_solves.argtypes = []
        lib.rlmpc_reset_compact_solves.restype = i32
        _bound = lib
    return _bound


def _solve_shapes(b, n, m, nb):
    """Shapes of the inputs both entries share."""
    return {"q_vec": (b, n), "c_blocks": (b, nb, 5, 3), "lb": (b, m),
            "ub": (b, m), "mask": (b, n), "x": (b, n), "z": (b, m),
            "y": (b, m), "rho_mult": (b,)}


def _qp_sizes(b, n):
    """(nb, m) of a batch of b cone-block QPs with n variables."""
    if b < 1 or n < 3 or n % 3 != 0:
        raise ValueError(f"need B >= 1 and n divisible by 3, got B={b} n={n}")
    return n // 3, 5 * (n // 3)


def _outputs(b, n, m, dev):
    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return (empty(b, n), empty(b, m), empty(b, m), empty(b), empty(b),
            empty(b, 2))


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
    if s_chain.dim() != 4:
        raise ValueError(f"s_chain must be (B,h,sd,ad), got {tuple(s_chain.shape)}")
    b, h, sd, ad = s_chain.shape
    n = h * ad
    nb, m = _qp_sizes(b, n)
    _build.check_tensors(
        {"s_chain": (b, h, sd, ad), "weights": (b, sd), **_solve_shapes(b, n, m, nb)},
        {"s_chain": s_chain, "weights": weights, "q_vec": q_vec,
         "c_blocks": c_blocks, "lb": lb, "ub": ub, "mask": mask, "x": x,
         "z": z, "y": y, "rho_mult": rho_mult})
    kw = dict(iters=iters, sigma=sigma, relax=relax, rho_base=rho_base,
              rho_eq_scale=rho_eq_scale, ruiz_iters=ruiz_iters,
              deferred_rho=deferred_rho)
    if _build.kernel_device(s_chain) == "cpu":
        return fused_solve_chain_batch_reference(
            s_chain, weights, q_vec, c_blocks, lb, ub, mask, x, z, y,
            rho_mult, alpha=alpha, **kw)

    lib = _library()
    _build.check_shared(lib.rlmpc_fused_chain_shared_bytes(n, m, nb, h, sd),
                  f"n={n} m={m} nb={nb} h={h} sd={sd}")
    outs = _outputs(b, n, m, s_chain.device)
    tensors = (s_chain, weights, q_vec, c_blocks, lb, ub, mask, x, z, y,
               rho_mult) + outs
    with torch.cuda.device(s_chain.device):
        err = lib.rlmpc_fused_solve_chain(
            *[t.data_ptr() for t in tensors], b, n, m, nb, h, sd, int(iters),
            int(ruiz_iters), int(bool(deferred_rho)), float(alpha),
            float(sigma), float(relax), float(rho_base), float(rho_eq_scale),
            _build.stream_of(s_chain))
    _build.check_launch(err, "fused_solve_chain")
    _launches["fused_solve_chain"] += 1
    return outs


def fused_solve_batch(p_mat, q_vec, c_blocks, lb, ub, mask, x, z, y,
                      rho_mult, *, iters: int, sigma: float, relax: float,
                      rho_base: float, rho_eq_scale: float, ruiz_iters: int,
                      deferred_rho: bool):
    """Batched full QP solve from prebuilt raw (unmasked, unscaled) Hessians.

    p_mat (B,n,n) float32; the other arguments and the returns as
    ``fused_solve_chain_batch``. CUDA tensors go through the kernel (which
    reads each robot's P into registers once), or raise; CPU tensors go
    through the plain version.
    """
    if p_mat.dim() != 3:
        raise ValueError(f"p_mat must be (B,n,n), got {tuple(p_mat.shape)}")
    b, n = p_mat.shape[0], p_mat.shape[-1]
    nb, m = _qp_sizes(b, n)
    _build.check_tensors(
        {"p_mat": (b, n, n), **_solve_shapes(b, n, m, nb)},
        {"p_mat": p_mat, "q_vec": q_vec, "c_blocks": c_blocks, "lb": lb,
         "ub": ub, "mask": mask, "x": x, "z": z, "y": y,
         "rho_mult": rho_mult})
    kw = dict(iters=iters, sigma=sigma, relax=relax, rho_base=rho_base,
              rho_eq_scale=rho_eq_scale, ruiz_iters=ruiz_iters,
              deferred_rho=deferred_rho)
    if _build.kernel_device(p_mat) == "cpu":
        return fused_solve_batch_reference(p_mat, q_vec, c_blocks, lb, ub,
                                           mask, x, z, y, rho_mult, **kw)

    lib = _library()
    _build.check_shared(lib.rlmpc_qp_shared_bytes(n, m, nb), f"n={n} m={m} nb={nb}")
    outs = _outputs(b, n, m, p_mat.device)
    tensors = (p_mat, q_vec, c_blocks, lb, ub, mask, x, z, y, rho_mult) + outs
    with torch.cuda.device(p_mat.device):
        err = lib.rlmpc_fused_solve(
            *[t.data_ptr() for t in tensors], b, n, m, nb, int(iters),
            int(ruiz_iters), int(bool(deferred_rho)), float(sigma),
            float(relax), float(rho_base), float(rho_eq_scale),
            _build.stream_of(p_mat))
    _build.check_launch(err, "fused_solve")
    _launches["fused_solve"] += 1
    return outs


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
                                      alpha: float, **kw):
    """The chain kernel's phases, one after another, on (B, ...) tensors:
    the Hessian from the chain, then ``_solve_phases_reference``. Same
    arguments and returns as ``fused_solve_chain_batch``. The yardstick of
    correctness for the kernel, and the path of CPU tensors."""
    p_mat = _hessian_from_chain_blocks(s_chain, weights, alpha)
    return _solve_phases_reference(p_mat, q_vec, c_blocks, lb, ub, mask, x,
                                   z, y, rho_mult, **kw)


def fused_solve_batch_reference(p_mat, q_vec, c_blocks, lb, ub, mask, x, z,
                                y, rho_mult, **kw):
    """The prebuilt-P kernel's phases on (B, ...) tensors; same arguments and
    returns as ``fused_solve_batch``. The yardstick of correctness for the
    kernel, and the path of CPU tensors."""
    return _solve_phases_reference(p_mat, q_vec, c_blocks, lb, ub, mask, x,
                                   z, y, rho_mult, **kw)


def _mask_reference(k_mat, q_vec, mask):
    """Swing masking: P o m m^T + diag(1 - m), q o m."""
    eye = torch.eye(k_mat.shape[-1], dtype=k_mat.dtype, device=k_mat.device)
    k_mat = k_mat * mask[:, :, None] * mask[:, None, :]
    return k_mat + eye * (1.0 - mask)[:, None, :], q_vec * mask


def _ruiz_reference(k_mat, q_s, c_blocks, iters: int):
    """Ruiz equilibration with cost scaling, rsqrt as the kernel. Returns
    (P_s, q_s, C_s, d, e, c_cost) with c_cost (B,1)."""
    b, nb = c_blocks.shape[:2]
    n, m = 3 * nb, 5 * nb
    cs = c_blocks
    d = torch.ones_like(q_s)
    e = torch.ones((b, m), dtype=q_s.dtype, device=q_s.device)
    c_cost = torch.ones((b, 1), dtype=q_s.dtype, device=q_s.device)
    for _ in range(iters):
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
    return k_mat, q_s, cs, d, e, c_cost


def _assemble_k_reference(k_mat, cs, rho, sigma: float):
    """K = P + sigma I + C^T diag(rho) C on the block diagonal."""
    b, nb = cs.shape[:2]
    blk = torch.einsum('bkri,bkr,bkrj->bkij', cs, rho.reshape(b, nb, 5), cs)
    blk = blk + sigma * torch.eye(3, dtype=cs.dtype, device=cs.device)
    eye_nb = torch.eye(nb, dtype=cs.dtype, device=cs.device)
    return k_mat + torch.einsum('kc,bkij->bkicj', eye_nb, blk
                                ).reshape(b, 3 * nb, 3 * nb)


def _solve_phases_reference(k_mat, q_vec, c_blocks, lb, ub, mask, x, z, y,
                            rho_mult, *, iters: int, sigma: float,
                            relax: float, rho_base: float,
                            rho_eq_scale: float, ruiz_iters: int,
                            deferred_rho: bool):
    """Phases 1-8 of the kernels (mask, Ruiz, K, inverse, ADMM, residuals and
    rho, unscale) on the raw Hessian ``k_mat`` (B,n,n)."""
    b = k_mat.shape[0]
    m = lb.shape[1]

    # 1./2. swing masking, Ruiz equilibration with cost scaling
    k_mat, q_s = _mask_reference(k_mat, q_vec, mask)
    k_mat, q_s, cs, d, e, c_cost = _ruiz_reference(k_mat, q_s, c_blocks,
                                                   ruiz_iters)
    l_s = e * lb
    u_s = e * ub

    # 3. per-row rho with equality boost, K = P + sigma I + C^T rho C
    rm = rho_mult.reshape(b, 1)
    base = rho_base * rm
    rho = torch.where((ub - lb) < 1e-9, base * rho_eq_scale, base.expand(b, m))
    k_mat = _assemble_k_reference(k_mat, cs, rho, sigma)

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
