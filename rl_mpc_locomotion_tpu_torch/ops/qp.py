"""Batched OSQP-style ADMM solver for the ground-reaction-force QP.

Counterpart of ``rl_mpc_locomotion_tpu/ops/qp.py``. Same functions and
argument order, written with a leading batch axis ``B`` on every array
instead of one robot under ``vmap``.

Problem:  min  1/2 x^T P x + q^T x   s.t.  l <= C x <= u
with x the stacked GRFs (h*12) and C block-diagonal (h*4 blocks of 5x3).

Differences from the JAX module, all of form:
- ``QPConfig.use_pallas`` is named ``use_kernel`` here: it routes the solve
  through the hand-written CUDA kernels (``ops/cuda/``).
- The ``custom_vmap`` factories are one branch each. A fused-eligible config
  goes to ``fused_qp.fused_solve_chain_batch`` (``solve_qp_chain``) or
  ``fused_qp.fused_solve_batch`` (``solve_qp``): the whole solve in one
  kernel. Any other ``use_kernel`` config (polish or immediate adaptive rho)
  runs ``_solve_qp_impl`` with the factor-and-iterate step of each solve in
  ``admm_kernel.solve_scaled_batch`` (``_make_scaled_solver``); Ruiz, the
  residuals, the rho rescale, the polish and the unscaling stay plain
  PyTorch, as they stay XLA in the JAX package. Every wrapper launches its
  kernel for CUDA tensors or raises, and takes its plain version for CPU
  tensors.
- ``_solve_qp_impl``'s diagnostics also name the discrete branches each
  robot took: ``rho_clip`` (B,) int8, which end of the rho rescale's clip it
  hit (-1, +1, 0 for none), where a rescale ran; ``polish_active`` (B,m) and
  ``polish_kept`` (B,) with polish. The fused kernels report none of them.

Float32 settings: matrix products here must run in full float32 (the KKT
solve does not survive TF32's 10-bit mantissa), so TF32 matmuls must be off,
which is PyTorch's default; the check below states it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

if torch.backends.cuda.matmul.allow_tf32 is not False:
    raise RuntimeError(
        "rl_mpc_locomotion_tpu_torch needs full-float32 matmuls: set "
        "torch.backends.cuda.matmul.allow_tf32 = False before importing it")


class QPConfig(NamedTuple):
    sigma: float = 1e-6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    relax: float = 1.6          # over-relaxation alpha
    iters: int = 50             # iterations before the (optional) rho update
    iters2: int = 50            # iterations after the rho update
    adaptive_rho: bool = True
    deferred_rho: bool = False  # adapt rho across solves via QPState.rho_mult
    ruiz_iters: int = 10
    polish: bool = True
    polish_delta: float = 1e-6
    active_tol: float = 1e-4
    use_kernel: bool = False    # whole solve in the fused CUDA kernel


def production_qp_config() -> "QPConfig":
    """The real-time configuration: 24-iteration ADMM with receding-horizon
    shifted warm starts and *deferred* rho adaptation, through the fused
    kernel. Deferring the rho rescale to the next solve (QPState.rho_mult)
    keeps one factorisation a solve while rho still converges per robot over
    a few MPC periods. Polish stays off (an offline-accuracy knob)."""
    return QPConfig(iters=24, iters2=0, adaptive_rho=False,
                    deferred_rho=True, polish=False, ruiz_iters=2,
                    use_kernel=True)


class QPState(NamedTuple):
    """Warm-start state carried across MPC solves (unscaled). rho_mult is
    the deferred adaptive-rho memory: the rescale computed from this solve's
    residuals is applied to the next solve."""
    x: torch.Tensor         # (B,n)
    z: torch.Tensor         # (B,m)
    y: torch.Tensor         # (B,m)
    rho_mult: torch.Tensor  # (B,)


def init_qp_state(n: int, m: int, batch: int = 1, device="cpu") -> QPState:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return QPState(x=zeros(batch, n), z=zeros(batch, m), y=zeros(batch, m),
                   rho_mult=torch.ones(batch, dtype=torch.float32,
                                       device=device))


def shift_warm_start(state: QPState, horizon: int = 10) -> QPState:
    """Advance the warm start by one MPC step-block (receding-horizon
    shift): consecutive solves see horizons offset by one gait segment, so
    the previous solution shifted by one block (12 variables / 20 rows) is
    the better initial iterate. The last block is duplicated."""
    nb = state.x.shape[-1] // horizon
    mb = state.z.shape[-1] // horizon
    x = torch.cat([state.x[:, nb:], state.x[:, -nb:]], dim=-1)
    z = torch.cat([state.z[:, mb:], state.z[:, -mb:]], dim=-1)
    y = torch.cat([state.y[:, mb:], state.y[:, -mb:]], dim=-1)
    return state._replace(x=x, z=z, y=y)


def _apply_c(c_blocks, x):
    """C @ x with block-diagonal C. (B,nb,5,3), (B,nb*3) -> (B,nb*5)."""
    b, nb = c_blocks.shape[:2]
    return torch.einsum('bkij,bkj->bki', c_blocks, x.reshape(b, nb, 3)
                        ).reshape(b, nb * 5)


def _apply_ct(c_blocks, y):
    """C^T @ y. (B,nb*5) -> (B,nb*3)."""
    b, nb = c_blocks.shape[:2]
    return torch.einsum('bkij,bki->bkj', c_blocks, y.reshape(b, nb, 5)
                        ).reshape(b, nb * 3)


def _ct_diag_c(c_blocks, d):
    """C^T diag(d) C as (B,nb,3,3) diagonal blocks. d (B,nb*5)."""
    b, nb = c_blocks.shape[:2]
    return torch.einsum('bkij,bki,bkil->bkjl', c_blocks, d.reshape(b, nb, 5),
                        c_blocks)


def _add_block_diag(mat, blocks):
    """Add (B,nb,3,3) blocks onto the diagonal of (B,nb*3,nb*3) mat."""
    b, nb = blocks.shape[:2]
    n = nb * 3
    eye = torch.eye(nb, dtype=mat.dtype, device=mat.device)
    return mat + torch.einsum('kc,bkij->bkicj', eye, blocks).reshape(b, n, n)


def ruiz_equilibrate(p_mat, q_vec, c_blocks, iters: int):
    """Modified Ruiz equilibration of [[P C^T],[C 0]] plus cost scaling.

    Returns (p_s, q_s, c_s, d, e, c_cost): scaled data, variable scaling d
    (B,n), constraint scaling e (B,m), and cost scaling c_cost (B,). The
    scaled problem's solution unscales as x = d * x_s, y = e * y_s / c_cost.
    """
    b, nb = c_blocks.shape[:2]
    n = p_mat.shape[-1]
    d = torch.ones((b, n), dtype=p_mat.dtype, device=p_mat.device)
    e = torch.ones((b, nb * 5), dtype=p_mat.dtype, device=p_mat.device)
    c_cost = torch.ones((b,), dtype=p_mat.dtype, device=p_mat.device)
    p_s, q_s, c_s = p_mat, q_vec, c_blocks
    for _ in range(iters):
        col_p = p_s.abs().amax(dim=1)
        col_c = c_s.abs().amax(dim=2).reshape(b, n)
        col = torch.maximum(col_p, col_c)
        row_c = c_s.abs().amax(dim=3).reshape(b, nb * 5)
        delta_d = 1.0 / torch.sqrt(col.clamp_min(1e-8))
        delta_e = 1.0 / torch.sqrt(row_c.clamp_min(1e-8))
        p_s = delta_d[:, :, None] * p_s * delta_d[:, None, :]
        q_s = delta_d * q_s
        c_s = (delta_e.reshape(b, nb, 5, 1) * c_s
               * delta_d.reshape(b, nb, 1, 3))
        d = d * delta_d
        e = e * delta_e
        colp = p_s.abs().amax(dim=1).mean(dim=1)
        qinf = q_s.abs().amax(dim=1)
        gamma = 1.0 / torch.maximum(colp, qinf).clamp_min(1e-8)
        p_s = gamma[:, None, None] * p_s
        q_s = gamma[:, None] * q_s
        c_cost = c_cost * gamma
    return p_s, q_s, c_s, d, e, c_cost


def _spd_inverse(k_mat):
    """Inverse of a batch of SPD matrices via Cholesky."""
    lo = torch.linalg.cholesky_ex(k_mat).L
    eye = torch.eye(k_mat.shape[-1], dtype=k_mat.dtype, device=k_mat.device)
    li = torch.linalg.solve_triangular(lo, eye.expand_as(k_mat), upper=False)
    return li.transpose(-1, -2) @ li


def _admm_iters(k_inv, p_s, q_s, c_s, l_s, u_s, rho, sigma, relax, n_iters,
                x, z, y):
    """Run n_iters fixed ADMM iterations (OSQP alg. 1) on scaled data."""
    rho_inv = 1.0 / rho
    for _ in range(n_iters):
        rhs = sigma * x - q_s + _apply_ct(c_s, rho * z - y)
        x_t = torch.einsum('bij,bj->bi', k_inv, rhs)
        z_t = _apply_c(c_s, x_t)
        x = relax * x_t + (1.0 - relax) * x
        z_r = relax * z_t + (1.0 - relax) * z
        z_new = torch.minimum(torch.maximum(z_r + rho_inv * y, l_s), u_s)
        y = y + rho * (z_r - z_new)
        z = z_new
    return x, z, y


def _mask_p_q(p_mat, q_vec, mask):
    eye = torch.eye(p_mat.shape[-1], dtype=p_mat.dtype, device=p_mat.device)
    p_mat = (p_mat * mask[:, :, None] * mask[:, None, :]
             + eye * (1.0 - mask)[:, None, :])
    return p_mat, q_vec * mask


def solve_qp(p_mat, q_vec, c_blocks, lb, ub, state: QPState, cfg: QPConfig,
             mask=None):
    """Solve a batch of QPs from prebuilt Hessians (B,n,n).

    ``mask``: optional (B,n) {0,1} swing-variable mask. When given, p/q are
    raw and the masking is applied here; when None they must be pre-masked.
    Returns (x, new_state, diagnostics dict).
    """
    if _fused_eligible(cfg):
        from .cuda import fused_qp
        m = torch.ones_like(q_vec) if mask is None else mask
        out = fused_qp.fused_solve_batch(
            p_mat.contiguous(), q_vec.contiguous(), c_blocks.contiguous(),
            lb.contiguous(), ub.contiguous(), m.contiguous(),
            state.x.contiguous(), state.z.contiguous(), state.y.contiguous(),
            state.rho_mult.contiguous(), **_fused_kwargs(cfg))
        return _fused_result(*out)
    if mask is not None:
        p_mat, q_vec = _mask_p_q(p_mat, q_vec, mask)
    return _solve_qp_impl(p_mat, q_vec, c_blocks, lb, ub, state, cfg)


def solve_qp_chain(s_chain, q_vec, weights, alpha, c_blocks, lb, ub,
                   state: QPState, cfg: QPConfig, mask=None, horizon=10):
    """Solve the MPC QP from the condensation chain (production path).

    ``s_chain`` (B,h,13,12) = A^k B and ``weights`` (13,) or (B,13) replace
    the dense Hessian: with a fused-eligible config P is built inside the
    kernel and never exists in device memory; otherwise
    P = hessian_from_chain and the solve proceeds as solve_qp.
    """
    b = s_chain.shape[0]
    if _fused_eligible(cfg):
        from .cuda import fused_qp
        m = torch.ones_like(q_vec) if mask is None else mask
        w = weights.expand(b, weights.shape[-1]).contiguous()
        out = fused_qp.fused_solve_chain_batch(
            s_chain.contiguous(), w, q_vec.contiguous(),
            c_blocks.contiguous(), lb.contiguous(), ub.contiguous(),
            m.contiguous(), state.x.contiguous(), state.z.contiguous(),
            state.y.contiguous(), state.rho_mult.contiguous(),
            alpha=float(alpha), **_fused_kwargs(cfg))
        return _fused_result(*out)
    from .srb_dynamics import hessian_from_chain
    p_mat = hessian_from_chain(s_chain, weights, alpha, horizon)
    if mask is not None:
        p_mat, q_vec = _mask_p_q(p_mat, q_vec, mask)
    return _solve_qp_impl(p_mat, q_vec, c_blocks, lb, ub, state, cfg)


def _fused_eligible(cfg: QPConfig) -> bool:
    """The fused kernels cover the production solve shape: fixed iterations
    with optional deferred rho. Polish / immediate adaptive-rho (the
    offline-accuracy knobs) run the pipeline below, with only the
    factor-and-iterate step in a kernel."""
    return cfg.use_kernel and not cfg.adaptive_rho and not cfg.polish


def _fused_kwargs(cfg: QPConfig) -> dict:
    return dict(iters=cfg.iters, sigma=cfg.sigma, relax=cfg.relax,
                rho_base=cfg.rho, rho_eq_scale=cfg.rho_eq_scale,
                ruiz_iters=cfg.ruiz_iters, deferred_rho=cfg.deferred_rho)


def _fused_result(x_u, z_u, y_u, rm, viol, res):
    return (x_u, QPState(x=x_u, z=z_u, y=y_u, rho_mult=rm),
            {"primal_violation": viol, "pri_res": res[:, 0],
             "dua_res": res[:, 1]})


def _scaled_solve(k_mat, q_s, c_s, l_s, u_s, rho, x, z, y, iters: int,
                  cfg: QPConfig):
    """Factor and iterate on the scaled problem: ``iters`` ADMM steps with
    K^-1. Counterpart of ``_make_scaled_solver``: through the CUDA kernel
    with ``use_kernel``, else Cholesky here."""
    if cfg.use_kernel:
        from .cuda import admm_kernel
        return admm_kernel.solve_scaled_batch(
            k_mat, q_s.contiguous(), c_s.contiguous(), l_s.contiguous(),
            u_s.contiguous(), rho.contiguous(), x.contiguous(),
            z.contiguous(), y.contiguous(), iters=iters, sigma=cfg.sigma,
            relax=cfg.relax)
    return _admm_iters(_spd_inverse(k_mat), None, q_s, c_s, l_s, u_s, rho,
                       cfg.sigma, cfg.relax, iters, x, z, y)


def _rho_rescale(pri_rel, dua_rel):
    """OSQP's rho rescale sqrt(pri / dua), clipped to [1e-2, 1e2]. Also
    returns which end of the clip each robot hit: -1 low, +1 high, 0 none."""
    raw = torch.sqrt(pri_rel / dua_rel.clamp_min(1e-10))
    clip = (raw >= 1e2).to(torch.int8) - (raw <= 1e-2).to(torch.int8)
    return raw.clamp(1e-2, 1e2), clip


def _solve_qp_impl(p_mat, q_vec, c_blocks, lb, ub, state: QPState,
                   cfg: QPConfig):
    n = p_mat.shape[-1]
    eq_row = (ub - lb) < 1e-9

    p_s, q_s, c_s, d, e, c_cost = ruiz_equilibrate(
        p_mat, q_vec, c_blocks, cfg.ruiz_iters)
    l_s, u_s = e * lb, e * ub
    cc = c_cost[:, None]

    rho_mult = state.rho_mult[:, None]
    base_rho = cfg.rho * rho_mult if cfg.deferred_rho else \
        torch.full_like(rho_mult, cfg.rho)
    rho = torch.where(eq_row, base_rho * cfg.rho_eq_scale,
                      base_rho.expand_as(lb))

    # warm start: scale previous solution into the new scaling
    x = state.x / d
    z = e * state.z
    y = cc * (state.y / e)

    eye = torch.eye(n, dtype=p_s.dtype, device=p_s.device)

    def build_k(rho):
        return _add_block_diag(p_s + cfg.sigma * eye, _ct_diag_c(c_s, rho))

    x, z, y = _scaled_solve(build_k(rho), q_s, c_s, l_s, u_s, rho, x, z, y,
                            cfg.iters, cfg)

    def absmax(v):
        return v.abs().amax(dim=1)

    def residuals(x, z, y):
        # OSQP relative primal/dual residuals on the scaled problem
        cx = _apply_c(c_s, x)
        pri_rel = absmax(cx - z) / torch.maximum(absmax(cx), absmax(z)
                                                 ).clamp_min(1e-8)
        px = torch.einsum('bij,bj->bi', p_s, x)
        cty = _apply_ct(c_s, y)
        dua_rel = absmax(px + q_s + cty) / torch.maximum(
            absmax(px), torch.maximum(absmax(cty), absmax(q_s))
        ).clamp_min(1e-8)
        return pri_rel, dua_rel

    # the discrete branches each robot took, reported beside the residuals
    branches = {}
    new_rho_mult = state.rho_mult
    pri_rel, dua_rel = residuals(x, z, y)
    if cfg.adaptive_rho:
        # immediate restart: re-factor with the rescaled rho this solve
        scale, branches["rho_clip"] = _rho_rescale(pri_rel, dua_rel)
        rho2 = (rho * scale[:, None]).clamp(1e-6, 1e6)
        x, z, y = _scaled_solve(build_k(rho2), q_s, c_s, l_s, u_s, rho2, x,
                                z, y, cfg.iters2, cfg)
        pri_rel, dua_rel = residuals(x, z, y)
    elif cfg.deferred_rho:
        # deferred: remember the rescale for the NEXT solve
        scale, branches["rho_clip"] = _rho_rescale(pri_rel, dua_rel)
        new_rho_mult = (state.rho_mult * scale).clamp(1e-3, 1e3)

    if cfg.polish:
        x, branches["polish_active"], branches["polish_kept"] = _polish(
            p_s, q_s, c_s, l_s, u_s, x, y, z, cfg)

    # unscale
    x_u = d * x
    z_u = _apply_c(c_blocks, x_u)
    y_u = (e / cc) * y

    viol = torch.maximum(lb - z_u, z_u - ub).amax(dim=1).clamp_min(0.0)
    diag = {"primal_violation": viol, "pri_res": pri_rel, "dua_res": dua_rel,
            **branches}
    return x_u, QPState(x=x_u, z=z_u, y=y_u, rho_mult=new_rho_mult), diag


def _polish(p_s, q_s, c_s, l_s, u_s, x, y, z, cfg: QPConfig):
    """Penalty-method polish: re-solve on the detected active set with a
    stiff quadratic penalty (weight 1/delta) on active rows. The polished x
    is kept only where it does not increase the worst violation. Returns
    (x, active set (B,m), kept (B,))."""
    low_active = y < -cfg.active_tol
    upp_active = y > cfg.active_tol
    eq_active = (u_s - l_s) < 1e-9  # equality rows are always active
    active = low_active | upp_active | eq_active
    target = torch.where(upp_active, u_s, l_s)

    w = active.to(p_s.dtype) / cfg.polish_delta
    n = p_s.shape[-1]
    k = p_s + cfg.sigma * torch.eye(n, dtype=p_s.dtype, device=p_s.device)
    k = _add_block_diag(k, _ct_diag_c(c_s, w))
    rhs = -q_s + _apply_ct(c_s, w * target) + cfg.sigma * x
    x_pol = torch.einsum('bij,bj->bi', _spd_inverse(k), rhs)

    def worst_violation(xx):
        cx = _apply_c(c_s, xx)
        return torch.maximum(l_s - cx, cx - u_s).amax(dim=1)

    keep = worst_violation(x_pol) <= worst_violation(x) + 1e-6
    return torch.where(keep[:, None], x_pol, x), active, keep


def mask_swing_variables(p_mat, q_vec, contact_step0, horizon=10):
    """Pin swing-leg GRFs to zero via P/q masking. contact_step0 (B,h,4);
    a variable is active iff its (step, leg) is in contact."""
    b = contact_step0.shape[0]
    mask = torch.repeat_interleave(contact_step0.reshape(b, -1), 3, dim=1)
    pm, qm = _mask_p_q(p_mat, q_vec, mask)
    return pm, qm, mask
