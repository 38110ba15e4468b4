"""Single-rigid-body MPC dynamics: linearisation, exact discretisation and
the QP condensation (chain and dense forms), on batched tensors.

Counterpart of ``rl_mpc_locomotion_tpu/ops/srb_dynamics.py``. Every function
takes a leading batch axis ``B``. The MPC tick uses the chain form; the
dense form (``condense``, ``build_qp_cost`` ...) builds ``P`` in device
memory for the prebuilt-Hessian solve (``qp.solve_qp``) and the profiler.

- The continuous A is nilpotent (A^3 = 0), so the matrix exponential has the
  exact closed form  A_exp = I + A dt + A^2 dt^2/2,
  B_exp = (I dt + A dt^2/2 + A^2 dt^3/6) B.
- B_qp is never materialised: it is lower-block-triangular with block
  (i, j) = s[i-j], s[k] = A^k B, and every condensed quantity is a sum over
  that chain (``condense_chain``).

State layout (13): (roll, pitch, yaw, x, y, z, wx, wy, wz, vx, vy, vz, -g).
"""
from __future__ import annotations

import torch

from .rotations import skew

STATE_DIM = 13
ACTION_DIM = 12  # 4 legs x 3D GRF
GRAVITY = 9.8
F_MAX_SCALE = 10.0
F_MIN_SCALE = 0.1


def build_a_mat(rpy, ground_normal):
    """Continuous-time A (B,13,13) from rpy (B,3) and ground_normal (3,) or
    (B,3). Rows 0-2: angular velocity -> rpy rate; rows 3-5: velocity; rows
    9-11: gravity column scaled by the ground normal."""
    b = rpy.shape[0]
    cy, sy = torch.cos(rpy[:, 2]), torch.sin(rpy[:, 2])
    cp, tp = torch.cos(rpy[:, 1]), torch.tan(rpy[:, 1])
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)
    w2rpy = torch.stack([
        torch.stack([cy / cp, sy / cp, zero], dim=-1),
        torch.stack([-sy, cy, zero], dim=-1),
        torch.stack([cy * tp, sy * tp, one], dim=-1),
    ], dim=-2)
    a = torch.zeros((b, STATE_DIM, STATE_DIM), dtype=rpy.dtype,
                    device=rpy.device)
    a[:, 0:3, 6:9] = w2rpy
    a[:, 3, 9] = 1.0
    a[:, 4, 10] = 1.0
    a[:, 5, 11] = 1.0
    a[:, 9:12, 12] = ground_normal
    return a


def build_b_mat(inv_mass, inv_inertia_world, foot_positions_world):
    """Continuous-time B (B,13,12). inv_mass () or (B,), inv_inertia_world
    (B,3,3), foot_positions_world (B,4,3). Rows 6-8: I_w^-1 [r_i]x per leg;
    rows 9-11: 1/m on the diagonal."""
    b = foot_positions_world.shape[0]
    dt, dev = foot_positions_world.dtype, foot_positions_world.device
    skews = skew(foot_positions_world)                           # (B,4,3,3)
    torque = torch.einsum('bij,bljk->bilk', inv_inertia_world, skews)
    out = torch.zeros((b, STATE_DIM, ACTION_DIM), dtype=dt, device=dev)
    out[:, 6:9] = torque.reshape(b, 3, ACTION_DIM)
    force_rows = torch.eye(3, dtype=dt, device=dev).repeat(1, 4)
    out[:, 9:12] = force_rows * torch.as_tensor(
        inv_mass, dtype=dt, device=dev).reshape(-1, 1, 1)
    return out


def discretize_exact(a, b, dt):
    """Exact ZOH discretisation using nilpotency of A (A^3 == 0)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    a2 = a @ a
    a_exp = eye + dt * a + (0.5 * dt * dt) * a2
    int_exp = dt * eye + (0.5 * dt * dt) * a + (dt * dt * dt / 6.0) * a2
    return a_exp, int_exp @ b


def _powers_and_chain(a_exp, b_exp, horizon, compat_last_aqp_zero):
    """a_qp (B,h*sd,sd) stacking A^1..A^h, and s (B,h,sd,ad) with
    s[k] = A^k B; the last A_qp block zeroed under the compat flag."""
    powers = [a_exp]
    anb = [b_exp]
    for _ in range(horizon - 1):
        powers.append(a_exp @ powers[-1])
        anb.append(a_exp @ anb[-1])
    if compat_last_aqp_zero:
        powers[horizon - 1] = torch.zeros_like(powers[horizon - 1])
    return torch.cat(powers, dim=-2), torch.stack(anb, dim=1)


def _lower_blocks(s):
    """(B,h,h,sd,ad): block (i, j) = s[i-j] for j <= i, else 0."""
    h = s.shape[1]
    ar = torch.arange(h, device=s.device)
    i_idx, j_idx = ar[:, None], ar[None, :]
    blocks = s[:, (i_idx - j_idx).clamp(0, h - 1)]
    return torch.where((i_idx >= j_idx)[None, :, :, None, None], blocks,
                       torch.zeros_like(blocks))


def condense(a_exp, b_exp, horizon=10, compat_last_aqp_zero=True):
    """Unroll X_{k+1} = A X_k + B u_k into [X_1..X_h] = A_qp x0 + B_qp U:
    (a_qp (B,h*sd,sd), b_qp (B,h*sd,h*ad)) with B_qp's block (i, j) =
    A^(i-j) B below the diagonal. ``compat_last_aqp_zero`` as in
    ``condense_chain``."""
    a_qp, s = _powers_and_chain(a_exp, b_exp, horizon, compat_last_aqp_zero)
    b, h, sd, ad = s.shape
    b_qp = _lower_blocks(s).permute(0, 1, 3, 2, 4).reshape(b, h * sd, h * ad)
    return a_qp, b_qp


def condense_blocks(a_exp, b_exp, horizon=10, compat_last_aqp_zero=True):
    """The condensation kept in block form: (a_qp (B,h*sd,sd), blocks
    (B,h,h,sd,ad)), blocks[i,j] = A^(i-j) B for j <= i else 0."""
    a_qp, s = _powers_and_chain(a_exp, b_exp, horizon, compat_last_aqp_zero)
    return a_qp, _lower_blocks(s)


def build_qp_cost_blocks(a_qp, blocks, x0, x_des, weights, alpha,
                         horizon=10):
    """``build_qp_cost`` on the block form:
    P[(a,r),(b,s)] = 2 sum_{i,c} blocks[i,a,c,r] w[c] blocks[i,b,c,s]
    + alpha I, q = 2 B_qp^T Q (A_qp x0 - x_des). weights (sd,) or (B,sd)."""
    b, h, _, sd, ad = blocks.shape
    w = weights.reshape(-1, sd)
    wb = blocks * w[:, None, None, :, None]
    n = h * ad
    p_mat = (2.0 * torch.einsum('ziacr,zibcs->zarbs', wb, blocks
                                ).reshape(b, n, n)
             + alpha * torch.eye(n, dtype=blocks.dtype, device=blocks.device))
    state_diff = (torch.einsum('bij,bj->bi', a_qp, x0) - x_des
                  ).reshape(b, h, sd)
    wsd = state_diff * w[:, None, :]
    q_vec = 2.0 * torch.einsum('ziacr,zic->zar', blocks, wsd).reshape(b, n)
    return p_mat, q_vec


def build_qp_cost(a_qp, b_qp, x0, x_des, weights, alpha, horizon=10):
    """Condensed dense QP cost: P = 2 B^T Q B + alpha I (the Hessian doubled
    before alpha is added), q = 2 B^T Q (A x0 - x_des). a_qp (B,h*sd,sd),
    b_qp (B,h*sd,n), x0 (B,sd), x_des (B,h*sd), weights (sd,) or (B,sd)."""
    w = weights.reshape(-1, weights.shape[-1]).repeat(1, horizon)  # (.,h*sd)
    p_mat = 2.0 * (b_qp.transpose(1, 2) @ (w[:, :, None] * b_qp))
    p_mat = p_mat + alpha * torch.eye(b_qp.shape[-1], dtype=b_qp.dtype,
                                      device=b_qp.device)
    state_diff = torch.einsum('bij,bj->bi', a_qp, x0) - x_des
    q_vec = 2.0 * torch.einsum('bij,bi->bj', b_qp, w * state_diff)
    return p_mat, q_vec


def condense_cost(a_exp, b_exp, x0, x_des, weights, alpha, horizon=10,
                  compat_last_aqp_zero=True):
    """(P, q) directly from the A^k B chain; equals condense() +
    build_qp_cost() to f32 precision."""
    a_qp, s = condense_chain(a_exp, b_exp, horizon, compat_last_aqp_zero)
    p_mat = hessian_from_chain(s, weights, alpha, horizon)
    q_vec = gradient_from_chain(s, a_qp, x0, x_des, weights, horizon)
    return p_mat, q_vec


def condense_chain(a_exp, b_exp, horizon=10, compat_last_aqp_zero=True):
    """(a_qp (B,h*sd,sd), s (B,h,sd,ad)) with s[k] = A^k B.

      P[a,b] = 2 sum_{i>=max(a,b)} s[i-a]^T Q s[i-b]
      q[a]   = 2 sum_k s[k]^T (w * sd[k+a])

    ``compat_last_aqp_zero`` keeps the reference solver's zero final A_qp
    block (its fill loop stops one block early); it only affects q.
    """
    return _powers_and_chain(a_exp, b_exp, horizon, compat_last_aqp_zero)


def gradient_from_chain(s, a_qp, x0, x_des, weights, horizon=None):
    """q = 2 B_qp^T Q (A_qp x0 - x_des) from the chain, (B,h*ad).
    s (B,h,sd,ad), a_qp (B,h*sd,sd), x0 (B,sd), x_des (B,h*sd), weights
    (sd,) or (B,sd)."""
    b, h, sd, ad = s.shape
    state_diff = (torch.einsum('bij,bj->bi', a_qp, x0) - x_des
                  ).reshape(b, h, sd)
    wsd = state_diff * weights.reshape(-1, 1, sd)
    # q[a] = 2 sum_k s[k]^T wsd[a+k], a + k < h
    pad = torch.cat([wsd, torch.zeros_like(wsd)], dim=1)        # (B,2h,sd)
    idx = (torch.arange(h, device=s.device)[:, None]
           + torch.arange(h, device=s.device)[None, :])         # (a,k)
    wsd_sh = pad[:, idx]                                        # (B,a,k,sd)
    return 2.0 * torch.einsum('bkcr,bakc->bar', s, wsd_sh).reshape(b, h * ad)


def hessian_from_chain(s, weights, alpha, horizon=None):
    """P = 2 B_qp^T Q B_qp + alpha I from the chain, (B,n,n): the plain path
    of the in-kernel build."""
    b, h, sd, ad = s.shape
    w = weights.reshape(-1, 1, sd, 1)
    u = (s * w).transpose(2, 3).reshape(b, h * ad, sd)
    v = s.transpose(2, 3).reshape(b, h * ad, sd)
    m2 = u @ v.transpose(1, 2)
    m4 = m2.reshape(b, h, ad, h, ad).permute(0, 1, 3, 2, 4)     # (B,k,l,i,j)

    ar = torch.arange(h, device=s.device)
    k_i, d_i = ar[None, :], ar[:, None]
    tgt = torch.clamp(k_i + d_i, 0, h - 1)
    dg = m4[:, k_i.expand(h, h), tgt]                           # (B,d,k,ad,ad)
    dg = torch.where(((k_i + d_i) < h)[None, :, :, None, None], dg,
                     torch.zeros_like(dg))
    csum = torch.cumsum(dg, dim=2)

    a_i, b_i = ar[:, None], ar[None, :]
    delta = (a_i - b_i).abs()
    jj = h - 1 - torch.maximum(a_i, b_i)
    blocks = csum[:, delta, jj]                                 # (B,a,b,ad,ad)
    blocks = torch.where((a_i >= b_i)[None, :, :, None, None], blocks,
                         blocks.transpose(-1, -2))
    n = h * ad
    return (2.0 * blocks.permute(0, 1, 3, 2, 4).reshape(b, n, n)
            + alpha * torch.eye(n, dtype=s.dtype, device=s.device))


def build_state_vec(rpy, position, omega, velocity):
    """13-dim state (B,13)."""
    g = torch.full_like(rpy[:, :1], -GRAVITY)
    return torch.cat([rpy, position, omega, velocity, g], dim=-1)


def build_desired_states(com_rpy, com_position, desired_position,
                         desired_velocity, desired_rpy, desired_omega,
                         dt, horizon=10):
    """(B,h*13) desired trajectory. Yaw and xy-position are integrated
    forward from the current yaw / xy by dt*(i+1) times the commanded rates;
    z is held at the desired height; roll/pitch and all rates are held;
    desired vz is 0. Every argument is (B,3)."""
    b = com_rpy.shape[0]
    i1 = (torch.arange(horizon, dtype=com_rpy.dtype, device=com_rpy.device)
          + 1.0) * dt

    def hold(v):
        return v[:, None].expand(b, horizon)

    per_step = torch.stack([
        hold(desired_rpy[:, 0]), hold(desired_rpy[:, 1]),
        com_rpy[:, 2:3] + i1 * desired_omega[:, 2:3],
        com_position[:, 0:1] + i1 * desired_velocity[:, 0:1],
        com_position[:, 1:2] + i1 * desired_velocity[:, 1:2],
        hold(desired_position[:, 2]),
        hold(desired_omega[:, 0]), hold(desired_omega[:, 1]),
        hold(desired_omega[:, 2]),
        hold(desired_velocity[:, 0]), hold(desired_velocity[:, 1]),
        torch.zeros((b, horizon), dtype=com_rpy.dtype, device=com_rpy.device),
        torch.full((b, horizon), -GRAVITY, dtype=com_rpy.dtype,
                   device=com_rpy.device),
    ], dim=2)
    return per_step.reshape(b, horizon * STATE_DIM)


def friction_cone_block(mu):
    """The 5x3 per-(leg,step) constraint block: 4 friction-pyramid rows
    (+-fx + mu fz >= 0, +-fy + mu fz >= 0) and fz. mu () or (B,) ->
    (5,3) or (B,5,3)."""
    mu = torch.as_tensor(mu, dtype=torch.float32)
    zero, one = torch.zeros_like(mu), torch.ones_like(mu)
    return torch.stack([
        torch.stack([-one, zero, mu], dim=-1),
        torch.stack([one, zero, mu], dim=-1),
        torch.stack([zero, -one, mu], dim=-1),
        torch.stack([zero, one, mu], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def constraint_bounds(contact_table, mass, mu, horizon=10):
    """(B,h*4*5) lower/upper bounds from contact_table (B,h,4) in {0,1}:
    fz in [0.1, 10] * m*g * contact; friction rows in
    [0, (mu+1) * fz_max * contact]. mass, mu () or (B,)."""
    b = contact_table.shape[0]
    dt, dev = contact_table.dtype, contact_table.device
    mass = torch.as_tensor(mass, dtype=dt, device=dev).reshape(-1, 1)
    mu = torch.as_tensor(mu, dtype=dt, device=dev).reshape(-1, 1)
    fz_max = mass * GRAVITY * F_MAX_SCALE
    fz_min = mass * GRAVITY * F_MIN_SCALE
    c = contact_table.reshape(b, horizon * 4)
    zero = torch.zeros_like(c)
    lb = torch.stack([zero] * 4 + [fz_min * c], dim=2)
    fric_ub = (mu + 1.0) * fz_max * c
    ub = torch.stack([fric_ub] * 4 + [fz_max * c], dim=2)
    return lb.reshape(b, -1), ub.reshape(b, -1)


def apply_constraint(x, mu, horizon=10):
    """C x without materialising C: x (B,h*12) -> (B,h*4*5). mu () or (B,)."""
    g = friction_cone_block(mu).to(x.device, x.dtype)          # (5,3)/(B,5,3)
    b = x.shape[0]
    g = g.reshape(-1, 5, 3)
    return torch.einsum('bkj,bij->bki', x.reshape(b, horizon * 4, 3),
                        g.expand(b, 5, 3)).reshape(b, -1)


def apply_constraint_t(y, mu, horizon=10):
    """C^T y: y (B,h*4*5) -> (B,h*12). mu () or (B,)."""
    g = friction_cone_block(mu).to(y.device, y.dtype)
    b = y.shape[0]
    g = g.reshape(-1, 5, 3)
    return torch.einsum('bki,bij->bkj', y.reshape(b, horizon * 4, 5),
                        g.expand(b, 5, 3)).reshape(b, -1)
