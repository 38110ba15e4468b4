"""Plain reference of the Min-mode control tick: state estimate, gait, foot
placement, swing trajectories, the condensed SRB MPC, its QP solved by the
phases of the fused kernel (mask, Ruiz, K, inverse, fixed ADMM steps,
residuals at x~, deferred rho, unscale), divergence fallback, leg torques.

A frozen copy of the program's plain path, written with a leading batch axis
and in the dtype of its inputs (the benchmark runs it in float64), taking
every constant from the configuration's file. It imports nothing of the
program: the benchmark hands it the program's state as NamedTuples of its
own (``EstimatorState``, ``LocomotionState``, ``QPState``, by field name).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

GRAVITY_MPC = 9.8
F_MAX_SCALE = 10.0
F_MIN_SCALE = 0.1
N_SEGMENTS = 10
STATE_DIM = 13
KP_SWING = (700.0, 700.0, 150.0)
KD_SWING = (7.0, 7.0, 7.0)
KD_STANCE = 0.2


class Params(NamedTuple):
    abad_link_length: torch.Tensor
    hip_link_length: torch.Tensor
    knee_link_length: torch.Tensor
    abad_location: torch.Tensor   # (3,)
    body_mass: torch.Tensor
    body_inertia: torch.Tensor    # (3,3)
    body_height: torch.Tensor
    friction_coeff: torch.Tensor
    mpc_weights: torch.Tensor     # (13,)


class Control(NamedTuple):
    dt: float
    iterations_between_mpc: int
    horizon: int
    alpha: float
    bonus_swing: float
    qp_divergence_tol: float
    gait_offsets: tuple
    gait_durations: tuple
    qp: dict                       # iters, sigma, relax, rho, rho_eq_scale,
    #                                ruiz_iters, deferred_rho

    @property
    def dt_mpc(self) -> float:
        return self.dt * self.iterations_between_mpc


class EstimatorState(NamedTuple):
    contact_phase: torch.Tensor
    foot_contact_history: torch.Tensor
    ground_normal_yaw: torch.Tensor
    ground_normal_world: torch.Tensor
    com_z: torch.Tensor


class QPState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    rho_mult: torch.Tensor


class LocomotionState(NamedTuple):
    iteration_counter: torch.Tensor
    first_run: torch.Tensor
    first_swing: torch.Tensor
    swing_time_remaining: torch.Tensor
    p0: torch.Tensor
    pf: torch.Tensor
    f_ff: torch.Tensor
    swing_memory: torch.Tensor
    qp_state: QPState


class ControlState(NamedTuple):
    est: EstimatorState
    loco: LocomotionState


def params_from_config(robot: dict, dtype, device) -> Params:
    """The robot's constants as the configuration's file states them."""
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)
    return Params(
        abad_link_length=t(robot["abad_link_length"]),
        hip_link_length=t(robot["hip_link_length"]),
        knee_link_length=t(robot["knee_link_length"]),
        abad_location=t(robot["abad_location"]),
        body_mass=t(robot["body_mass"]),
        body_inertia=torch.diag(t(robot["body_inertia_diag"])),
        body_height=t(robot["body_height"]),
        friction_coeff=t(robot["friction_coeff"]),
        mpc_weights=t(robot["mpc_weights"]))


def control_from_config(control: dict, qp: dict) -> Control:
    return Control(
        dt=control["dt"], iterations_between_mpc=control["iterations_between_mpc"],
        horizon=control["horizon"], alpha=control["alpha"],
        bonus_swing=control["bonus_swing"],
        qp_divergence_tol=control["qp_divergence_tol"],
        gait_offsets=tuple(control["gait_offsets"]),
        gait_durations=tuple(control["gait_durations"]),
        qp={k: qp[k] for k in ("iters", "sigma", "relax", "rho",
                               "rho_eq_scale", "ruiz_iters", "deferred_rho")})


def init_state(params: Params, cfg: Control, batch: int, dtype,
               device) -> ControlState:
    """The controller's state before its first tick."""
    def zeros(*shape, dt=dtype):
        return torch.zeros((batch, *shape), dtype=dt, device=device)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    n, m = cfg.horizon * 12, cfg.horizon * 20
    est = EstimatorState(
        contact_phase=zeros(4), foot_contact_history=zeros(4, 3),
        ground_normal_yaw=up.repeat(batch, 1),
        ground_normal_world=up.repeat(batch, 1),
        com_z=params.body_height.expand(batch).clone())
    loco = LocomotionState(
        iteration_counter=zeros(dt=torch.int32),
        first_run=torch.ones(batch, dtype=torch.bool, device=device),
        first_swing=torch.ones((batch, 4), dtype=torch.bool, device=device),
        swing_time_remaining=zeros(4), p0=zeros(4, 3), pf=zeros(4, 3),
        f_ff=zeros(4, 3), swing_memory=zeros(2, 4, 3),
        qp_state=QPState(x=zeros(n), z=zeros(m), y=zeros(m),
                         rho_mult=torch.ones(batch, dtype=dtype,
                                             device=device)))
    return ControlState(est=est, loco=loco)


# ---- rotations -------------------------------------------------------------

def _mat3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_x(th):
    s, c = torch.sin(th), torch.cos(th)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[o, z, z], [z, c, s], [z, -s, c]])


def rot_y(th):
    s, c = torch.sin(th), torch.cos(th)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[c, z, -s], [z, o, z], [s, z, c]])


def rot_z(th):
    s, c = torch.sin(th), torch.cos(th)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[c, s, z], [-s, c, z], [z, z, o]])


def skew(v):
    a, b, c = v[..., 0], v[..., 1], v[..., 2]
    z = torch.zeros_like(a)
    return _mat3([[z, -c, b], [c, z, -a], [-b, a, z]])


def quat_to_rot(q):
    """(w,x,y,z) -> world->body coordinate transform."""
    e0, e1, e2, e3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = _mat3([
        [1 - 2 * (e2 * e2 + e3 * e3), 2 * (e1 * e2 - e0 * e3), 2 * (e1 * e3 + e0 * e2)],
        [2 * (e1 * e2 + e0 * e3), 1 - 2 * (e1 * e1 + e3 * e3), 2 * (e2 * e3 - e0 * e1)],
        [2 * (e1 * e3 - e0 * e2), 2 * (e2 * e3 + e0 * e1), 1 - 2 * (e1 * e1 + e2 * e2)],
    ])
    return r.transpose(-1, -2)


def quat_to_rpy(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    as_ = torch.clamp(-2.0 * (x * z - w * y), -0.99999, 0.99999)
    roll = torch.atan2(2.0 * (y * z + w * x), w * w - x * x - y * y + z * z)
    pitch = torch.asin(as_)
    yaw = torch.atan2(2.0 * (x * y + w * z), w * w + x * x - y * y - z * z)
    return torch.stack([roll, pitch, yaw], dim=-1)


def rpy_to_rot(rpy):
    return rot_x(rpy[..., 0]) @ rot_y(rpy[..., 1]) @ rot_z(rpy[..., 2])


def rot_to_quat(rot):
    r = rot.transpose(-1, -2)
    r00, r01, r02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    r10, r11, r12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    r20, r21, r22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = r00 + r11 + r22

    def sq(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12))

    s0 = sq(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (r21 - r12) / s0, (r02 - r20) / s0,
                      (r10 - r01) / s0], dim=-1)
    s1 = sq(1.0 + r00 - r11 - r22) * 2.0
    q1 = torch.stack([(r21 - r12) / s1, 0.25 * s1, (r01 + r10) / s1,
                      (r02 + r20) / s1], dim=-1)
    s2 = sq(1.0 + r11 - r00 - r22) * 2.0
    q2 = torch.stack([(r02 - r20) / s2, (r01 + r10) / s2, 0.25 * s2,
                      (r12 + r21) / s2], dim=-1)
    s3 = sq(1.0 + r22 - r00 - r11) * 2.0
    q3 = torch.stack([(r10 - r01) / s3, (r02 + r20) / s3, (r12 + r21) / s3,
                      0.25 * s3], dim=-1)
    use0 = (tr > 0.0)[..., None]
    use1 = torch.logical_and(r00 > r11, r00 > r22)[..., None]
    use2 = (r11 > r22)[..., None]
    return torch.where(use0, q0, torch.where(use1, q1,
                                             torch.where(use2, q2, q3)))


def axis_angle_to_rot(axis, theta):
    c, s = torch.cos(theta), torch.sin(theta)
    v = 1.0 - c
    k0, k1, k2 = axis[..., 0], axis[..., 1], axis[..., 2]
    return _mat3([
        [k0 * k0 * v + c, k0 * k1 * v - k2 * s, k0 * k2 * v + k1 * s],
        [k0 * k1 * v + k2 * s, k1 * k1 * v + c, k1 * k2 * v - k0 * s],
        [k0 * k2 * v - k1 * s, k1 * k2 * v + k0 * s, k2 * k2 * v + c],
    ]).transpose(-1, -2)


def rot_from_normals(world_normal, ground_normal):
    world_normal, ground_normal = torch.broadcast_tensors(world_normal,
                                                          ground_normal)
    axis = torch.linalg.cross(world_normal, ground_normal, dim=-1)
    norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.clamp_min(norm, 1e-8)
    cosang = torch.clamp((world_normal * ground_normal).sum(-1), -1.0, 1.0)
    return axis_angle_to_rot(axis, torch.acos(cosang))


# ---- legs ------------------------------------------------------------------

def side_sign(like):
    return torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=like.dtype,
                        device=like.device)


def leg_fk_jacobian(q, abad_len, hip_len, knee_len):
    """Foot position in the hip frame (...,4,3) and dp/dq (...,4,3,3)."""
    dy = abad_len[..., None] * side_sign(q)
    dz1 = -hip_len[..., None]
    dz2 = -knee_len[..., None]
    s1, s2, s3 = torch.sin(q[..., 0]), torch.sin(q[..., 1]), torch.sin(q[..., 2])
    c1, c2, c3 = torch.cos(q[..., 0]), torch.cos(q[..., 1]), torch.cos(q[..., 2])
    c23 = c2 * c3 - s2 * s3
    s23 = s2 * c3 + c2 * s3
    p = torch.stack([dz2 * s23 + dz1 * s2,
                     dy * c1 - dz1 * c2 * s1 - dz2 * s1 * c23,
                     dy * s1 + dz1 * c1 * c2 + dz2 * c1 * c23], dim=-1)
    j00 = torch.zeros_like(s1)
    j10 = -dy * s1 - dz2 * c1 * c23 - dz1 * c1 * c2
    j20 = -dz2 * s1 * c23 + dy * c1 - dz1 * c2 * s1
    j01 = dz2 * c23 + dz1 * c2
    j11 = dz2 * s1 * s23 + dz1 * s1 * s2
    j21 = -dz2 * c1 * s23 - dz1 * c1 * s2
    j02 = dz2 * c23
    j12 = dz2 * s1 * s23
    j22 = -dz2 * c1 * s23
    jac = torch.stack([torch.stack([j00, j01, j02], dim=-1),
                       torch.stack([j10, j11, j12], dim=-1),
                       torch.stack([j20, j21, j22], dim=-1)], dim=-2)
    return p, jac


def hip_locations(abad_location):
    ax, ay, az = (abad_location[..., 0], abad_location[..., 1],
                  abad_location[..., 2])
    return torch.stack([torch.stack([ax, ax, -ax, -ax], dim=-1),
                        torch.stack([ay, -ay, ay, -ay], dim=-1),
                        torch.stack([az, az, az, az], dim=-1)], dim=-1)


# ---- gait ------------------------------------------------------------------

def _phase(counter, ipm, dtype):
    return torch.remainder(counter.to(dtype), float(ipm) * N_SEGMENTS) / ipm


def contact_state(phase, offsets, durations):
    progress = phase[..., None] - offsets
    progress = torch.where(progress < 0, progress + N_SEGMENTS, progress)
    return torch.where(progress <= durations, progress / durations,
                       torch.zeros_like(progress))


def swing_state(phase, offsets, durations):
    swing_offset = offsets + durations
    swing_offset = torch.where(swing_offset > N_SEGMENTS,
                               swing_offset - N_SEGMENTS, swing_offset)
    swing_duration = N_SEGMENTS - durations
    progress = phase[..., None] - swing_offset
    progress = torch.where(progress < 0, progress + N_SEGMENTS, progress)
    in_swing = torch.logical_and(progress <= swing_duration,
                                 swing_duration > 0.0)
    return torch.where(in_swing,
                       progress / torch.clamp_min(swing_duration, 1e-9),
                       torch.zeros_like(progress))


def mpc_table(iteration, offsets, durations):
    seg = torch.arange(N_SEGMENTS, dtype=iteration.dtype,
                       device=iteration.device)
    it = torch.remainder(seg + iteration[..., None] + 1.0, N_SEGMENTS)
    progress = it[..., :, None] - offsets[..., None, :]
    progress = torch.where(progress < 0, progress + N_SEGMENTS, progress)
    return (progress < durations[..., None, :]).to(iteration.dtype)


def _bezier(y0, yf, x):
    return y0 + (x * x * x + 3.0 * (x * x * (1.0 - x))) * (yf - y0)


def _bezier_d1(y0, yf, x):
    return 6.0 * x * (1.0 - x) * (yf - y0)


def swing_trajectory(p0, pf, height, phase, swing_time):
    st = torch.clamp_min(swing_time, 1e-6)
    ph = phase[..., None]
    p = _bezier(p0, pf, ph)
    v = _bezier_d1(p0, pf, ph) / st[..., None]
    z0, zf = p0[..., 2], pf[..., 2]
    zmid = z0 + height
    x1 = torch.clamp(phase * 2.0, 0.0, 1.0)
    x2 = torch.clamp(phase * 2.0 - 1.0, 0.0, 1.0)
    first_half = phase < 0.5
    zp = torch.where(first_half, _bezier(z0, zmid, x1), _bezier(zmid, zf, x2))
    zv = torch.where(first_half, _bezier_d1(z0, zmid, x1) * 2.0 / st,
                     _bezier_d1(zmid, zf, x2) * 2.0 / st)
    return (torch.cat([p[..., :2], zp[..., None]], dim=-1),
            torch.cat([v[..., :2], zv[..., None]], dim=-1))


# ---- state estimate ---------------------------------------------------------

def estimate(est: EstimatorState, body_state):
    """Frame transforms of the (B,13) root state [pos, quat xyzw, v, w]."""
    quat = torch.stack([body_state[:, 6], body_state[:, 3], body_state[:, 4],
                        body_state[:, 5]], dim=-1)
    r_body = quat_to_rot(quat)
    v_body = torch.einsum('bij,bj->bi', r_body, body_state[:, 7:10])
    omega_body = torch.einsum('bij,bj->bi', r_body, body_state[:, 10:13])
    rpy = quat_to_rpy(quat)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=quat.dtype, device=quat.device)
    yaw_r_ground = rot_from_normals(up, est.ground_normal_yaw)
    ground_r_body = (r_body @ rot_z(rpy[:, 2]).transpose(-1, -2)
                     @ yaw_r_ground.transpose(-1, -2))
    return dict(rpy_body=quat_to_rpy(rot_to_quat(ground_r_body)),
                v_body=v_body, omega_body=omega_body,
                ground_r_body=ground_r_body, com_z=est.com_z)


# ---- SRB MPC ---------------------------------------------------------------

def _a_mat(rpy, dtype):
    b = rpy.shape[0]
    cy, sy = torch.cos(rpy[:, 2]), torch.sin(rpy[:, 2])
    cp, tp = torch.cos(rpy[:, 1]), torch.tan(rpy[:, 1])
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)
    a = torch.zeros((b, STATE_DIM, STATE_DIM), dtype=dtype, device=rpy.device)
    a[:, 0:3, 6:9] = torch.stack([
        torch.stack([cy / cp, sy / cp, zero], dim=-1),
        torch.stack([-sy, cy, zero], dim=-1),
        torch.stack([cy * tp, sy * tp, one], dim=-1)], dim=-2)
    a[:, 3, 9] = 1.0
    a[:, 4, 10] = 1.0
    a[:, 5, 11] = 1.0
    a[:, 11, 12] = 1.0          # gravity column, flat ground normal (0,0,1)
    return a


def _b_mat(inv_mass, inv_inertia_world, feet_world):
    b = feet_world.shape[0]
    dt, dev = feet_world.dtype, feet_world.device
    torque = torch.einsum('bij,bljk->bilk', inv_inertia_world, skew(feet_world))
    out = torch.zeros((b, STATE_DIM, 12), dtype=dt, device=dev)
    out[:, 6:9] = torque.reshape(b, 3, 12)
    out[:, 9:12] = torch.eye(3, dtype=dt, device=dev).repeat(1, 4) * inv_mass
    return out


def _chain(a_exp, b_exp, horizon):
    """A_qp (B,h*13,13) with the last block zero (the reference solver's
    fill loop stops one block early), and s[k] = A^k B (B,h,13,12)."""
    powers, anb = [a_exp], [b_exp]
    for _ in range(horizon - 1):
        powers.append(a_exp @ powers[-1])
        anb.append(a_exp @ anb[-1])
    powers[horizon - 1] = torch.zeros_like(powers[horizon - 1])
    return torch.cat(powers, dim=-2), torch.stack(anb, dim=1)


def _desired(com_rpy, com_z, body_height, commands, dt, horizon):
    b = com_rpy.shape[0]
    i1 = (torch.arange(horizon, dtype=com_rpy.dtype, device=com_rpy.device)
          + 1.0) * dt
    zero = torch.zeros((b, horizon), dtype=com_rpy.dtype, device=com_rpy.device)

    def hold(v):
        return v[:, None].expand(b, horizon)

    per_step = torch.stack([
        zero, zero, com_rpy[:, 2:3] + i1 * commands[:, 2:3],
        i1 * commands[:, 0:1], i1 * commands[:, 1:2],
        hold(body_height.expand(b)), zero, zero, hold(commands[:, 2]),
        hold(commands[:, 0]), hold(commands[:, 1]), zero,
        torch.full_like(zero, -GRAVITY_MPC)], dim=2)
    return per_step.reshape(b, horizon * STATE_DIM)


def _gradient(s, a_qp, x0, x_des, weights):
    """q = 2 B_qp^T Q (A_qp x0 - x_des) from the chain."""
    b, h, sd, ad = s.shape
    wsd = ((torch.einsum('bij,bj->bi', a_qp, x0) - x_des).reshape(b, h, sd)
           * weights.reshape(-1, 1, sd))
    q = torch.zeros((b, h, ad), dtype=s.dtype, device=s.device)
    for a in range(h):
        for k in range(h - a):
            q[:, a] += torch.einsum('bcr,bc->br', s[:, k], wsd[:, a + k])
    return 2.0 * q.reshape(b, h * ad)


def hessian_from_chain(s, weights, alpha):
    """P (B,n,n): block (a,b) = 2 sum_{k<=h-1-max(a,b)} s[k]^T Q s[k+|a-b|]
    (transposed above the diagonal), alpha on the diagonal."""
    b, h, sd, ad = s.shape
    m4 = torch.einsum('bkci,blcj->bklij', s * weights[:, None, :, None], s)
    rows = []
    for a in range(h):
        row = []
        for bb in range(h):
            hi, d = max(a, bb), abs(a - bb)
            blk = sum(m4[:, k, k + d] for k in range(h - hi))
            row.append(blk if a >= bb else blk.transpose(-1, -2))
        rows.append(torch.cat(row, dim=-1))
    p = 2.0 * torch.cat(rows, dim=-2)
    return p + alpha * torch.eye(h * ad, dtype=p.dtype, device=p.device)


def _c_apply(cs, v):
    b, nb = cs.shape[:2]
    return torch.einsum('bkij,bkj->bki', cs, v.reshape(b, nb, 3)).reshape(b, -1)


def _ct_apply(cs, w):
    b, nb = cs.shape[:2]
    return torch.einsum('bkij,bki->bkj', cs, w.reshape(b, nb, 5)).reshape(b, -1)


def solve_qp(p_mat, q_vec, c_blocks, lb, ub, mask, st: QPState, qp: dict):
    """Row 1's phases on the raw Hessian: swing mask, Ruiz with cost
    scaling, K = P + sigma I + C^T rho C, K^-1 (Cholesky), fixed ADMM
    steps, relative residuals at x~ and the deferred rho rescale, unscale.
    Returns (x, z, y, rho_mult, violation)."""
    b, nb = c_blocks.shape[:2]
    n, m = 3 * nb, 5 * nb
    dt, dev = p_mat.dtype, p_mat.device
    eye = torch.eye(n, dtype=dt, device=dev)
    k = p_mat * mask[:, :, None] * mask[:, None, :] + eye * (1.0 - mask)[:, None, :]
    q_s = q_vec * mask
    cs = c_blocks
    d = torch.ones_like(q_s)
    e = torch.ones((b, m), dtype=dt, device=dev)
    c_cost = torch.ones((b, 1), dtype=dt, device=dev)
    for _ in range(qp["ruiz_iters"]):
        col = torch.maximum(k.abs().amax(dim=1),
                            cs.abs().amax(dim=2).reshape(b, n))
        dd = torch.rsqrt(col.clamp_min(1e-8))
        de = torch.rsqrt(cs.abs().amax(dim=3).reshape(b, m).clamp_min(1e-8))
        k = k * dd[:, :, None] * dd[:, None, :]
        q_s = q_s * dd
        cs = cs * de.reshape(b, nb, 5, 1) * dd.reshape(b, nb, 1, 3)
        d, e = d * dd, e * de
        gamma = 1.0 / torch.maximum(
            k.abs().amax(dim=1).mean(dim=1, keepdim=True),
            q_s.abs().amax(dim=1, keepdim=True)).clamp_min(1e-8)
        k = k * gamma[:, :, None]
        q_s = q_s * gamma
        c_cost = c_cost * gamma
    l_s, u_s = e * lb, e * ub
    rm = st.rho_mult.reshape(b, 1)
    base = qp["rho"] * rm
    rho = torch.where((ub - lb) < 1e-9, base * qp["rho_eq_scale"],
                      base.expand(b, m))
    blk = torch.einsum('bkri,bkr,bkrj->bkij', cs, rho.reshape(b, nb, 5), cs)
    blk = blk + qp["sigma"] * torch.eye(3, dtype=dt, device=dev)
    k = k + torch.einsum('kc,bkij->bkicj', torch.eye(nb, dtype=dt, device=dev),
                         blk).reshape(b, n, n)
    k_inv = torch.cholesky_inverse(torch.linalg.cholesky_ex(k).L)

    def solve(rhs):
        return torch.einsum('bij,bj->bi', k_inv, rhs)

    sigma, relax = qp["sigma"], qp["relax"]
    xs, zs, ys = st.x / d, st.z * e, st.y * (c_cost / e)
    for _ in range(qp["iters"]):
        x_t = solve(sigma * xs - q_s + _ct_apply(cs, rho * zs - ys))
        z_t = _c_apply(cs, x_t)
        xs = relax * x_t + (1.0 - relax) * xs
        z_r = relax * z_t + (1.0 - relax) * zs
        z_new = torch.minimum(torch.maximum(z_r + ys / rho, l_s), u_s)
        ys = ys + rho * (z_r - z_new)
        zs = z_new
    rhs_f = sigma * xs - q_s + _ct_apply(cs, rho * zs - ys)
    x_t = solve(rhs_f)
    cx = _c_apply(cs, x_t)
    px = rhs_f - sigma * x_t - _ct_apply(cs, rho * cx)

    def absmax(v):
        return v.abs().amax(dim=1, keepdim=True)

    pri = absmax(cx - zs) / torch.maximum(absmax(cx), absmax(zs)).clamp_min(1e-8)
    cty = _ct_apply(cs, ys)
    dua = absmax(px + q_s + cty) / torch.maximum(
        absmax(px), torch.maximum(absmax(cty), absmax(q_s))).clamp_min(1e-8)
    if qp["deferred_rho"]:
        scale = torch.sqrt(pri / dua.clamp_min(1e-10)).clamp(1e-2, 1e2)
        rm = (rm * scale).clamp(1e-3, 1e3)
    x_u = xs * d
    z_u = _c_apply(c_blocks, x_u)
    viol = torch.maximum(lb - z_u, z_u - ub).amax(dim=1).clamp_min(0.0)
    return x_u, z_u, ys * (e / c_cost), rm.reshape(b), viol


def _solve_mpc(params: Params, cfg: Control, se, com_z, feet_body, mpc_tbl,
               weights, commands, qp_state: QPState):
    h = cfg.horizon
    b = com_z.shape[0]
    dt, dev = com_z.dtype, com_z.device
    zero = torch.zeros_like(com_z)
    rpy = se["rpy_body"]
    r_feet = (rot_x(rpy[:, 0]).transpose(-1, -2)
              @ rot_y(rpy[:, 1]).transpose(-1, -2)
              @ rot_z(rpy[:, 2]).transpose(-1, -2))
    feet_world = feet_body @ r_feet.transpose(-1, -2)
    rotation = rpy_to_rot(rpy).transpose(-1, -2)
    inv_i_world = rotation @ torch.linalg.inv(params.body_inertia) @ rotation.transpose(-1, -2)
    a = _a_mat(rpy, dt)
    bm = _b_mat(1.0 / params.body_mass, inv_i_world, feet_world)
    eye = torch.eye(STATE_DIM, dtype=dt, device=dev)
    t = cfg.dt_mpc
    a2 = a @ a
    a_exp = eye + t * a + (0.5 * t * t) * a2
    b_exp = (t * eye + (0.5 * t * t) * a + (t * t * t / 6.0) * a2) @ bm
    a_qp, s = _chain(a_exp, b_exp, h)
    x0 = torch.cat([rpy, torch.stack([zero, zero, com_z], dim=-1),
                    se["omega_body"], se["v_body"],
                    torch.full_like(rpy[:, :1], -GRAVITY_MPC)], dim=-1)
    x_des = _desired(rpy, com_z, params.body_height, commands, t, h)
    w = weights.expand(b, STATE_DIM)
    q_vec = _gradient(s, a_qp, x0, x_des, w)
    p_mat = hessian_from_chain(s, w, cfg.alpha)

    mu = params.friction_coeff
    contact = mpc_tbl.reshape(b, h * 4)
    fz_max = params.body_mass * GRAVITY_MPC * F_MAX_SCALE
    fz_min = params.body_mass * GRAVITY_MPC * F_MIN_SCALE
    zc = torch.zeros_like(contact)
    lb = torch.stack([zc] * 4 + [fz_min * contact], dim=2).reshape(b, -1)
    fric = (mu + 1.0) * fz_max * contact
    ub = torch.stack([fric] * 4 + [fz_max * contact], dim=2).reshape(b, -1)
    mask = torch.repeat_interleave(contact, 3, dim=1)
    one = torch.ones_like(mu)
    cone = torch.stack([torch.stack([-one, 0 * one, mu]),
                        torch.stack([one, 0 * one, mu]),
                        torch.stack([0 * one, -one, mu]),
                        torch.stack([0 * one, one, mu]),
                        torch.stack([0 * one, 0 * one, one])])
    c_blocks = cone.expand(b, h * 4, 5, 3)

    nb_, mb_ = 12, 20                     # one horizon step of x / of z, y
    def shift(v, k):
        return torch.cat([v[:, k:], v[:, -k:]], dim=-1)
    st = qp_state._replace(x=shift(qp_state.x, nb_), z=shift(qp_state.z, mb_),
                           y=shift(qp_state.y, mb_))
    x, z, y, rm, viol = solve_qp(p_mat, q_vec, c_blocks, lb, ub, mask, st,
                                 cfg.qp)
    return -x[:, :12].reshape(b, 4, 3), QPState(x=x, z=z, y=y, rho_mult=rm), viol


def tick(params: Params, cfg: Control, state: ControlState, dof_q, dof_qd,
         body_state, commands, solve: bool):
    """One Min-mode tick. Returns (new state, torques (B,12), outputs dict
    with the solve's violation and divergence flag, (B,) each)."""
    b = commands.shape[0]
    dt, dev = commands.dtype, commands.device
    loco, est = state.loco, state.est
    q = dof_q.reshape(b, 4, 3)
    qd = dof_qd.reshape(b, 4, 3)
    p_leg, jac = leg_fk_jacobian(q, params.abad_link_length,
                                 params.hip_link_length, params.knee_link_length)
    v_leg = torch.einsum('blij,blj->bli', jac, qd)
    se = estimate(est, body_state)

    offsets = torch.tensor(cfg.gait_offsets, dtype=dt, device=dev).expand(b, 4)
    durations = torch.tensor(cfg.gait_durations, dtype=dt, device=dev).expand(b, 4)
    ipm = cfg.iterations_between_mpc
    t_mpc = cfg.dt_mpc
    phase = _phase(loco.iteration_counter, ipm, dt)

    hips = hip_locations(params.abad_location)
    feet = hips + p_leg
    p_foot = feet + torch.stack([torch.zeros_like(est.com_z),
                                 torch.zeros_like(est.com_z), est.com_z],
                                dim=-1)[:, None, :]
    first = loco.first_run
    feet_h = torch.cat([feet[..., :2], (-params.body_height).expand(b, 4, 1)],
                       dim=-1)
    hist = torch.where(first[:, None, None], feet_h, est.foot_contact_history)
    p0 = torch.where(first[:, None, None], p_foot, loco.p0)

    # flat ground: only the CoM height is estimated
    contacts = est.contact_phase
    n_contact = contacts.sum(dim=-1)
    heights = -(feet @ se["ground_r_body"].transpose(-1, -2))[..., 2]
    zc = (heights * contacts).sum(dim=-1) / torch.clamp_min(n_contact, 1e-6)
    com_z = torch.where(n_contact > 0, zc, est.com_z)
    zero = torch.zeros_like(com_z)
    position = torch.stack([zero, zero, com_z], dim=-1)

    swing_times = (t_mpc * (N_SEGMENTS - durations[:, 0:1])).expand(b, 4)
    stance_times = (t_mpc * durations[:, 0:1]).expand(b, 4)
    swing_remaining = torch.where(loco.first_swing, swing_times,
                                  loco.swing_time_remaining - cfg.dt)
    v_des = torch.stack([commands[:, 0], commands[:, 1], zero], dim=-1)
    offset_y = side_sign(commands) * params.abad_link_length
    z4 = torch.zeros_like(offset_y)
    p_robot = (hips + torch.stack([z4, offset_y, z4], dim=-1)).expand(b, 4, 3)
    yaw_rot = rot_z(-commands[:, 2:3] * stance_times / 2.0)
    pf_new = (position[:, None, :] + torch.einsum('blij,blj->bli', yaw_rot, p_robot)
              + v_des[:, None, :] * swing_remaining[..., None])
    vx, vy = se["v_body"][:, 0:1], se["v_body"][:, 1:2]
    yaw_rate = commands[:, 2:3]
    pz = position[:, 2:3]
    pfx = (vx * (0.5 + cfg.bonus_swing) * stance_times
           + 0.03 * (vx - v_des[:, 0:1]) + (0.5 * pz / 9.81) * (vy * yaw_rate))
    pfy = (vy * 0.5 * stance_times * t_mpc + 0.03 * (vy - v_des[:, 1:2])
           + (0.5 * pz / 9.81) * (-vx * yaw_rate))
    pfx, pfy = torch.clamp(pfx, -0.3, 0.3), torch.clamp(pfy, -0.3, 0.3)
    pf = torch.stack([pf_new[..., 0] + pfx, pf_new[..., 1] + pfy,
                      torch.full_like(pfx, -0.003)], dim=-1)

    counter = loco.iteration_counter + 1
    contact_states = contact_state(phase, offsets, durations)
    swing_states = swing_state(phase, offsets, durations)
    mpc_tbl = mpc_table(phase, offsets, durations)
    want = (counter % ipm) == 0

    if solve:
        f_ff, qp_state, viol = _solve_mpc(params, cfg, se, com_z, feet,
                                          mpc_tbl, params.mpc_weights,
                                          commands, loco.qp_state)
    else:
        f_ff, qp_state, viol = loco.f_ff, loco.qp_state, zero
    diverged = viol > cfg.qp_divergence_tol
    f_ff = torch.where(diverged[:, None, None], loco.f_ff, f_ff)
    cold = QPState(x=torch.zeros_like(qp_state.x), z=torch.zeros_like(qp_state.z),
                   y=torch.zeros_like(qp_state.y), rho_mult=qp_state.rho_mult)
    qp_state = QPState(*[torch.where(diverged.reshape((-1,) + (1,) * (c.dim() - 1)),
                                     c, n) for c, n in zip(cold, qp_state)])
    f_ff = torch.where(want[:, None, None], f_ff, loco.f_ff)
    qp_state = QPState(*[torch.where(want.reshape((-1,) + (1,) * (n.dim() - 1)),
                                     n, o) for n, o in zip(qp_state, loco.qp_state)])

    in_swing = swing_states > 0
    p0 = torch.where(torch.logical_and(in_swing, loco.first_swing)[..., None],
                     p_foot, p0)
    swing_p, swing_v = swing_trajectory(p0, pf, (params.body_height / 3.0).expand(b, 4),
                                        swing_states, swing_times)
    p_des_foot = torch.where(in_swing[..., None], swing_p, loco.swing_memory[:, 0])
    v_des_foot = torch.where(in_swing[..., None], swing_v, loco.swing_memory[:, 1])
    p_des = p_des_foot - position[:, None, :] - hips
    v_des_leg = v_des_foot - se["v_body"][:, None, :]

    kp = torch.tensor(KP_SWING, dtype=dt, device=dev)
    kd = torch.tensor(KD_SWING, dtype=dt, device=dev)
    sw = in_swing[..., None]
    force = (torch.where(sw, 0.0, f_ff)
             + torch.where(sw, kp * (p_des - p_leg), 0.0)
             + kd * (v_des_leg - v_leg))
    tau = torch.einsum('blji,blj->bli', jac, force)
    tau = tau + torch.where(sw, 0.0, KD_STANCE * (0.0 - qd))
    new_est = est._replace(
        contact_phase=torch.where(in_swing, torch.zeros_like(contact_states),
                                  contact_states),
        foot_contact_history=hist, com_z=com_z)
    new_loco = LocomotionState(
        iteration_counter=counter, first_run=torch.zeros_like(loco.first_run),
        first_swing=torch.logical_not(in_swing),
        swing_time_remaining=swing_remaining, p0=p0, pf=pf, f_ff=f_ff,
        swing_memory=torch.stack([p_des_foot, v_des_foot], dim=1),
        qp_state=qp_state)
    return (ControlState(est=new_est, loco=new_loco), tau.reshape(b, 12),
            {"violation": viol, "diverged": diverged})
