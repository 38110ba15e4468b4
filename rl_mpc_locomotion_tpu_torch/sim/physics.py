"""Batched quadruped physics: single-rigid-body trunk + torque-driven legs
with penalty ground contact.

Counterpart of ``rl_mpc_locomotion_tpu/sim/physics.py``, for a batch of
robots in lockstep: every ``PhysState`` field carries a leading env axis
``B``. The trunk is a 6-DoF rigid body driven by foot contact forces and
gravity; each of the 12 joints integrates tau -> qdd against a small
reflected inertia; feet meet the terrain through a spring-damper normal
force and a stick-slip Coulomb tangential force.

Per-env values: a float field of ``PhysicsConfig`` may be a ``(B,)`` tensor
(domain randomisation puts its draws there) and so may the fields of
``RobotParams``; every use broadcasts either. The trunk's angular update
solves against the world inertia ``R I R^T`` with the body-frame inverse,
``R I^-1 R^T``: the same solution as the JAX package's ``linalg.solve`` up
to rounding, without a factorisation a step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.robots import RobotParams
from ..ops import rotations as rot
from ..ops.leg_kinematics import hip_locations, leg_fk_jacobian, side_sign
from . import terrain as terrain_mod

GRAVITY = 9.81  # sim gravity


class PhysicsConfig(NamedTuple):
    """Stability budget (semi-implicit Euler, per-substep dt): the stiffest
    mode is the contact spring/damper reflected through the leg Jacobian
    onto the joint inertia, omega ~ 140 rad/s and lambda ~ 340 1/s with the
    values below; both need (omega|lambda)*dt < 2 -> dt = 2 ms with margin.
    Joint damping is integrated implicitly so it never constrains dt.

    Float fields may hold a ``(B,)`` tensor of per-env values."""
    dt: float = 0.002            # inner step; 5 substeps per 100 Hz tick
    substeps: int = 5
    joint_inertia: float = 0.08   # reflected rotor+link inertia per joint
    joint_damping: float = 1.0    # implicit
    joint_friction: float = 0.1
    tau_limit: float = 55.0
    contact_kn: float = 15000.0  # normal spring
    contact_cn: float = 150.0    # normal damper
    contact_kt: float = 4000.0   # tangential anchor spring (stiction)
    contact_ct: float = 60.0     # tangential damper
    friction_mu: float = 1.0
    q_min: float = -3.5
    q_max: float = 3.5
    # ---- leg-inertia coupling (off = pure SRB trunk) --------------------
    # Each leg is a composite point mass m_l = leg_mass_frac * body_mass at
    # the fraction leg_com_frac along hip->foot (total mass stays
    # body_mass). See substep() for the momentum-consistent explicit scheme.
    leg_coupling: bool = False
    leg_mass_frac: float = 0.1   # per-leg fraction of total mass
    leg_com_frac: float = 0.35   # leg CoM fraction along hip->foot
    leg_force_limit: float = 3.0  # |f_leg| clamp, multiples of m_l * g
    leg_force_tau: float = 0.03   # trunk-side reaction low-pass (s)
    # ---- articulated 18-DoF plant (third fidelity tier) -----------------
    # True routes substeps to sim.articulated (floating-base Lagrangian over
    # the URDF link tree); needs RobotParams.art (articulated.with_articulated).
    # Overrides leg_coupling.
    articulated: bool = False


class PhysState(NamedTuple):
    pos: torch.Tensor       # (B,3)
    quat: torch.Tensor      # (B,4) wxyz, body->world orientation
    v: torch.Tensor         # (B,3) world linear velocity
    omega: torch.Tensor     # (B,3) world angular velocity
    q: torch.Tensor         # (B,12)
    qd: torch.Tensor        # (B,12)
    anchor: torch.Tensor    # (B,4,2) stick-slip friction anchors (world xy)
    contact: torch.Tensor   # (B,4) bool: foot was in contact last substep
    f_leg: torch.Tensor     # (B,4,3) low-passed leg-inertia reaction (world)


def _env(v, nd: int):
    """A config or parameter value ready to broadcast against a tensor of
    ``nd`` dims whose first is the env axis: a float or 0-dim tensor as it
    is, a (B,) tensor as (B, 1, ...)."""
    if isinstance(v, torch.Tensor) and v.dim() == 1:
        return v.reshape((-1,) + (1,) * (nd - 1))
    return v


def init_state(params: RobotParams, q0, height=0.4, batch: int = 1,
               device="cpu") -> PhysState:
    """Standing start at (0, 0, height). ``q0`` is (12,) or (B,12);
    ``height`` a float, a 0-dim or a (B,) tensor."""
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    q0 = torch.as_tensor(q0, dtype=torch.float32).to(device)
    quat = torch.zeros((batch, 4), dtype=torch.float32, device=device)
    quat[:, 0] = 1.0
    return PhysState(
        pos=torch.stack([z, z, z + height], dim=-1),
        quat=quat,
        v=torch.zeros((batch, 3), dtype=torch.float32, device=device),
        omega=torch.zeros((batch, 3), dtype=torch.float32, device=device),
        q=q0.expand(batch, 12).clone(),
        qd=torch.zeros((batch, 12), dtype=torch.float32, device=device),
        anchor=torch.zeros((batch, 4, 2), dtype=torch.float32, device=device),
        contact=torch.zeros((batch, 4), dtype=torch.bool, device=device),
        f_leg=torch.zeros((batch, 4, 3), dtype=torch.float32, device=device),
    )


def foot_positions_world(params: RobotParams, state: PhysState):
    """Foot world positions (B,4,3) and the pieces needed elsewhere:
    body-frame feet (B,4,3), leg Jacobians (B,4,3,3), body->world (B,3,3)."""
    r_wb = rot.quat_to_rot(state.quat).transpose(-1, -2)  # body->world
    q = state.q.reshape(-1, 4, 3)
    p_hip, jac = leg_fk_jacobian(q, params.abad_link_length,
                                 params.hip_link_length,
                                 params.knee_link_length)
    hips = hip_locations(params.abad_location)
    p_body = hips + p_hip
    p_world = state.pos[:, None, :] + p_body @ r_wb.transpose(-1, -2)
    return p_world, p_body, jac, r_wb


def _contact_force(cfg: PhysicsConfig, ter, p_w, v_w, anchor, was_contact):
    """Stick-slip penalty contact at the feet.

    Normal: spring-damper on penetration. Tangential: a spring to a per-foot
    anchor point plus viscous damping, clamped to the Coulomb cone; on slip
    the anchor is dragged so the spring force sits exactly on the cone.

    Returns (force (B,4,3), in_contact (B,4), new_anchor (B,4,2)).
    """
    kn, cn = _env(cfg.contact_kn, 2), _env(cfg.contact_cn, 2)
    kt, ct = _env(cfg.contact_kt, 3), _env(cfg.contact_ct, 3)
    mu = _env(cfg.friction_mu, 3)
    ground = terrain_mod.sample_height(ter, p_w[..., :2])
    pen = ground - p_w[..., 2]
    in_contact = pen > 0.0
    fz = torch.clamp_min(kn * pen - cn * v_w[..., 2], 0.0)
    fz = torch.where(in_contact, fz, 0.0)

    xy = p_w[..., :2]
    # (re)set anchor on touchdown or while airborne
    fresh = torch.logical_or(torch.logical_not(was_contact),
                             torch.logical_not(in_contact))
    anchor = torch.where(fresh[..., None], xy, anchor)

    ft = -kt * (xy - anchor) - ct * v_w[..., :2]
    ft_norm = torch.linalg.vector_norm(ft, dim=-1, keepdim=True)
    ft_max = mu * fz[..., None]
    over = ft_norm > torch.clamp_min(ft_max, 1e-9)
    ft_clamped = torch.where(over, ft * ft_max / torch.clamp_min(ft_norm, 1e-9),
                             ft)
    # slip: drag the anchor so the spring alone would sit on the cone
    anchor_slip = xy + ft_clamped / kt
    anchor = torch.where(torch.logical_and(over, in_contact[..., None]),
                         anchor_slip, anchor)
    ft_final = torch.where(in_contact[..., None], ft_clamped, 0.0)
    return (torch.cat([ft_final, fz[..., None]], dim=-1), in_contact, anchor)


def _gravity(like):
    """(0, 0, -GRAVITY) on the device of ``like``, made there."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[2] * -GRAVITY


def substep(params: RobotParams, cfg: PhysicsConfig, ter, state: PhysState,
            tau):
    """One physics substep for the batch, semi-implicit Euler.

    Returns (new state, foot contact forces (B,4,3), contact mask (B,4))."""
    if cfg.articulated:
        from . import articulated
        return articulated.substep(params, cfg, ter, state, tau)
    b = state.pos.shape[0]
    dt = _env(cfg.dt, 2)
    tau_limit = _env(cfg.tau_limit, 2)
    tau = torch.clamp(tau, -tau_limit, tau_limit)

    p_world, p_body, jac, r_wb = foot_positions_world(params, state)
    r_bw = r_wb.transpose(-1, -2)

    # foot world velocities: body motion + joint motion
    qd = state.qd.reshape(b, 4, 3)
    v_joint_body = torch.einsum('blij,blj->bli', jac, qd)
    rel = p_world - state.pos[:, None, :]
    v_foot = (state.v[:, None, :]
              + torch.linalg.cross(state.omega[:, None, :], rel, dim=-1)
              + v_joint_body @ r_bw)

    f_contact, in_contact, anchor = _contact_force(
        cfg, ter, p_world, v_foot, state.anchor, state.contact)  # (B,4,3)

    # --- trunk dynamics -------------------------------------------------
    mass = _env(params.body_mass, 2)
    g_vec = _gravity(state.pos)
    force = f_contact.sum(dim=1) + g_vec * mass
    torque = torch.linalg.cross(rel, f_contact, dim=-1).sum(dim=1)
    inertia_w = r_wb @ params.body_inertia @ r_bw
    inv_inertia_w = (r_wb @ torch.linalg.inv_ex(params.body_inertia).inverse
                     @ r_bw)
    gyro = torch.linalg.cross(
        state.omega, (inertia_w @ state.omega[..., None])[..., 0], dim=-1)
    vdot0 = force / mass
    omdot0 = (inv_inertia_w @ (torque - gyro)[..., None])[..., 0]

    # joint-space contact pullback (shared by both branches)
    f_body = f_contact @ r_wb  # world->body
    tau_contact = torch.einsum('blji,blj->bli', jac, f_body).reshape(b, 12)

    joint_inertia = _env(cfg.joint_inertia, 2)
    joint_damping = _env(cfg.joint_damping, 2)
    joint_friction = _env(cfg.joint_friction, 2)
    if cfg.leg_coupling:
        # ---- leg-inertia coupling (momentum-consistent explicit) --------
        # Composite point mass m_l per leg at p_l = hip + c*(foot - hip)
        # (so J_p = c * J_foot):
        #   1. joints integrate FIRST, loaded by the leg's rigid-ride
        #      inertia/gravity through J_p^T,
        #   2. the trunk then receives each swing leg's reaction as the
        #      momentum the joints just imparted to the leg mass,
        #      -m_l * c * R * J * (qd_new - qd) / dt, clamped and low-passed.
        #      Stance legs couple only through the rigid-ride term: their
        #      contact force already acts on the trunk directly.
        # Dropped: Jdot*qd and per-link rotational inertia; a_rigid uses the
        # pass-1 (SRB) trunk accels.
        m_leg = _env(cfg.leg_mass_frac, 3) * _env(params.body_mass, 3)
        c = _env(cfg.leg_com_frac, 3)
        hips_w_rel = hip_locations(params.abad_location) @ r_bw  # (B,4,3)
        r_p = hips_w_rel + c * (rel - hips_w_rel)
        v_rel_w = c * (v_joint_body @ r_bw)
        # leg-point acceleration relative to the trunk's LINEAR accel
        om = state.omega[:, None, :]
        a_nov = (torch.linalg.cross(omdot0[:, None, :], r_p, dim=-1)
                 + torch.linalg.cross(om, torch.linalg.cross(om, r_p, dim=-1),
                                      dim=-1)
                 + 2.0 * torch.linalg.cross(om, v_rel_w, dim=-1))
        f_ride = m_leg * (g_vec - vdot0[:, None, :] - a_nov)  # (B,4,3)

        # joints: rigid-ride inertia + gravity load through J_p^T
        tau_ride = (c * torch.einsum('blji,blj->bli', jac, f_ride @ r_wb)
                    ).reshape(b, 12)
        qdd_c = (tau + tau_contact + tau_ride - joint_friction
                 * torch.tanh(state.qd * 10.0)) / joint_inertia
        qd_new = (state.qd + dt * qdd_c) / (
            1.0 + dt * joint_damping / joint_inertia)
        dqd = (qd_new - state.qd).reshape(b, 4, 3)
        dt3 = _env(cfg.dt, 3)
        a_joint_w = (c / dt3) * torch.einsum('blij,blj->bli', jac, dqd) @ r_bw
        swing = (1.0 - in_contact.to(torch.float32))[..., None]

        # trunk-side reaction: the SWING legs' realised acceleration
        # momentum pushed back, clamped to a physical bound and low-passed.
        # The rigid-ride / gravity reaction stays on the joint side only:
        # applied explicitly to the trunk it destabilises the integrator.
        f_raw = -m_leg * a_joint_w * swing
        lim = _env(cfg.leg_force_limit, 3) * m_leg * GRAVITY
        f_raw = torch.clamp(f_raw, -lim, lim)
        f_lp = state.f_leg + (dt3 / _env(cfg.leg_force_tau, 3)) * (
            f_raw - state.f_leg)

        force_t = force + f_lp.sum(dim=1)
        torque_t = torque + torch.linalg.cross(r_p, f_lp, dim=-1).sum(dim=1)
        v = state.v + dt * force_t / mass
        omega = state.omega + dt * (
            inv_inertia_w @ (torque_t - gyro)[..., None])[..., 0]
    else:
        f_lp = state.f_leg
        v = state.v + dt * vdot0
        omega = state.omega + dt * omdot0
    pos = state.pos + dt * v

    # quaternion integration q' = q + dt/2 * omega_quat * q
    qw, qx, qy, qz = state.quat.unbind(-1)
    x, y, z = omega.unbind(-1)
    w = torch.zeros_like(x)
    dq = 0.5 * torch.stack([
        w * qw - x * qx - y * qy - z * qz,
        w * qx + x * qw + y * qz - z * qy,
        w * qy - x * qz + y * qw + z * qx,
        w * qz + x * qy - y * qx + z * qw,
    ], dim=-1)
    quat = state.quat + dt * dq
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)

    # --- joint dynamics -------------------------------------------------
    # ground force on the foot pulled back through the leg Jacobian:
    # I_j qdd = tau_motor + J^T f_foot - damping. (With leg_coupling the
    # joints were already integrated above, with the leg load included.)
    if not cfg.leg_coupling:
        qdd = (tau + tau_contact - joint_friction
               * torch.tanh(state.qd * 10.0)) / joint_inertia
        # implicit viscous joint damping: qd' = (qd+dt*qdd) / (1+dt*b/I)
        qd_new = (state.qd + dt * qdd) / (
            1.0 + dt * joint_damping / joint_inertia)
    q_new = torch.clamp(state.q + dt * qd_new, _env(cfg.q_min, 2),
                        _env(cfg.q_max, 2))

    return PhysState(pos=pos, quat=quat, v=v, omega=omega, q=q_new,
                     qd=qd_new, anchor=anchor,
                     contact=in_contact, f_leg=f_lp), f_contact, in_contact


def step(params: RobotParams, cfg: PhysicsConfig, ter, state: PhysState,
         tau):
    """One 100 Hz control-period step = cfg.substeps substeps.

    Returns (new state, last-substep foot contact forces (B,4,3), contact
    mask (B,4))."""
    fc = torch.zeros_like(state.f_leg)
    ic = torch.zeros_like(state.contact)
    for _ in range(cfg.substeps):
        state, fc, ic = substep(params, cfg, ter, state, tau)
    return state, fc, ic


def root_state_vector(state: PhysState):
    """(B,13) root state in the layout the controller consumes:
    [pos(3), quat xyzw(4), linvel(3), angvel(3)]."""
    return torch.cat([state.pos, state.quat[:, 1:4], state.quat[:, 0:1],
                      state.v, state.omega], dim=-1)


def body_contact_points(params: RobotParams, state: PhysState):
    """World positions (B,8,3) of the trunk corners and knees, for
    collision checks. Knee = hip + upper-link endpoint; trunk corners from
    the abad footprint."""
    r_wb = rot.quat_to_rot(state.quat).transpose(-1, -2)
    hips = hip_locations(params.abad_location)
    q = state.q.reshape(-1, 4, 3)
    # knee position: rotate hip link by abad roll + hip pitch
    s1, c1 = torch.sin(q[..., 0]), torch.cos(q[..., 0])
    s2, c2 = torch.sin(q[..., 1]), torch.cos(q[..., 1])
    l1 = params.abad_link_length[..., None]
    l2 = params.hip_link_length[..., None]
    dy = l1 * side_sign(q.device)
    knee_body = hips + torch.stack([
        -l2 * s2, dy * c1 + l2 * c2 * s1, dy * s1 - l2 * c1 * c2], dim=-1)
    corner = torch.zeros_like(hips)
    corner[..., 2] = -0.05
    trunk_corners = (hips + corner).expand_as(knee_body)
    pts_body = torch.cat([trunk_corners, knee_body], dim=-2)  # (B,8,3)
    return state.pos[:, None, :] + pts_body @ r_wb.transpose(-1, -2)
