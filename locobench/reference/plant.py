"""Plain reference of the articulated 18-DoF plant on flat ground: the
floating trunk and 4x3 revolute joints, H(q) du = Q - Hdot u - ad*_u(H u)
+ [0, 0, dT/dq], semi-implicit Euler with implicit joint damping, stick-slip
penalty contacts at the feet, ``substeps`` substeps a control tick.

A frozen copy of the program's plain path, in the dtype of its inputs (the
benchmark runs it in float64), with the link masses, inertias and joint
frames parsed from the configuration's own copy of the URDF. It imports
nothing of the program. Beside the next state it returns, per robot, the
smallest margin by which a discrete decision of the step was taken (a foot's
penetration against 0, its tangential force against the friction cone), so
that the comparison can tell an answer that sits on such an edge.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import NamedTuple

import numpy as np
import torch

from .controller import quat_to_rot, skew

GRAVITY = 9.81
NU = 18


class State(NamedTuple):
    pos: torch.Tensor
    quat: torch.Tensor       # (B,4) wxyz, body->world
    v: torch.Tensor
    omega: torch.Tensor
    q: torch.Tensor
    qd: torch.Tensor
    anchor: torch.Tensor     # (B,4,2)
    contact: torch.Tensor    # (B,4) bool
    f_leg: torch.Tensor      # (B,4,3), passes through


class Model(NamedTuple):
    trunk_mass: torch.Tensor
    trunk_com: torch.Tensor
    trunk_inertia: torch.Tensor
    joint_origin: torch.Tensor   # (4,3,3)
    joint_axis: torch.Tensor     # (4,3,3)
    link_mass: torch.Tensor      # (4,3)
    link_com: torch.Tensor       # (4,3,3)
    link_inertia: torch.Tensor   # (4,3,3,3)
    foot_offset: torch.Tensor    # (4,3)
    armature: float


def _inertial(link):
    i = link.find("inertial")
    if i is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    o = i.find("origin")
    com = (np.array([float(v) for v in o.get("xyz").split()])
           if o is not None and o.get("xyz") else np.zeros(3))
    a = i.find("inertia").attrib
    g = lambda k: float(a.get(k, 0))  # noqa: E731
    return (float(i.find("mass").get("value")), com,
            np.array([[g("ixx"), g("ixy"), g("ixz")],
                      [g("ixy"), g("iyy"), g("iyz")],
                      [g("ixz"), g("iyz"), g("izz")]]))


def _merge(parent, child, origin):
    """A fixed-joint child merged into its parent (parallel-axis theorem)."""
    m1, c1, i1 = parent
    m2, c2, i2 = child
    c2 = origin + c2
    m = m1 + m2
    if m == 0:
        return parent
    c = (m1 * c1 + m2 * c2) / m

    def shift(i_mat, mm, d):
        return i_mat + mm * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, c, shift(i1, m1, c1 - c) + shift(i2, m2, c2 - c)


def model_from_urdf(path: str, armature: float, dtype, device) -> Model:
    """Trunk and leg links of a Unitree URDF, fixed children (rotors, feet)
    merged into their parents, legs in the controller's order FL FR RL RR."""
    root = ET.parse(path).getroot()
    links = {l.get("name"): _inertial(l) for l in root.iter("link")
             if l.get("name")}
    joints = {}
    for j in root.iter("joint"):
        if j.get("name") is None or j.get("type") is None:
            continue
        o, a = j.find("origin"), j.find("axis")
        joints[j.get("name")] = dict(
            type=j.get("type"),
            origin=(np.array([float(v) for v in o.get("xyz").split()])
                    if o is not None and o.get("xyz") else np.zeros(3)),
            axis=(np.array([float(v) for v in a.get("xyz").split()])
                  if a is not None else np.array([1.0, 0, 0])),
            parent=j.find("parent").get("link"),
            child=j.find("child").get("link"))
    merged = dict(links)
    parents = {j["parent"] for j in joints.values()}
    fixed = sorted((j for j in joints.values() if j["type"] == "fixed"),
                   key=lambda j: 0 if j["child"] not in parents else 1)
    for j in fixed:
        if j["child"] in merged and j["parent"] in merged:
            merged[j["parent"]] = _merge(merged[j["parent"]],
                                         merged[j["child"]], j["origin"])
    jo, ja = np.zeros((4, 3, 3)), np.zeros((4, 3, 3))
    lm, lc, li = np.zeros((4, 3)), np.zeros((4, 3, 3)), np.zeros((4, 3, 3, 3))
    foot = np.zeros((4, 3))
    for k, leg in enumerate(("FL", "FR", "RL", "RR")):
        for i, part in enumerate(("hip", "thigh", "calf")):
            j = joints[f"{leg}_{part}_joint"]
            jo[k, i], ja[k, i] = j["origin"], j["axis"]
            lm[k, i], lc[k, i], li[k, i] = merged[j["child"]]
        foot[k] = joints[f"{leg}_foot_fixed"]["origin"]
    tm, tc, ti = merged["trunk"]

    def t(x):
        return torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                            device=device)

    return Model(t(tm), t(tc), t(ti), t(jo), t(ja), t(lm), t(lc), t(li),
                 t(foot), float(armature))


def _mv(m, v):
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def _axis_rot(axis, angle):
    k = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    kx = skew(k)
    s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None, None]
    return torch.eye(3, dtype=kx.dtype, device=kx.device) + s * kx + (1.0 - c) * (kx @ kx)


def kinematics(model: Model, q):
    """Per-link rotations, joint origins and axes, link COMs and feet, all
    in the trunk frame."""
    b = q.shape[0]
    qr = q.reshape(b, 4, 3)
    rj = _axis_rot(model.joint_axis.expand(b, 4, 3, 3), qr)
    r0 = rj[:, :, 0]
    r1 = r0 @ rj[:, :, 1]
    r2 = r1 @ rj[:, :, 2]
    rs = torch.stack([r0, r1, r2], dim=2)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand_as(r0)
    parent = torch.stack([eye, r0, r1], dim=2)
    a = _mv(parent, model.joint_axis)
    o = torch.cumsum(_mv(parent, model.joint_origin), dim=2)
    return dict(R=rs, o=o, a=a, com=o + _mv(rs, model.link_com),
                foot=o[:, :, 2] + _mv(r2, model.foot_offset))


def _place(cols):
    leg_block = torch.eye(4, dtype=cols.dtype, device=cols.device)[:, None, None, :, None]
    return (cols.transpose(-1, -2).unsqueeze(-2) * leg_block).flatten(-2)


def _cols(kin, p, moves):
    rel = p.unsqueeze(3) - kin["o"].unsqueeze(2)
    return torch.linalg.cross(kin["a"].unsqueeze(2), rel, dim=-1) * moves


def _bodies(model: Model, kin, b, like):
    dt, dev = like.dtype, like.device
    lower = torch.tril(torch.ones((3, 3), dtype=dt, device=dev))[..., None]
    eye3 = torch.eye(3, dtype=dt, device=dev)
    cols = _cols(kin, kin["com"], lower)
    eye = eye3.expand(b, 4, 3, 3, 3)
    jv_links = torch.cat([eye, -skew(kin["com"]), _place(cols)], dim=-1)
    a = kin["a"].unsqueeze(2) * lower
    jw_links = torch.cat([torch.zeros_like(eye), eye, _place(a)], dim=-1)
    jv_trunk = torch.cat([eye3.expand(b, 3, 3),
                          -skew(model.trunk_com).expand(b, 3, 3),
                          like.new_zeros((b, 3, 12))], dim=-1)
    trunk_w = torch.zeros((3, NU), dtype=dt, device=dev)
    trunk_w[:, 3:6] = eye3
    r = kin["R"]
    i_links = r @ model.link_inertia @ r.mT
    return dict(
        masses=torch.cat([model.trunk_mass.expand(b, 1),
                          model.link_mass.reshape(1, 12).expand(b, 12)], dim=1),
        jv=torch.cat([jv_trunk[:, None], jv_links.reshape(b, 12, 3, NU)], 1),
        jw=torch.cat([trunk_w.expand(b, 1, 3, NU),
                      jw_links.reshape(b, 12, 3, NU)], 1),
        inertia=torch.cat([model.trunk_inertia.expand(b, 1, 3, 3),
                           i_links.reshape(b, 12, 3, 3)], 1),
        cols=cols, lower=lower[..., 0])


def _mass_matrix(model: Model, bodies, like):
    b = like.shape[0]
    j = torch.cat([bodies["jv"], bodies["jw"]], dim=2).reshape(b, 13 * 6, NU)
    mj = torch.cat([bodies["masses"][..., None, None] * bodies["jv"],
                    bodies["inertia"] @ bodies["jw"]], dim=2).reshape(b, 13 * 6, NU)
    diag = torch.cat([like.new_zeros((b, 6)),
                      like.new_full((b, 12), model.armature)], dim=1)
    return j.mT @ mj + torch.diag_embed(diag)


def srb_equivalent(model: Model, q):
    """Composite mass (B,) and inertia about the composite COM (B,3,3) at
    poses q (B,12): the SRB the controller's MPC assumes."""
    b = q.shape[0]
    kin = kinematics(model, q)
    bodies = _bodies(model, kin, b, q)
    coms = torch.cat([model.trunk_com.expand(b, 1, 3),
                      kin["com"].reshape(b, 12, 3)], dim=1)
    masses = bodies["masses"]
    m_tot = masses.sum(dim=1)
    com = (masses[..., None] * coms).sum(dim=1) / m_tot[:, None]
    d = coms - com[:, None]
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device)
    shift = (d * d).sum(-1)[..., None, None] * eye3 - d[..., :, None] * d[..., None, :]
    return m_tot, (bodies["inertia"] + masses[..., None, None] * shift).sum(dim=1)


def _bias(kin, bodies, u):
    """(Hdot u, dT/dq) in closed form."""
    b = u.shape[0]
    cross = torch.linalg.cross
    lower = bodies["lower"]
    link_mass = bodies["masses"][:, 1:].reshape(b, 4, 3, 1)
    inertia = bodies["inertia"][:, 1:].reshape(b, 4, 3, 3, 3)
    cols, a, p = bodies["cols"], kin["a"], kin["com"]
    v_b, w_b = u[:, None, None, 0:3], u[:, None, None, 3:6]
    qd = u[:, 6:].reshape(b, 4, 3, 1)
    qa = qd * a
    omega = torch.cumsum(qa, dim=2)
    qc = qd.unsqueeze(2) * cols
    p_in = torch.cumsum(qc, dim=3)
    pdot = p_in[:, :, :, 2]
    w = w_b + omega
    lin = link_mass * (v_b + cross(w_b, p, dim=-1) + pdot)
    ang = _mv(inertia, w)
    a_j, om_j = a.unsqueeze(2), omega.unsqueeze(2)
    jv_dot = cross(om_j, cols, dim=-1) + cross(a_j, pdot.unsqueeze(3) - p_in, dim=-1)
    jw_dot = cross(omega, a, dim=-1)
    f = link_mass * (cross(w_b, pdot, dim=-1)
                     + (qd.unsqueeze(2) * jv_dot).sum(dim=3))
    g = (cross(omega, ang, dim=-1) - _mv(inertia, cross(omega, w, dim=-1))
         + _mv(inertia, torch.cumsum(qd * jw_dot, dim=2)))
    h_joint = ((jv_dot * lin.unsqueeze(3)).sum(-1)
               + (cols * f.unsqueeze(3)).sum(-1)
               + lower * ((jw_dot.unsqueeze(2) * ang.unsqueeze(3)).sum(-1)
                          + (a_j * g.unsqueeze(3)).sum(-1))).sum(dim=2)
    hdot_u = torch.cat([
        f.sum(dim=(1, 2)),
        (cross(pdot, lin, dim=-1) + cross(p, f, dim=-1) + g).sum(dim=(1, 2)),
        h_joint.reshape(b, 12)], dim=1)
    dv = (cross(w_b.unsqueeze(3) + (omega - qa).unsqueeze(2), cols, dim=-1)
          + cross(a_j, pdot.unsqueeze(3) - (p_in - qc), dim=-1))
    dw = (a_j * cross((w_b + omega).unsqueeze(2), ang.unsqueeze(3), dim=-1)).sum(-1)
    dtdq = ((dv * lin.unsqueeze(3)).sum(-1) - lower * dw).sum(dim=2)
    return hdot_u, dtdq.reshape(b, 12)


def _contact(cfg: dict, p_w, v_w, anchor, was_contact):
    """Stick-slip penalty contact on flat ground (height 0). Returns (force
    (B,4,3), in contact (B,4), anchor (B,4,2), margin (B,)): the margin is
    the least of |penetration| over the feet and, for a foot in contact,
    |tangential force - its Coulomb limit| (N) scaled by 1/kt to metres."""
    kn, cn, kt, ct, mu = (cfg["contact_kn"], cfg["contact_cn"],
                          cfg["contact_kt"], cfg["contact_ct"], cfg["friction_mu"])
    pen = 0.0 * p_w[..., 0] - p_w[..., 2]
    in_contact = pen > 0.0
    fz = torch.where(in_contact, torch.clamp_min(kn * pen - cn * v_w[..., 2], 0.0), 0.0)
    xy = p_w[..., :2]
    fresh = torch.logical_or(~was_contact, ~in_contact)
    anchor = torch.where(fresh[..., None], xy, anchor)
    ft = -kt * (xy - anchor) - ct * v_w[..., :2]
    ft_norm = torch.linalg.vector_norm(ft, dim=-1, keepdim=True)
    ft_max = mu * fz[..., None]
    over = ft_norm > torch.clamp_min(ft_max, 1e-9)
    ft_c = torch.where(over, ft * ft_max / torch.clamp_min(ft_norm, 1e-9), ft)
    anchor = torch.where(torch.logical_and(over, in_contact[..., None]),
                         xy + ft_c / kt, anchor)
    ft_c = torch.where(in_contact[..., None], ft_c, 0.0)
    slip_margin = torch.where(in_contact, (ft_norm - ft_max)[..., 0].abs() / kt,
                              torch.full_like(pen, float("inf")))
    margin = torch.minimum(pen.abs(), slip_margin).amin(dim=-1)
    return torch.cat([ft_c, fz[..., None]], dim=-1), in_contact, anchor, margin


def substep(model: Model, cfg: dict, state: State, tau):
    b = state.pos.shape[0]
    dt = cfg["dt"]
    tau = torch.clamp(tau, -cfg["tau_limit"], cfg["tau_limit"])
    r_wb = quat_to_rot(state.quat).mT
    r_bw = r_wb.mT
    kin = kinematics(model, state.q)
    u = torch.cat([_mv(r_bw, state.v), _mv(r_bw, state.omega), state.qd], dim=1)
    ones = torch.ones((1, 3, 1), dtype=u.dtype, device=u.device)
    foot_b = kin["foot"]
    eye = torch.eye(3, dtype=u.dtype, device=u.device).expand(b, 4, 3, 3)
    jv_feet = torch.cat([eye, -skew(foot_b),
                         _place(_cols(kin, foot_b[:, :, None], ones))[:, :, 0]],
                        dim=-1)                                   # (B,4,3,18)
    foot_w = state.pos[:, None, :] + foot_b @ r_wb.mT
    v_foot_w = _mv(jv_feet, u[:, None]) @ r_wb.mT
    f_contact, in_contact, anchor, margin = _contact(
        cfg, foot_w, v_foot_w, state.anchor, state.contact)
    f_b = f_contact @ r_wb
    bodies = _bodies(model, kin, b, u)
    g_w = torch.tensor([0.0, 0.0, -GRAVITY], dtype=u.dtype, device=u.device)
    g_b = _mv(r_bw, g_w.expand(b, 3))
    q_forces = (_mv((bodies["masses"][..., None, None] * bodies["jv"]).sum(dim=1).mT, g_b)
                + _mv(jv_feet.mT, f_b).sum(dim=1))
    tau_j = tau - cfg["joint_friction"] * torch.tanh(state.qd * 10.0)
    q_forces = q_forces + torch.cat([u.new_zeros((b, 6)), tau_j], dim=1)
    h_mat = _mass_matrix(model, bodies, u)
    hdot_u, dtdq = _bias(kin, bodies, u)
    hu = _mv(h_mat, u)
    v, w = u[:, 0:3], u[:, 3:6]
    cross = torch.linalg.cross
    bias = torch.cat([cross(w, hu[:, 0:3], dim=-1),
                      cross(w, hu[:, 3:6], dim=-1) + cross(v, hu[:, 0:3], dim=-1),
                      u.new_zeros((b, 12))], dim=1)
    rhs = q_forces - hdot_u - bias + torch.cat([u.new_zeros((b, 6)), dtdq], dim=1)
    d_diag = torch.cat([u.new_zeros((b, 6)),
                        cfg["joint_damping"] * torch.ones_like(state.qd)], dim=1)
    du = torch.linalg.solve(h_mat + dt * torch.diag_embed(d_diag),
                            dt * (rhs - d_diag * u))
    u_new = u + du
    qw, qx, qy, qz = state.quat.unbind(-1)
    x, y, z = _mv(r_wb, u_new[:, 3:6]).unbind(-1)
    dq = 0.5 * torch.stack([-x * qx - y * qy - z * qz,
                            x * qw + y * qz - z * qy,
                            -x * qz + y * qw + z * qx,
                            x * qy - y * qx + z * qw], dim=-1)
    quat = state.quat + dt * dq
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    r_new = quat_to_rot(quat).mT
    v_w = _mv(r_new, u_new[:, 0:3])
    q_new = torch.clamp(state.q + dt * u_new[:, 6:], cfg["q_min"], cfg["q_max"])
    return state._replace(pos=state.pos + dt * v_w, quat=quat, v=v_w,
                          omega=_mv(r_new, u_new[:, 3:6]), q=q_new,
                          qd=u_new[:, 6:], anchor=anchor,
                          contact=in_contact), margin


def step(model: Model, cfg: dict, state: State, tau):
    """One control tick of the plant: ``substeps`` substeps under the same
    torques. Returns (next state, the least decision margin (B,) in m)."""
    margin = torch.full((state.pos.shape[0],), float("inf"),
                        dtype=state.pos.dtype, device=state.pos.device)
    for _ in range(cfg["substeps"]):
        state, m = substep(model, cfg, state, tau)
        margin = torch.minimum(margin, m)
    return state, margin


def root_state(state: State):
    """(B,13) [pos, quat xyzw, v, omega], the controller's input layout."""
    return torch.cat([state.pos, state.quat[:, 1:4], state.quat[:, 0:1],
                      state.v, state.omega], dim=-1)


def init_state(q0, height, dtype, device) -> State:
    b = q0.shape[0]
    z = torch.zeros((b,), dtype=dtype, device=device)
    quat = torch.zeros((b, 4), dtype=dtype, device=device)
    quat[:, 0] = 1.0
    return State(pos=torch.stack([z, z, z + height], dim=-1), quat=quat,
                 v=torch.zeros((b, 3), dtype=dtype, device=device),
                 omega=torch.zeros((b, 3), dtype=dtype, device=device),
                 q=q0.to(dtype).clone(),
                 qd=torch.zeros((b, 12), dtype=dtype, device=device),
                 anchor=torch.zeros((b, 4, 2), dtype=dtype, device=device),
                 contact=torch.zeros((b, 4), dtype=torch.bool, device=device),
                 f_leg=torch.zeros((b, 4, 3), dtype=dtype, device=device))
