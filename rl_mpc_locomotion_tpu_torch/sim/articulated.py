"""Articulated 18-DoF quadruped dynamics (floating trunk + 4x3 revolute
joints): the third physics-fidelity tier, for a batch of robots.

Counterpart of ``rl_mpc_locomotion_tpu/sim/articulated.py``, with the same
names and argument orders, written batched: ``q`` is (B,12), the generalized
velocity ``u`` is (B,18), the mass matrix ``H`` is (B,18,18). A field of
``ArticulatedParams`` is either shared by the batch (one robot kind, the
shapes below) or carries a leading (B,) axis (a stacked batch of kinds),
as ``RobotParams``'s fields do. The functions follow the input's dtype, so
they run in float64 as well as float32.

Formulation (one dense 18x18 solve per robot and substep, no per-joint
recursion): with u = (v_body, omega_body, qd) in the TRUNK frame the kinetic
energy is T = 1/2 u^T H(q) u, H depending only on the joint angles, and the
Euler-Poincare / Hamel equations are

    H(q) du = Q - Hdot(q, qd) u - ad*_u (H u) + [0, 0, dT/dq]

where ad*_(v,w)(p_lin, p_ang) = (w x p_lin, w x p_ang + v x p_lin) acts on
the base rows only. H is assembled from closed-form geometric Jacobians of
13 bodies (trunk + 4 legs x {hip, thigh, calf}), all links of all legs at
once: a point on link i of a leg moves with joints 0..i of that leg (a
lower-triangular joint mask), and H is one product J^T M J over the
stacked bodies. The JAX package takes ``Hdot u`` and ``dT/dq`` by AD
(``jax.jvp`` / ``jax.grad``) through the same assembly; here they are its
derivatives in closed form (``_bias``: how a joint angle moves the axes,
origins, Jacobian columns and inertias of the links below it), exact, no
finite differences, at a fifth of the operations of ``torch.func``'s AD
(the tests hold them against both).

Link masses, inertias and joint frames are parsed from the vendored Unitree
URDFs (assets/{a1,go1,aliengo}.urdf) with fixed-joint children (rotors,
feet) merged into their parents by the parallel-axis theorem. Contact uses
the stick-slip penalty model of the point-mass plant
(``physics._contact_force``) at the feet, through their 3x18 Jacobians.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import NamedTuple

import numpy as np
import torch

from ..models.robots import RobotParams
from ..ops import rotations as rot

NU = 18  # v(3) + omega(3) + qd(12)


class ArticulatedParams(NamedTuple):
    """Articulated model, trunk-frame joint chains; each field shared or
    with a leading (B,) axis.

    Leg order matches the controller's (FL, FR, RL, RR: SIDE_SIGN
    [+1,-1,+1,-1]); link order per leg: hip (abad), thigh, calf.
    """
    trunk_mass: torch.Tensor      # ()
    trunk_com: torch.Tensor       # (3,) in trunk frame
    trunk_inertia: torch.Tensor   # (3,3) about trunk COM
    joint_origin: torch.Tensor    # (4,3,3) joint j origin in parent frame
    joint_axis: torch.Tensor      # (4,3,3) joint j axis in its own frame
    link_mass: torch.Tensor       # (4,3)
    link_com: torch.Tensor        # (4,3,3) COM in link frame
    link_inertia: torch.Tensor    # (4,3,3,3) about COM, link frame
    foot_offset: torch.Tensor     # (4,3) foot point in calf frame
    armature: torch.Tensor        # () reflected rotor inertia per joint


# rank of every field for one robot kind (without a batch axis)
ART_RANKS = dict(trunk_mass=0, trunk_com=1, trunk_inertia=2, joint_origin=3,
                 joint_axis=3, link_mass=2, link_com=3, link_inertia=4,
                 foot_offset=2, armature=0)


# ---------------------------------------------------------------------------
# URDF -> ArticulatedParams
# ---------------------------------------------------------------------------

def _parse_inertial(link_el):
    i = link_el.find("inertial")
    if i is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    m = float(i.find("mass").get("value"))
    o = i.find("origin")
    com = (np.array([float(v) for v in o.get("xyz").split()])
           if o is not None and o.get("xyz") else np.zeros(3))
    a = i.find("inertia").attrib
    ine = np.array([
        [float(a["ixx"]), float(a.get("ixy", 0)), float(a.get("ixz", 0))],
        [float(a.get("ixy", 0)), float(a["iyy"]), float(a.get("iyz", 0))],
        [float(a.get("ixz", 0)), float(a.get("iyz", 0)), float(a["izz"])],
    ])
    return m, com, ine


def _merge_fixed(parent, child, child_origin):
    """Merge a fixed-joint child body into its parent (composite body):
    combined mass, COM, and inertia about the combined COM (parallel
    axis; URDF fixed joints here have identity rpy)."""
    m1, c1, i1 = parent
    m2, c2_local, i2 = child
    c2 = child_origin + c2_local
    m = m1 + m2
    if m == 0:
        return parent
    c = (m1 * c1 + m2 * c2) / m

    def shift(i_mat, mm, d):
        return i_mat + mm * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, c, shift(i1, m1, c1 - c) + shift(i2, m2, c2 - c)


def _params_numpy(path: str, armature: float):
    """The model's fields as float32 numpy arrays, parsed in float64."""
    root = ET.parse(path).getroot()
    links = {l.get("name"): _parse_inertial(l) for l in root.iter("link")
             if l.get("name")}
    joints = {}
    for j in root.iter("joint"):
        n = j.get("name")
        if n is None or j.get("type") is None:
            continue
        o = j.find("origin")
        xyz = (np.array([float(v) for v in o.get("xyz").split()])
               if o is not None and o.get("xyz") else np.zeros(3))
        a = j.find("axis")
        axis = (np.array([float(v) for v in a.get("xyz").split()])
                if a is not None else np.array([1.0, 0, 0]))
        joints[n] = {"type": j.get("type"), "origin": xyz, "axis": axis,
                     "parent": j.find("parent").get("link"),
                     "child": j.find("child").get("link")}

    # merge fixed-joint children bottom-up (rotors, feet): child links
    # that parent nothing are leaves and merge first
    merged = dict(links)
    fixed = [j for j in joints.values() if j["type"] == "fixed"]
    parents = {j["parent"] for j in joints.values()}
    fixed.sort(key=lambda j: 0 if j["child"] not in parents else 1)
    for j in fixed:
        if j["child"] not in merged or j["parent"] not in merged:
            continue
        merged[j["parent"]] = _merge_fixed(
            merged[j["parent"]], merged[j["child"]], j["origin"])

    legs = ["FL", "FR", "RL", "RR"]  # controller order: left legs even
    jo = np.zeros((4, 3, 3))
    ja = np.zeros((4, 3, 3))
    lm = np.zeros((4, 3))
    lc = np.zeros((4, 3, 3))
    li = np.zeros((4, 3, 3, 3))
    foot = np.zeros((4, 3))
    for k, leg in enumerate(legs):
        chain = [f"{leg}_hip_joint", f"{leg}_thigh_joint",
                 f"{leg}_calf_joint"]
        for i, jn in enumerate(chain):
            j = joints[jn]
            jo[k, i] = j["origin"]
            ja[k, i] = j["axis"]
            m, c, ine = merged[j["child"]]
            lm[k, i] = m
            lc[k, i] = c
            li[k, i] = ine
        foot[k] = joints[f"{leg}_foot_fixed"]["origin"]

    tm, tc, ti = merged["trunk"]
    return [np.asarray(x, np.float64).astype(np.float32)
            for x in (tm, tc, ti, jo, ja, lm, lc, li, foot, armature)]


def _from_numpy(fields, device) -> ArticulatedParams:
    return ArticulatedParams(*[torch.tensor(x, device=device)
                               for x in fields])


def params_from_urdf(path: str, armature: float = 0.05, device="cpu"
                     ) -> ArticulatedParams:
    """Build the articulated model (shared, float32) from a vendored
    Unitree URDF.

    Rotor links (``*_rotor``) and the foot link are merged into their
    fixed-joint parents; the rotor gearing shows up instead as the
    ``armature`` reflected inertia on each joint.
    """
    return _from_numpy(_params_numpy(path, armature), device)


_ASSET_FILES = {"aliengo": "aliengo.urdf", "go1": "go1.urdf",
                "a1": "a1.urdf"}
# parsed models as numpy, keyed by (name, armature): every call makes
# tensors of its own on the caller's device
_CACHE: dict = {}


def for_robot(name: str, armature: float = 0.05, device="cpu"
              ) -> ArticulatedParams:
    """ArticulatedParams from the vendored asset for a registry robot name
    ('aliengo' | 'go1' | 'a1'), on ``device``."""
    key = (name, armature)
    if key not in _CACHE:
        asset_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "assets")
        _CACHE[key] = _params_numpy(
            os.path.join(asset_dir, _ASSET_FILES[name]), armature)
    return _from_numpy(_CACHE[key], device)


STAND_Q = (0.0, 0.8, -1.6)  # per leg: abad, hip, knee


def with_articulated(params: RobotParams, name: str,
                     armature: float = 0.05,
                     srb_match: bool = True) -> RobotParams:
    """RobotParams with the articulated model attached (RobotParams.art),
    on the parameters' device.

    ``srb_match=True`` also replaces the controller's SRB model constants
    (body_mass / body_inertia) with the articulated model's composite
    values at the stand pose (srb_equivalent): the reference's tuned
    constants describe an 18.1 kg Aliengo while the URDF plant weighs
    24.9 kg, and an MPC that underestimates the robot's weight by 27 %
    commands too little stance force."""
    device = params.body_mass.device
    art = for_robot(name, armature, device)
    params = params._replace(art=art)
    if srb_match:
        q_stand = torch.tensor(STAND_Q, dtype=torch.float32,
                               device=device).repeat(4)[None]
        m_tot, i_com, _ = srb_equivalent(art, q_stand)
        params = params._replace(body_mass=m_tot[0], body_inertia=i_com[0])
    return params


# ---------------------------------------------------------------------------
# kinematics + mass matrix (trunk frame)
# ---------------------------------------------------------------------------

_consts = {}


def _const(device, dtype):
    """Constant masks and frames of the assembly on ``device``, made once.

    - ``link_moves`` (3,3,1): joint j moves link i of its leg iff j <= i;
    - ``foot_moves`` (1,3,1): all three joints move the foot;
    - ``leg_block`` (4,1,1,4,1): places a leg's three joint columns at
      6 + 3 leg + j;
    - ``eye3``; ``trunk_w`` (3,18), the trunk's angular Jacobian [0, I, 0].
    """
    key = (str(device), dtype)
    if key not in _consts:
        kw = dict(device=device, dtype=dtype)
        lower = torch.tril(torch.ones((3, 3), **kw))
        eye3 = torch.eye(3, **kw)
        trunk_w = torch.zeros((3, NU), **kw)
        trunk_w[:, 3:6] = eye3
        _consts[key] = dict(
            link_moves=lower[..., None],
            foot_moves=torch.ones((1, 3, 1), **kw),
            leg_block=torch.eye(4, **kw)[:, None, None, :, None],
            eye3=eye3, trunk_w=trunk_w)
    return _consts[key]


def _batched(art: ArticulatedParams, b: int, like) -> ArticulatedParams:
    """Every field with a leading (b,) axis, in ``like``'s dtype and on
    its device (a shared field is expanded, not copied)."""
    out = []
    for (name, rank), x in zip(ART_RANKS.items(), art):
        x = torch.as_tensor(x).to(device=like.device, dtype=like.dtype)
        if x.dim() == rank:
            x = x.expand((b,) + tuple(x.shape))
        out.append(x)
    return ArticulatedParams(*out)


def _mv(m, v):
    """Matrix-vector product over leading batch axes."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def srb_equivalent(art: ArticulatedParams, q):
    """Composite-rigid-body reduction of the articulated model at poses q
    (B,12): total mass (B,), inertia about the composite COM (B,3,3) and the
    COM offset in the trunk frame (B,3) — the SRB the MPC's model assumes."""
    b = q.shape[0]
    kin = leg_kinematics(art, q)
    bodies = _bodies(art, kin, b, q)
    coms = torch.cat([_batched(art, b, q).trunk_com[:, None],
                      kin["com"].reshape(b, 12, 3)], dim=1)       # (B,13,3)
    masses = bodies.masses
    m_tot = masses.sum(dim=1)
    com = (masses[..., None] * coms).sum(dim=1) / m_tot[:, None]
    d = coms - com[:, None]
    shift = ((d * d).sum(-1)[..., None, None]
             * _const(q.device, q.dtype)["eye3"]
             - d[..., :, None] * d[..., None, :])
    i_com = (bodies.inertia + masses[..., None, None] * shift).sum(dim=1)
    return m_tot, i_com, com


def _axis_rot(axis, angle):
    """Rotation about an arbitrary axis (Rodrigues; the axis is
    normalised): axis (...,3), angle (...) -> (...,3,3)."""
    k = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    kx = _skew(k)
    s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=kx.dtype, device=kx.device)
    return eye + s * kx + (1.0 - c) * (kx @ kx)


def leg_kinematics(art: ArticulatedParams, q):
    """Per-leg chains in the trunk frame. q (B,12) in (leg, joint) order.

    Returns a dict with per-link frame rotations R (B,4,3,3,3), joint
    positions o (B,4,3,3), joint axes a (B,4,3,3) (trunk frame), link COM
    positions com (B,4,3,3), and foot positions (B,4,3).
    """
    b = q.shape[0]
    art = _batched(art, b, q)
    qr = q.reshape(b, 4, 3)
    rj = _axis_rot(art.joint_axis, qr)             # (B,4,3,3,3)
    r0 = rj[:, :, 0]
    r1 = r0 @ rj[:, :, 1]
    r2 = r1 @ rj[:, :, 2]
    rs = torch.stack([r0, r1, r2], dim=2)
    # the frame each joint's origin and axis are given in: trunk, r0, r1
    eye = _const(q.device, q.dtype)["eye3"].expand_as(r0)
    parent = torch.stack([eye, r0, r1], dim=2)
    a = _mv(parent, art.joint_axis)
    o = torch.cumsum(_mv(parent, art.joint_origin), dim=2)
    coms = o + _mv(rs, art.link_com)
    foot = o[:, :, 2] + _mv(r2, art.foot_offset)
    return {"R": rs, "o": o, "a": a, "com": coms, "foot": foot}


def _skew(v):
    return rot.skew(v)


def _place(cols):
    """(..., 4 legs, K, 3 joints, 3 xyz) joint columns -> (..., 4, K, 3,
    12): each leg's three columns at 3 leg + j, zeros elsewhere."""
    c = _const(cols.device, cols.dtype)
    placed = cols.transpose(-1, -2).unsqueeze(-2) * c["leg_block"]
    return placed.flatten(-2)


def _cols(kin, p, moves):
    """Joint columns a_j x (p - o_j) (B,4,K,3,3) of points p (B,4,K,3) on
    the legs; ``moves`` (K,3,1) is 1 where joint j of the leg moves point k,
    and the column is zero elsewhere."""
    rel = p.unsqueeze(3) - kin["o"].unsqueeze(2)              # (B,4,K,3,3)
    return torch.linalg.cross(kin["a"].unsqueeze(2), rel, dim=-1) * moves


def _leg_point_jacobians(kin, p, moves):
    """Linear-velocity Jacobians (B,4,K,3,18) of points p (B,4,K,3) on the
    legs (``moves`` as in ``_cols``)."""
    eye = _const(p.device, p.dtype)["eye3"].expand(p.shape + (3,))
    return torch.cat([eye, -_skew(p), _place(_cols(kin, p, moves))], dim=-1)


def point_jacobian(kin, leg: int, upto: int, p):
    """(B,3,18) linear-velocity Jacobian (trunk frame) of points p (B,3)
    attached to link ``upto`` of ``leg``: v_p = Jv @ u, u = (v_b, omega_b,
    qd)."""
    b = p.shape[0]
    moves = (torch.arange(3, device=p.device) <= upto).to(p.dtype)
    cols = torch.linalg.cross(kin["a"][:, leg], p[:, None] - kin["o"][:, leg],
                              dim=-1) * moves[:, None]           # (B,3j,3)
    joint = p.new_zeros((b, 3, 12))
    joint[:, :, 3 * leg:3 * leg + 3] = cols.mT
    eye = _const(p.device, p.dtype)["eye3"].expand(b, 3, 3)
    return torch.cat([eye, -_skew(p), joint], dim=-1)


class _Bodies(NamedTuple):
    """The 13 bodies (trunk first, then leg-major links) of a batch."""
    masses: torch.Tensor      # (B,13)
    jv: torch.Tensor          # (B,13,3,18) linear Jacobians of the COMs
    jw: torch.Tensor          # (B,13,3,18) angular Jacobians
    inertia: torch.Tensor     # (B,13,3,3) about the COM, trunk frame
    cols: torch.Tensor        # (B,4,3,3,3) the links' joint columns (_cols)


def _bodies(art: ArticulatedParams, kin, b, like) -> _Bodies:
    c = _const(like.device, like.dtype)
    art = _batched(art, b, like)
    cols = _cols(kin, kin["com"], c["link_moves"])
    eye = c["eye3"].expand(b, 4, 3, 3, 3)
    jv_links = torch.cat([eye, -_skew(kin["com"]), _place(cols)], dim=-1)
    a = kin["a"].unsqueeze(2) * c["link_moves"]               # (B,4,3,3,3)
    jw_links = torch.cat([torch.zeros_like(eye), eye, _place(a)], dim=-1)
    jv_trunk = torch.cat([
        c["eye3"].expand(b, 3, 3), -_skew(art.trunk_com),
        like.new_zeros((b, 3, 12))], dim=-1)
    r = kin["R"]
    i_links = r @ art.link_inertia @ r.mT
    return _Bodies(
        masses=torch.cat([art.trunk_mass[:, None],
                          art.link_mass.reshape(b, 12)], dim=1),
        jv=torch.cat([jv_trunk[:, None], jv_links.reshape(b, 12, 3, NU)], 1),
        jw=torch.cat([c["trunk_w"].expand(b, 1, 3, NU),
                      jw_links.reshape(b, 12, 3, NU)], 1),
        inertia=torch.cat([art.trunk_inertia[:, None],
                           i_links.reshape(b, 12, 3, 3)], 1),
        cols=cols)


def _mass_matrix(art: ArticulatedParams, bodies: _Bodies, like):
    """H = sum_k m_k Jv_k^T Jv_k + Jw_k^T I_k Jw_k (one product over the
    stacked bodies) + the armature on the joint diagonal."""
    b = like.shape[0]
    j = torch.cat([bodies.jv, bodies.jw], dim=2).reshape(b, 13 * 6, NU)
    mj = torch.cat([bodies.masses[..., None, None] * bodies.jv,
                    bodies.inertia @ bodies.jw], dim=2).reshape(b, 13 * 6, NU)
    arm = torch.as_tensor(art.armature).to(like)
    arm = arm.reshape(-1, 1) if arm.dim() == 1 else arm
    diag = torch.cat([like.new_zeros((b, 6)), arm.expand(b, 12)], dim=1)
    return j.mT @ mj + torch.diag_embed(diag)


def mass_matrix(art: ArticulatedParams, q):
    """H(q) (B,18,18): trunk-frame composite over 13 bodies + armature."""
    kin = leg_kinematics(art, q)
    return _mass_matrix(art, _bodies(art, kin, q.shape[0], q), q)


def _kinetic(art, q, u):
    """1/2 u^T H(q) u per robot (B,)."""
    return ((0.5 * u).unsqueeze(-2) @ mass_matrix(art, q)
            @ u.unsqueeze(-1))[..., 0, 0]


def _bias(kin, bodies: _Bodies, u):
    """(Hdot u, dT/dq) at u in closed form, for all links at once.

    Per leg, with joint axes a_j, the links' relative angular velocities
    W_j = sum_{m<=j} qd_m a_m and, for the COM p of link i, the joint
    columns c_ij = a_j x (p - o_j) (j <= i): a joint angle q_m moves a_j by
    a_m x a_j (m < j), p by c_im, c_ij by a_m x c_ij (m <= j) or a_j x c_im
    (j < m), and the link's trunk-frame inertia I by [a_m]x I - I [a_m]x.
    Differentiating H = sum_k J_k^T M_k J_k along qd gives Hdot u =
    Jdot^T (M J u) + J^T d/dt(M J u); differentiating T = sum_k 1/2 m |v_k|^2
    + 1/2 w_k . I w_k in q_m gives, with p_k = m v_k, L_k = I w_k and
    P_ij = sum_{m<=j} qd_m c_im,

        dT/dq_m = sum_{i>=m} p_i . ((w_b + W_{m-1}) x c_im
                                    + a_m x (pdot_i - P_i,m-1))
                             - a_m . ((w_b + W_m) x L_i).

    The same quantities as AD through the assembly (the JAX package's
    jvp / grad), in ~80 tensor operations instead of ~400.
    """
    b = u.shape[0]
    cross = torch.linalg.cross
    lower = _const(u.device, u.dtype)["link_moves"][..., 0]   # (i,j)
    link_mass = bodies.masses[:, 1:].reshape(b, 4, 3, 1)
    inertia = bodies.inertia[:, 1:].reshape(b, 4, 3, 3, 3)
    cols, a, p = bodies.cols, kin["a"], kin["com"]            # (B,4,i,j,3)
    v_b, w_b = u[:, None, None, 0:3], u[:, None, None, 3:6]   # (B,1,1,3)
    qd = u[:, 6:].reshape(b, 4, 3, 1)
    qa = qd * a
    omega = torch.cumsum(qa, dim=2)                           # W_j (B,4,j,3)
    qc = qd.unsqueeze(2) * cols                               # (B,4,i,j,3)
    p_in = torch.cumsum(qc, dim=3)                            # P_ij
    pdot = p_in[:, :, :, 2]                                   # (B,4,i,3)
    w = w_b + omega                                           # link i's
    lin = link_mass * (v_b + cross(w_b, p, dim=-1) + pdot)
    ang = _mv(inertia, w)
    a_j, om_j = a.unsqueeze(2), omega.unsqueeze(2)            # (B,4,1,j,3)

    # Hdot u = Jdot^T (lin, ang) + J^T (f, g)
    jv_dot = (cross(om_j, cols, dim=-1)
              + cross(a_j, pdot.unsqueeze(3) - p_in, dim=-1))
    jw_dot = cross(omega, a, dim=-1)                          # (B,4,j,3)
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

    # dT/dq
    dv = (cross(w_b.unsqueeze(3) + (omega - qa).unsqueeze(2), cols, dim=-1)
          + cross(a_j, pdot.unsqueeze(3) - (p_in - qc), dim=-1))
    dw = (a_j * cross((w_b + omega).unsqueeze(2), ang.unsqueeze(3),
                      dim=-1)).sum(-1)
    dtdq = ((dv * lin.unsqueeze(3)).sum(-1) - lower * dw).sum(dim=2)
    return hdot_u, dtdq.reshape(b, 12)


def _bias_terms(art, q, u):
    """(H, Hdot u, dT/dq) at (q, u)."""
    kin = leg_kinematics(art, q)
    bodies = _bodies(art, kin, q.shape[0], q)
    return (_mass_matrix(art, bodies, q),) + _bias(kin, bodies, u)


def _rhs(h_mat, hdot_u, dtdq, u, q_forces):
    """Q - Hdot u - ad*_u(H u) + [0, 0, dT/dq]."""
    hu = _mv(h_mat, u)
    v, w = u[:, 0:3], u[:, 3:6]
    cross = torch.linalg.cross
    bias = torch.cat([
        cross(w, hu[:, 0:3], dim=-1),
        cross(w, hu[:, 3:6], dim=-1) + cross(v, hu[:, 0:3], dim=-1),
        u.new_zeros((u.shape[0], 12))], dim=1)
    return q_forces - hdot_u - bias + torch.cat(
        [u.new_zeros((u.shape[0], 6)), dtdq], dim=1)


def dynamics_rhs(art: ArticulatedParams, q, u, q_forces):
    """H du/dt = rhs; returns (H (B,18,18), rhs (B,18)) for the
    Euler-Poincare equations.

    q_forces (B,18): generalized applied forces in the trunk frame
    (gravity, contacts, motor torques), EXCLUDING the bias terms computed
    here.
    """
    h_mat, hdot_u, dtdq = _bias_terms(art, q, u)
    return h_mat, _rhs(h_mat, hdot_u, dtdq, u, q_forces)


# ---------------------------------------------------------------------------
# substep (plugs into sim.physics.step via PhysicsConfig.articulated)
# ---------------------------------------------------------------------------

def substep(params: RobotParams, cfg, ter, state, tau):
    """One articulated substep for the batch, semi-implicit Euler with
    implicit joint damping: (H + dt D) u_new = H u + dt (Q + bias terms).

    Same signature and returns as physics.substep; ``f_leg`` passes
    through unchanged.
    """
    from . import physics  # shared contact model, state type and _env

    art = params.art
    if art is None:
        raise ValueError("RobotParams.art missing: attach the articulated "
                         "model with sim.articulated.with_articulated")
    env = physics._env
    b = state.pos.shape[0]
    dt, dt3 = env(cfg.dt, 2), env(cfg.dt, 3)
    tau_limit = env(cfg.tau_limit, 2)
    tau = torch.clamp(tau, -tau_limit, tau_limit)

    r_wb = rot.quat_to_rot(state.quat).mT    # body->world
    r_bw = r_wb.mT
    kin = leg_kinematics(art, state.q)
    u = torch.cat([_mv(r_bw, state.v), _mv(r_bw, state.omega), state.qd],
                  dim=1)

    # ---- contacts at the feet (world-frame penalty, shared model) ------
    c = _const(u.device, u.dtype)
    foot_b = kin["foot"]                                  # (B,4,3) trunk
    jv_feet = _leg_point_jacobians(kin, foot_b[:, :, None],
                                   c["foot_moves"])[:, :, 0]  # (B,4,3,18)
    foot_w = state.pos[:, None, :] + foot_b @ r_wb.mT
    v_foot_w = _mv(jv_feet, u[:, None]) @ r_wb.mT
    f_contact, in_contact, anchor = physics._contact_force(
        cfg, ter, foot_w, v_foot_w, state.anchor, state.contact)
    f_b = f_contact @ r_wb                                # world->body

    # ---- generalized forces: gravity on the 13 bodies, contacts, joints -
    bodies = _bodies(art, kin, b, u)
    g_b = _mv(r_bw, physics._gravity(u))
    q_forces = (_mv((bodies.masses[..., None, None] * bodies.jv).sum(dim=1)
                    .mT, g_b)
                + _mv(jv_feet.mT, f_b).sum(dim=1))
    tau_j = tau - env(cfg.joint_friction, 2) * torch.tanh(state.qd * 10.0)
    q_forces = q_forces + torch.cat([u.new_zeros((b, 6)), tau_j], dim=1)

    # ---- solve + integrate --------------------------------------------
    h_mat = _mass_matrix(art, bodies, u)
    rhs = _rhs(h_mat, *_bias(kin, bodies, u), u, q_forces)
    d_diag = torch.cat([u.new_zeros((b, 6)),
                        (env(cfg.joint_damping, 2)
                         * torch.ones_like(state.qd))], dim=1)
    lhs = h_mat + dt3 * torch.diag_embed(d_diag)
    # Solve for the INCREMENT, not u_new: (H + dtD)(u + du) = Hu + dt rhs
    # => du = (H + dtD)^-1 dt (rhs - D u). In float32, solving for u_new
    # directly puts a cond(H)*eps relative error on the FULL |u| every
    # substep (H spans the trunk's ~12 kg to link inertias ~3e-4 kg m^2);
    # on the increment the same relative error scales with dt. No error
    # check: that would read the factorisation's status back to the host.
    du = torch.linalg.solve_ex(lhs, dt * (rhs - d_diag * u))[0]
    u_new = u + du

    # quat first (with the old frame's omega; O(dt^2) indifferent) ...
    qw, qx, qy, qz = state.quat.unbind(-1)
    x, y, z = _mv(r_wb, u_new[:, 3:6]).unbind(-1)
    w0 = torch.zeros_like(x)
    dq = 0.5 * torch.stack([
        w0 * qw - x * qx - y * qy - z * qz,
        w0 * qx + x * qw + y * qz - z * qy,
        w0 * qy - x * qz + y * qw + z * qx,
        w0 * qz + x * qy - y * qx + z * qw,
    ], dim=-1)
    quat = state.quat + dt * dq
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)

    # ... then world velocities with the NEW orientation: u_new's
    # components live in the frame at t+dt (the Euler-Poincare derivative
    # is intrinsic to the rotating frame); converting with the OLD R drops
    # the frame rotation, a systematic momentum leak of -M int(omega x v).
    r_wb_new = rot.quat_to_rot(quat).mT
    v_w = _mv(r_wb_new, u_new[:, 0:3])
    w_w = _mv(r_wb_new, u_new[:, 3:6])
    pos = state.pos + dt * v_w

    qd_new = u_new[:, 6:]
    q_new = torch.clamp(state.q + dt * qd_new, env(cfg.q_min, 2),
                        env(cfg.q_max, 2))

    new_state = state._replace(pos=pos, quat=quat, v=v_w, omega=w_w,
                               q=q_new, qd=qd_new, anchor=anchor,
                               contact=in_contact)
    return new_state, f_contact, in_contact
