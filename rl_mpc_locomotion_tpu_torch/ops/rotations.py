"""3D orientation math on batched tensors.

Counterpart of ``rl_mpc_locomotion_tpu/ops/rotations.py``: the same fourteen
functions with the same conventions, written for any leading batch shape
(``...``) instead of one robot under ``vmap``.

Conventions:
- Quaternions are (w, x, y, z), shape (..., 4).
- ``quat_to_rot(q)`` is the coordinate transform INTO the body frame
  (world->body).
- ``rot_x/y/z(theta)`` transform a vector into a frame rotated by +theta
  (R(-theta) as an active rotation).

Documented deviations from the reference stack are kept: ``axis_angle_to_rot``
uses the correct [2,2] entry, ``rot_from_normals`` normalises the axis.
"""
from __future__ import annotations

import torch


def _mat3(rows):
    """(...,3,3) from three rows of three (...,) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_x(theta):
    """Coordinate rotation about X, (...,) -> (...,3,3)."""
    s, c = torch.sin(theta), torch.cos(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[o, z, z], [z, c, s], [z, -s, c]])


def rot_y(theta):
    """Coordinate rotation about Y."""
    s, c = torch.sin(theta), torch.cos(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[c, z, -s], [z, o, z], [s, z, c]])


def rot_z(theta):
    """Coordinate rotation about Z."""
    s, c = torch.sin(theta), torch.cos(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[c, s, z], [-s, c, z], [z, z, o]])


def skew(v):
    """Skew-symmetric cross-product matrix of v (...,3) -> (...,3,3)."""
    a, b, c = v[..., 0], v[..., 1], v[..., 2]
    z = torch.zeros_like(a)
    return _mat3([[z, -c, b], [c, z, -a], [-b, a, z]])


def quat_to_rot(q):
    """Quaternion (w,x,y,z) -> world->body coordinate transform (...,3,3)."""
    e0, e1, e2, e3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = _mat3([
        [1 - 2 * (e2 * e2 + e3 * e3), 2 * (e1 * e2 - e0 * e3), 2 * (e1 * e3 + e0 * e2)],
        [2 * (e1 * e2 + e0 * e3), 1 - 2 * (e1 * e1 + e3 * e3), 2 * (e2 * e3 - e0 * e1)],
        [2 * (e1 * e3 - e0 * e2), 2 * (e2 * e3 + e0 * e1), 1 - 2 * (e1 * e1 + e2 * e2)],
    ])
    return r.transpose(-1, -2)


def rot_body_to_world(q):
    """Quaternion (w,x,y,z) -> body->world rotation matrix."""
    return quat_to_rot(q).transpose(-1, -2)


def quat_to_rpy(q):
    """Quaternion (w,x,y,z) -> (roll, pitch, yaw), (...,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    as_ = torch.clamp(-2.0 * (x * z - w * y), -0.99999, 0.99999)
    roll = torch.atan2(2.0 * (y * z + w * x), w * w - x * x - y * y + z * z)
    pitch = torch.asin(as_)
    yaw = torch.atan2(2.0 * (x * y + w * z), w * w + x * x - y * y - z * z)
    return torch.stack([roll, pitch, yaw], dim=-1)


def rpy_to_rot(rpy):
    """RPY (...,3) -> world->frame coordinate transform Rx Ry Rz."""
    return rot_x(rpy[..., 0]) @ rot_y(rpy[..., 1]) @ rot_z(rpy[..., 2])


def rpy_to_quat(rpy):
    """RPY -> quaternion (w,x,y,z)."""
    cy, sy = torch.cos(rpy[..., 2] * 0.5), torch.sin(rpy[..., 2] * 0.5)
    cp, sp = torch.cos(rpy[..., 1] * 0.5), torch.sin(rpy[..., 1] * 0.5)
    cr, sr = torch.cos(rpy[..., 0] * 0.5), torch.sin(rpy[..., 0] * 0.5)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def rot_to_quat(rot):
    """Coordinate-transform matrix -> quaternion (w,x,y,z).

    All four Shepperd candidates are computed and one is selected by the
    priority (trace, r00, r11, r22); the sqrt arguments are clamped so the
    unselected ones never produce NaN.
    """
    r = rot.transpose(-1, -2)  # active rotation (body->world)
    r00, r01, r02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    r10, r11, r12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    r20, r21, r22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = r00 + r11 + r22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (r21 - r12) / s0, (r02 - r20) / s0,
                      (r10 - r01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + r00 - r11 - r22) * 2.0
    q1 = torch.stack([(r21 - r12) / s1, 0.25 * s1, (r01 + r10) / s1,
                      (r02 + r20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 + r11 - r00 - r22) * 2.0
    q2 = torch.stack([(r02 - r20) / s2, (r01 + r10) / s2, 0.25 * s2,
                      (r12 + r21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 + r22 - r00 - r11) * 2.0
    q3 = torch.stack([(r10 - r01) / s3, (r02 + r20) / s3, (r12 + r21) / s3,
                      0.25 * s3], dim=-1)

    use0 = (tr > 0.0)[..., None]
    use1 = torch.logical_and(r00 > r11, r00 > r22)[..., None]
    use2 = (r11 > r22)[..., None]
    return torch.where(use0, q0, torch.where(use1, q1,
                                             torch.where(use2, q2, q3)))


def rot_to_rpy(rot):
    """Coordinate-transform matrix -> RPY."""
    return quat_to_rpy(rot_to_quat(rot))


def axis_angle_to_rot(axis, theta):
    """Rodrigues rotation, returned as a coordinate transform (transposed).

    axis (...,3) unit vectors, theta (...,). Implements the correct formula
    (the reference stack has a typo in its [2,2] entry).
    """
    c, s = torch.cos(theta), torch.sin(theta)
    v = 1.0 - c
    k0, k1, k2 = axis[..., 0], axis[..., 1], axis[..., 2]
    return _mat3([
        [k0 * k0 * v + c, k0 * k1 * v - k2 * s, k0 * k2 * v + k1 * s],
        [k0 * k1 * v + k2 * s, k1 * k1 * v + c, k1 * k2 * v - k0 * s],
        [k0 * k2 * v - k1 * s, k1 * k2 * v + k0 * s, k2 * k2 * v + c],
    ]).transpose(-1, -2)


def rot_from_normals(world_normal, ground_normal):
    """Rotation aligning two plane normals (...,3); the axis is normalised."""
    world_normal, ground_normal = torch.broadcast_tensors(world_normal,
                                                          ground_normal)
    axis = torch.linalg.cross(world_normal, ground_normal, dim=-1)
    norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.clamp_min(norm, 1e-8)
    cosang = torch.clamp((world_normal * ground_normal).sum(-1), -1.0, 1.0)
    return axis_angle_to_rot(axis, torch.acos(cosang))


def quat_rotate_inverse(q, v):
    """Rotate world vector v (...,3) into the frame of quaternion q."""
    return (quat_to_rot(q) @ v[..., None])[..., 0]
