"""Analytic 3-DoF leg forward kinematics and Jacobian for all four legs.

Counterpart of ``rl_mpc_locomotion_tpu/ops/leg_kinematics.py``: abad roll
about x, hip/knee pitch, link lengths (abad, hip, knee), side sign +1 for
left legs (0, 2) and -1 for right legs (1, 3). Batched: the leg axis is
second to last, any batch shape leads.
"""
from __future__ import annotations

import torch

SIDE_SIGN = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=torch.float32)

_side_sign = {}


def side_sign(device):
    """SIDE_SIGN on ``device``, copied there once."""
    device = torch.device(device)
    if device not in _side_sign:
        _side_sign[device] = SIDE_SIGN.to(device)
    return _side_sign[device]


def leg_fk_jacobian(q, abad_len, hip_len, knee_len):
    """FK position and Jacobian for all 4 legs.

    Args:
      q: (..., 4, 3) joint angles [abad, hip, knee] per leg.
      abad_len, hip_len, knee_len: () shared or (...,) per robot.
    Returns:
      p: (..., 4, 3) foot position in the hip frame.
      J: (..., 4, 3, 3) Jacobian dp/dq.
    """
    dy = abad_len[..., None] * side_sign(q.device)   # (...,4)
    dz1 = -hip_len[..., None]
    dz2 = -knee_len[..., None]

    s1, s2, s3 = (torch.sin(q[..., 0]), torch.sin(q[..., 1]),
                  torch.sin(q[..., 2]))
    c1, c2, c3 = (torch.cos(q[..., 0]), torch.cos(q[..., 1]),
                  torch.cos(q[..., 2]))
    c23 = c2 * c3 - s2 * s3
    s23 = s2 * c3 + c2 * s3

    px = dz2 * s23 + dz1 * s2
    py = dy * c1 - dz1 * c2 * s1 - dz2 * s1 * c23
    pz = dy * s1 + dz1 * c1 * c2 + dz2 * c1 * c23
    p = torch.stack([px, py, pz], dim=-1)

    j00 = torch.zeros_like(s1)
    j10 = -dy * s1 - dz2 * c1 * c23 - dz1 * c1 * c2
    j20 = -dz2 * s1 * c23 + dy * c1 - dz1 * c2 * s1
    j01 = dz2 * c23 + dz1 * c2
    j11 = dz2 * s1 * s23 + dz1 * s1 * s2
    j21 = -dz2 * c1 * s23 - dz1 * c1 * s2
    j02 = dz2 * c23
    j12 = dz2 * s1 * s23
    j22 = -dz2 * c1 * s23

    J = torch.stack([
        torch.stack([j00, j01, j02], dim=-1),
        torch.stack([j10, j11, j12], dim=-1),
        torch.stack([j20, j21, j22], dim=-1),
    ], dim=-2)
    return p, J


def hip_locations(abad_location):
    """(...,4,3) hip locations in the body frame from the front-left abad
    offset (...,3); legs ordered [+x +y, +x -y, -x +y, -x -y]."""
    ax, ay, az = (abad_location[..., 0], abad_location[..., 1],
                  abad_location[..., 2])
    xs = torch.stack([ax, ax, -ax, -ax], dim=-1)
    ys = torch.stack([ay, -ay, ay, -ay], dim=-1)
    zs = torch.stack([az, az, az, az], dim=-1)
    return torch.stack([xs, ys, zs], dim=-1)
