"""State estimator: frame transforms + terrain (ground-normal/CoM) estimate.

Counterpart of ``rl_mpc_locomotion_tpu/control/state_estimator.py``, batched.
``update`` consumes the raw (B,13) root state each tick; the terrain
functions are called from inside the locomotion step and thread the
persistent EstimatorState explicitly.
"""
from __future__ import annotations

import torch

from ..ops import rotations as rot
from .types import EstimatorState, StateEstimate


def _up(like):
    """The world up axis (0, 0, 1), made on the device (no host copy)."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[2]


def _position(com_z):
    zero = torch.zeros_like(com_z)
    return torch.stack([zero, zero, com_z], dim=-1)


def update(est: EstimatorState, body_state) -> StateEstimate:
    """Per-tick frame transforms.

    body_state: (B,13) root state [pos(3), quat xyzw(4), linvel(3),
    angvel(3)]. Position xy is not consumed: position[:2] stays zero and only
    z is estimated.
    """
    quat = torch.stack([body_state[:, 6], body_state[:, 3], body_state[:, 4],
                        body_state[:, 5]], dim=-1)
    v_world = body_state[:, 7:10]
    omega_world = body_state[:, 10:13]

    r_body = rot.quat_to_rot(quat)          # world -> body
    v_body = torch.einsum('bij,bj->bi', r_body, v_world)
    omega_body = torch.einsum('bij,bj->bi', r_body, omega_world)
    rpy = rot.quat_to_rpy(quat)

    world_r_yaw = rot.rot_z(rpy[:, 2])      # rpy_to_rot of (0, 0, yaw)
    yaw_r_ground = rot.rot_from_normals(_up(quat), est.ground_normal_yaw)
    ground_r_body = (r_body @ world_r_yaw.transpose(-1, -2)
                     @ yaw_r_ground.transpose(-1, -2))
    rpy_body = rot.rot_to_rpy(ground_r_body)

    return StateEstimate(
        position=_position(est.com_z), v_world=v_world,
        omega_world=omega_world, quat=quat, r_body=r_body, rpy=rpy,
        rpy_body=rpy_body, v_body=v_body, omega_body=omega_body,
        ground_normal_yaw=est.ground_normal_yaw,
        ground_normal_world=est.ground_normal_world,
        ground_r_body=ground_r_body)


def update_com_height(est: EstimatorState, ground_r_body, foot_positions):
    """CoM height (B,) from the stance-feet average; unchanged when no foot
    is in contact. foot_positions: (B,4,3) in the body frame."""
    contacts = est.contact_phase
    n_contact = contacts.sum(dim=-1)
    fp_ground = foot_positions @ ground_r_body.transpose(-1, -2)
    heights = -fp_ground[..., 2]
    z = (heights * contacts).sum(dim=-1) / torch.clamp_min(n_contact, 1e-6)
    return torch.where(n_contact > 0, z, est.com_z)


def update_ground_estimate(est: EstimatorState, se: StateEstimate,
                           foot_positions) -> EstimatorState:
    """Full terrain update: CoM height, contact history, least-squares plane
    normal (pseudo-inverse of the contact history)."""
    com_z = update_com_height(est, se.ground_r_body, foot_positions)

    in_contact = est.contact_phase > 0
    hist = torch.where(in_contact[..., None], foot_positions,
                       est.foot_contact_history)

    normal = torch.linalg.pinv(hist).sum(dim=-1)     # pinv(hist) @ ones(4)
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    normal = torch.where(norm > 1e-6, normal / torch.clamp_min(norm, 1e-6),
                         _up(normal))
    normal = torch.where(normal[:, 2:3] < 0, -normal, normal)

    return est._replace(
        com_z=com_z,
        foot_contact_history=hist,
        ground_normal_yaw=normal,
        ground_normal_world=torch.einsum('bji,bj->bi', se.r_body, normal),
    )


def update_flat_ground(est: EstimatorState, se: StateEstimate,
                       foot_positions) -> EstimatorState:
    """flat_ground=True path: only the CoM height is estimated."""
    com_z = update_com_height(est, se.ground_r_body, foot_positions)
    return est._replace(com_z=com_z)


def init_contact_history(est: EstimatorState, foot_positions,
                         body_height) -> EstimatorState:
    """First-run init: feet assumed at -body_height."""
    return est._replace(foot_contact_history=_feet_at_height(
        foot_positions, body_height))


def _feet_at_height(foot_positions, body_height):
    z = -torch.as_tensor(body_height, dtype=foot_positions.dtype,
                         device=foot_positions.device)
    z = z.reshape(-1, 1, 1).expand(foot_positions.shape[0], 4, 1)
    return torch.cat([foot_positions[..., :2], z], dim=-1)
