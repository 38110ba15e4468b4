"""Robot constants for A1 / Go1 / Aliengo as a NamedTuple of tensors.

Counterpart of ``rl_mpc_locomotion_tpu/models/robots.py``. A field is either
shared by the whole batch (the shapes below) or carries one leading env axis
(``(B,)``, ``(B,3)``, ``(B,3,3)``, ``(B,13)``); every consumer broadcasts, so
a heterogeneous batch (A1 + Go1 + Aliengo) is ``select_robot`` of the stacked
registry with a ``(B,)`` id tensor.

Values match the reference stack, including its inflated inertias/masses.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

ALIENGO = 0
GO1 = 1
A1 = 2

ROBOT_NAMES = {"aliengo": ALIENGO, "go1": GO1, "a1": A1}


class RobotParams(NamedTuple):
    abad_link_length: torch.Tensor   # ()
    hip_link_length: torch.Tensor    # ()
    knee_link_length: torch.Tensor   # ()
    abad_location: torch.Tensor      # (3,)
    body_mass: torch.Tensor          # ()
    body_inertia: torch.Tensor       # (3,3)
    body_height: torch.Tensor        # ()
    friction_coeff: torch.Tensor     # () — 0.4 for all robots
    mpc_weights: torch.Tensor        # (13,) default MPC cost weights
    robot_id: torch.Tensor           # () int32 registry id (-1 = custom)
    art: object = None               # sim.articulated.ArticulatedParams or
    # None (the SRB / coupled point-mass plants); attach with
    # sim.articulated.with_articulated


# rank of every field for one robot (without an env axis)
PARAM_RANKS = dict(abad_link_length=0, hip_link_length=0,
                   knee_link_length=0, abad_location=1, body_mass=0,
                   body_inertia=2, body_height=0, friction_coeff=0,
                   mpc_weights=1, robot_id=0)


def _make(abad, hip, knee, abad_loc, mass, inertia_diag, height, weights,
          robot_id, device):
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return RobotParams(
        abad_link_length=f32(abad),
        hip_link_length=f32(hip),
        knee_link_length=f32(knee),
        abad_location=f32(abad_loc),
        body_mass=f32(mass),
        body_inertia=torch.diag(f32(inertia_diag)),
        body_height=f32(height),
        friction_coeff=f32(0.4),
        mpc_weights=f32(weights),
        robot_id=torch.tensor(robot_id, dtype=torch.int32, device=device),
    )


def aliengo_params(device="cpu") -> RobotParams:
    return _make(0.083, 0.25, 0.25, [0.2399, 0.051, 0.0], 9.041 * 2,
                 [0.033260231, 0.16117211, 0.17460442], 0.35,
                 [1.0, 1.5, 0.0, 0.0, 0.0, 50, 0.0, 0.0, 0.1, 1.0, 1.0, 0.1, 0.0],
                 ALIENGO, device)


def go1_params(device="cpu") -> RobotParams:
    """Inertia x5, weights x10."""
    w = [1.0, 1.5, 0.0, 0.0, 0.0, 50, 0.0, 0.0, 0.1, 1.0, 1.0, 0.1, 0.0]
    return _make(0.08, 0.213, 0.213, [0.1881, 0.04675, 0.0], 5.204 * 2,
                 [x * 5 for x in [0.0168128557, 0.063009565, 0.0716547275]],
                 0.26, [x * 10 for x in w], GO1, device)


def a1_params(device="cpu") -> RobotParams:
    """Mass x3, inertia x10."""
    return _make(0.08505, 0.2, 0.2, [0.183, 0.047, 0.0], 8.5 * 3,
                 [x * 10 for x in [0.017, 0.057, 0.064]], 0.26,
                 [0.25, 0.25, 10, 2, 2, 50, 0, 0, 0.3, 0.5, 0.5, 0.1, 0],
                 A1, device)


def _map(fn, *params: RobotParams) -> RobotParams:
    fields = [fn(*xs) for xs in zip(*(p[:-1] for p in params))]
    return RobotParams(*fields, art=None)


def robot_registry(device="cpu") -> RobotParams:
    """Stacked (3, ...) params: index 0=Aliengo, 1=Go1, 2=A1."""
    return _map(lambda *xs: torch.stack(xs), aliengo_params(device),
                go1_params(device), a1_params(device))


def select_robot(registry: RobotParams, robot_id) -> RobotParams:
    """Rows of the stacked registry: an int gives one robot's shared
    params, a (B,) integer tensor gives per-env params."""
    if isinstance(robot_id, int):
        return _map(lambda x: x[robot_id], registry)
    idx = robot_id.long()
    return _map(lambda x: x[idx], registry)
