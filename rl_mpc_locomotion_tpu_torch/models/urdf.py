"""URDF -> RobotParams: load Unitree-style quadruped descriptions.

Counterpart of ``rl_mpc_locomotion_tpu/models/urdf.py``: the controller's
constants derived from a URDF, so a new robot drops in without hand-entered
link lengths::

    params = params_from_urdf("assets/aliengo.urdf", body_height=0.35,
                              mass_scale=2.0)

Expected structure (Unitree convention): a trunk link with <inertial>, legs
{FR,FL,RR,RL} with joints <leg>_hip_joint (abad, on the trunk),
<leg>_thigh_joint, <leg>_calf_joint, and a fixed <leg>_foot_fixed joint.
The file is parsed in float64 with numpy; the fields are cast to float32 at
the end. mass/inertia scales reproduce the reference's deliberate inflation
for stability.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Optional, Sequence

import numpy as np
import torch

from .robots import RobotParams

DEFAULT_WEIGHTS = (1.0, 1.5, 0.0, 0.0, 0.0, 50, 0.0, 0.0, 0.1,
                   1.0, 1.0, 0.1, 0.0)


def _joint_origin(root, name) -> np.ndarray:
    for j in root.iter("joint"):
        if j.get("name") == name:
            o = j.find("origin")
            if o is None or o.get("xyz") is None:
                return np.zeros(3)
            return np.array([float(v) for v in o.get("xyz").split()])
    raise KeyError(f"joint '{name}' not found in URDF")


def _trunk_inertial(root, trunk_name):
    for link in root.iter("link"):
        if link.get("name") == trunk_name:
            inertial = link.find("inertial")
            mass = float(inertial.find("mass").get("value"))
            ia = inertial.find("inertia").attrib
            inertia = np.diag([float(ia["ixx"]), float(ia["iyy"]),
                               float(ia["izz"])])
            return mass, inertia
    raise KeyError(f"link '{trunk_name}' not found in URDF")


def params_from_urdf(path: str, body_height: float,
                     trunk_link: str = "trunk",
                     front_left_leg: str = "FL",
                     mass_scale: float = 1.0,
                     inertia_scale: float = 1.0,
                     friction_coeff: float = 0.4,
                     mpc_weights: Optional[Sequence[float]] = None,
                     robot_id: int = -1,
                     device="cpu") -> RobotParams:
    """Build shared (one robot kind) RobotParams from a Unitree-style URDF.

    body_height, friction and MPC weights are controller tuning, not URDF
    content, so they stay explicit arguments.
    """
    root = ET.parse(path).getroot()
    fl = front_left_leg

    abad_loc = _joint_origin(root, f"{fl}_hip_joint")
    abad_len = abs(_joint_origin(root, f"{fl}_thigh_joint")[1])
    hip_len = abs(_joint_origin(root, f"{fl}_calf_joint")[2])
    knee_len = abs(_joint_origin(root, f"{fl}_foot_fixed")[2])
    mass, inertia = _trunk_inertial(root, trunk_link)

    weights = mpc_weights if mpc_weights is not None else DEFAULT_WEIGHTS

    def f32(v):
        return torch.from_numpy(
            np.asarray(v, np.float64).astype(np.float32)).to(device)

    return RobotParams(
        abad_link_length=f32(abad_len),
        hip_link_length=f32(hip_len),
        knee_link_length=f32(knee_len),
        abad_location=f32(abad_loc),
        body_mass=f32(mass * mass_scale),
        body_inertia=f32(inertia * inertia_scale),
        body_height=f32(body_height),
        friction_coeff=f32(friction_coeff),
        mpc_weights=f32(weights),
        robot_id=torch.tensor(robot_id, dtype=torch.int32, device=device),
    )
