"""Leg controller: joint-state ingestion and torque mapping for a batch.

Counterpart of ``rl_mpc_locomotion_tpu/control/leg_controller.py``:
  tau = tau_ff + J^T (f_ff + Kp_c (pDes - p) + Kd_c (vDes - v))
        + Kp_j (qDes - q) + Kd_j (qdDes - qd)
"""
from __future__ import annotations

import torch

from ..models.robots import RobotParams
from ..ops.leg_kinematics import leg_fk_jacobian
from .types import LegCommands, LegData


def update_data(params: RobotParams, dof_q, dof_qd) -> LegData:
    """Build LegData from (B,12) joint positions / velocities."""
    b = dof_q.shape[0]
    q = dof_q.reshape(b, 4, 3)
    qd = dof_qd.reshape(b, 4, 3)
    p, J = leg_fk_jacobian(q, params.abad_link_length, params.hip_link_length,
                           params.knee_link_length)
    v = torch.einsum('blij,blj->bli', J, qd)
    return LegData(q=q, qd=qd, p=p, v=v, J=J)


def compute_torques(cmds: LegCommands, data: LegData) -> torch.Tensor:
    """(B,12) joint torques."""
    foot_force = (cmds.force_ff
                  + torch.einsum('blij,blj->bli', cmds.kp_cart,
                                 cmds.p_des - data.p)
                  + torch.einsum('blij,blj->bli', cmds.kd_cart,
                                 cmds.v_des - data.v))
    tau = cmds.tau_ff + torch.einsum('blji,blj->bli', data.J, foot_force)
    tau = tau + torch.einsum('blij,blj->bli', cmds.kp_joint,
                             cmds.q_des - data.q)
    tau = tau + torch.einsum('blij,blj->bli', cmds.kd_joint,
                             cmds.qd_des - data.qd)
    return tau.reshape(-1, 12)
