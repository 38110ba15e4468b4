"""Robot runners: the controller <-> simulator facade.

Counterpart of ``rl_mpc_locomotion_tpu/control/runner.py``: the same
three-array contract (dof states, body state, commands -> 12 joint torques)
for a batch of robots in lockstep.

- ``min_step``: MPC only, no FSM.
- ``fsm_step``: the full state machine (``control/fsm.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.robots import RobotParams
from . import fsm as fsm_mod
from . import leg_controller, locomotion, state_estimator
from .types import ControlConfig, ControlState, init_control_state


def _resolve_device(device):
    """``None`` means the card; the CPU only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: rl_mpc_locomotion_tpu_torch runs on the GPU "
                "unless device='cpu' is passed")
        return torch.device("cuda")
    return torch.device(device)


def init_state(params: RobotParams, cfg: ControlConfig, fsm_initial: int = 2,
               batch: int = 1, device=None) -> ControlState:
    return init_control_state(params.body_height, cfg.horizon, fsm_initial,
                              batch, _resolve_device(device))


def min_step(params: RobotParams, cfg: ControlConfig, state: ControlState,
             dof_q, dof_qd, body_state, commands,
             mpc_weights: Optional[torch.Tensor] = None,
             gait_id=0, solve_gate: Optional[bool] = None):
    """One 100 Hz Min-mode control tick for the batch.

    Args:
      dof_q, dof_qd: (B,12) joint positions / velocities.
      body_state: (B,13) [pos(3), quat xyzw(4), linvel(3), angvel(3)].
      commands: (B,3) [vx_des, vy_des, yaw_rate].
      mpc_weights: optional (13,) or (B,13) MPC weights; None = robot
        defaults.
      gait_id: Python int or (B,) integer tensor.
      solve_gate: optional Python bool — see locomotion.step.
    Returns:
      (new_state, torques (B,12), metrics dict)

    Runs on the device its tensors lie on.
    """
    weights = params.mpc_weights if mpc_weights is None else mpc_weights

    leg_data = leg_controller.update_data(params, dof_q, dof_qd)
    se = state_estimator.update(state.est, body_state)
    new_loco, new_est, cmds, metrics = locomotion.step(
        params, cfg, state.loco, state.est, se, leg_data, commands, weights,
        gait_id, solve_gate)
    torques = leg_controller.compute_torques(cmds, leg_data)
    new_state = state._replace(est=new_est, loco=new_loco)
    return new_state, torques, metrics


def fsm_step(params: RobotParams, cfg: ControlConfig, state: ControlState,
             passive_iter, dof_q, dof_qd, body_state, commands,
             mpc_weights: Optional[torch.Tensor] = None,
             gait_id=0, control_mode=1, solve_gate: Optional[bool] = None):
    """One 100 Hz FSM-mode control tick for the batch.

    ``passive_iter`` is the (B,) int32 tick count within the passive state;
    ``control_mode`` a Python int or (B,) tensor (0 passive, 1 locomotion,
    2 recovery). The robots' MPC counters are not aligned in this mode
    (entering locomotion resets a robot's), so a batched caller passes
    ``bool(fsm.solve_gate(cfg, state))`` as ``solve_gate``.

    Returns (new_state, torques (B,12), new_passive_iter, metrics)."""
    weights = params.mpc_weights if mpc_weights is None else mpc_weights
    leg_data = leg_controller.update_data(params, dof_q, dof_qd)
    se = state_estimator.update(state.est, body_state)
    new_state, cmds, passive_iter, metrics = fsm_mod.fsm_step(
        params, cfg, state, se, leg_data, commands, weights, gait_id,
        control_mode, passive_iter, solve_gate)
    torques = leg_controller.compute_torques(cmds, leg_data)
    return new_state, torques, passive_iter, metrics
