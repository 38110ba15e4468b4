"""State and parameters carried between the JAX package and the port.

The ``*_from_numpy`` functions take the JAX package's ``RobotParams`` /
``ControlState`` / ``QPState`` as nested tuples (or dicts keyed by field
name) of numpy arrays — what ``jax.tree.map(np.asarray, ...)`` gives — and
return the port's containers on ``device``. A container of one robot gets a
leading batch axis of length ``batch``; one that already carries a batch
axis keeps it. The ``*_to_numpy`` functions go back: nested tuples of numpy
arrays with the batch axis kept. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..control.types import (ControlState, EstimatorState, FSMStateData,
                             LocomotionState)
from ..models.robots import RobotParams
from ..ops.qp import QPState

# per-robot rank of every field (without a batch axis)
_QP_RANKS = dict(x=1, z=1, y=1, rho_mult=0)
_EST_RANKS = dict(contact_phase=1, foot_contact_history=2,
                  ground_normal_yaw=1, ground_normal_world=1, com_z=0)
_LOCO_RANKS = dict(iteration_counter=0, first_run=0, first_swing=1,
                   swing_time_remaining=1, p0=2, pf=2, f_ff=2,
                   swing_memory=3)
_FSM_RANKS = dict(state=0, op_mode=0, next_state=0, rc_flag=0,
                  rc_state_iter=0, rc_motion_start=0, rc_initial_jpos=2,
                  locomotion_unsafe=0)
_PARAM_RANKS = dict(abad_link_length=0, hip_link_length=0,
                    knee_link_length=0, abad_location=1, body_mass=0,
                    body_inertia=2, body_height=0, friction_coeff=0,
                    mpc_weights=1, robot_id=0)


def _fields(obj, names):
    """Field values of a tuple / NamedTuple / dict in ``names`` order."""
    if isinstance(obj, dict):
        return [obj[k] for k in names]
    return list(obj)[:len(names)]


def _tensor(value, device):
    arr = np.array(value)      # a writable copy; keeps rank 0
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return torch.from_numpy(arr).to(device)


def _batched(value, rank, batch, device):
    """A (B, ...) tensor from a per-robot or already batched array."""
    t = _tensor(value, device)
    if t.dim() == rank:
        return t.unsqueeze(0).expand((batch,) + tuple(t.shape)).clone()
    if t.dim() != rank + 1:
        raise ValueError(f"expected rank {rank} or {rank + 1}, got {t.dim()}")
    return t


def _container(cls, obj, ranks, batch, device, **extra):
    vals = _fields(obj, list(ranks))
    kw = {k: _batched(v, r, batch, device)
          for (k, r), v in zip(ranks.items(), vals)}
    return cls(**kw, **extra)


def robot_params_from_numpy(params, device="cpu") -> RobotParams:
    """RobotParams from numpy fields; shapes are kept, so stacked (B, ...)
    fields stay per-env and plain fields stay shared. ``art`` is dropped."""
    vals = _fields(params, list(_PARAM_RANKS))
    return RobotParams(*[_tensor(v, device) for v in vals], art=None)


def qp_state_from_numpy(state, batch: int = 1, device="cpu") -> QPState:
    return _container(QPState, state, _QP_RANKS, batch, device)


def control_state_from_numpy(state, batch: int = 1, device="cpu"
                             ) -> ControlState:
    est, loco, fsm = _fields(state, ["est", "loco", "fsm"])
    loco_vals = _fields(loco, list(_LOCO_RANKS) + ["qp_state"])
    qp_state = qp_state_from_numpy(loco_vals[-1], batch, device)
    return ControlState(
        est=_container(EstimatorState, est, _EST_RANKS, batch, device),
        loco=_container(LocomotionState, loco_vals[:-1], _LOCO_RANKS, batch,
                        device, qp_state=qp_state),
        fsm=_container(FSMStateData, fsm, _FSM_RANKS, batch, device))


def _np(t):
    return t.detach().cpu().numpy()


def qp_state_to_numpy(state: QPState):
    return tuple(_np(t) for t in state)


def robot_params_to_numpy(params: RobotParams):
    return tuple(_np(t) for t in params[:-1]) + (None,)


def control_state_to_numpy(state: ControlState):
    loco = tuple(_np(t) for t in state.loco[:-1]) + (
        qp_state_to_numpy(state.loco.qp_state),)
    return (tuple(_np(t) for t in state.est), loco,
            tuple(_np(t) for t in state.fsm))
