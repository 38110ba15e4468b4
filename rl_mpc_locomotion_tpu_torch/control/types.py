"""Control-stack state containers and static configuration.

Counterpart of ``rl_mpc_locomotion_tpu/control/types.py``. All per-robot
state is one ``ControlState`` of ``(B, ...)`` tensors (the shapes in the
comments follow the leading batch axis); configuration is a frozen dataclass
of Python scalars.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.qp import QPConfig, QPState, init_qp_state

NUM_LEGS = 4
HORIZON = 10


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Static controller configuration."""
    dt: float = 0.01                     # controller period
    iterations_between_mpc: int = 2
    horizon: int = HORIZON
    flat_ground: bool = True
    alpha: float = 1e-5                  # QP regulariser
    bonus_swing: float = 0.0
    qp: QPConfig = QPConfig()
    check_safety: bool = True
    # QP divergence fallback: when the solve's worst constraint violation
    # (Newtons) exceeds this, hold the previous f_ff and cold-start the next
    # solve.
    qp_divergence_tol: float = 1.0

    @property
    def dt_mpc(self) -> float:
        return self.dt * self.iterations_between_mpc


class StateEstimate(NamedTuple):
    """Per-tick estimator output."""
    position: torch.Tensor        # (3,) x,y always 0, z estimated
    v_world: torch.Tensor         # (3,)
    omega_world: torch.Tensor     # (3,)
    quat: torch.Tensor            # (4,) wxyz
    r_body: torch.Tensor          # (3,3) world->body
    rpy: torch.Tensor             # (3,) body in world
    rpy_body: torch.Tensor        # (3,) body in yaw-aligned ground frame
    v_body: torch.Tensor          # (3,)
    omega_body: torch.Tensor      # (3,)
    ground_normal_yaw: torch.Tensor    # (3,)
    ground_normal_world: torch.Tensor  # (3,)
    ground_r_body: torch.Tensor   # (3,3)


class EstimatorState(NamedTuple):
    """Persistent estimator state (carried across ticks)."""
    contact_phase: torch.Tensor         # (4,)
    foot_contact_history: torch.Tensor  # (4,3)
    ground_normal_yaw: torch.Tensor     # (3,)
    ground_normal_world: torch.Tensor   # (3,)
    com_z: torch.Tensor                 # () estimated body height


class LocomotionState(NamedTuple):
    """The locomotion planner's mutable state as data."""
    iteration_counter: torch.Tensor     # () int32
    first_run: torch.Tensor             # () bool
    first_swing: torch.Tensor           # (4,) bool
    swing_time_remaining: torch.Tensor  # (4,)
    p0: torch.Tensor                    # (4,3) swing start (world frame)
    pf: torch.Tensor                    # (4,3) swing target
    f_ff: torch.Tensor                  # (4,3) MPC feed-forward GRFs
    swing_memory: torch.Tensor          # (2,4,3) last swing-trajectory (p, v)
    qp_state: QPState                   # ADMM warm start


class LegCommands(NamedTuple):
    """Per-leg command batch."""
    tau_ff: torch.Tensor     # (4,3)
    force_ff: torch.Tensor   # (4,3)
    q_des: torch.Tensor      # (4,3)
    qd_des: torch.Tensor     # (4,3)
    p_des: torch.Tensor      # (4,3)
    v_des: torch.Tensor      # (4,3)
    kp_cart: torch.Tensor    # (4,3,3)
    kd_cart: torch.Tensor    # (4,3,3)
    kp_joint: torch.Tensor   # (4,3,3)
    kd_joint: torch.Tensor   # (4,3,3)


class LegData(NamedTuple):
    """Per-leg measured state."""
    q: torch.Tensor   # (4,3)
    qd: torch.Tensor  # (4,3)
    p: torch.Tensor   # (4,3)
    v: torch.Tensor   # (4,3)
    J: torch.Tensor   # (4,3,3)


class FSMStateData(NamedTuple):
    """Finite-state machine as data, one entry per robot; ``control/fsm.py``
    steps it (``fsm_step``) and ``init_fsm_state`` starts it."""
    state: torch.Tensor              # () int32: 0 passive, 1 locomotion, 2 recovery
    op_mode: torch.Tensor            # () int32: 0 normal, 1 transitioning
    next_state: torch.Tensor         # () int32
    rc_flag: torch.Tensor            # () int32: 0 standup, 1 foldlegs, 2 rollover
    rc_state_iter: torch.Tensor      # () int32
    rc_motion_start: torch.Tensor    # () int32
    rc_initial_jpos: torch.Tensor    # (4,3)
    locomotion_unsafe: torch.Tensor  # () bool


class ControlState(NamedTuple):
    est: EstimatorState
    loco: LocomotionState
    fsm: FSMStateData


def _zeros(batch, *shape, device, dtype=torch.float32):
    return torch.zeros((batch, *shape), dtype=dtype, device=device)


def zero_leg_commands(batch: int, device="cpu") -> LegCommands:
    z3 = _zeros(batch, NUM_LEGS, 3, device=device)
    z33 = _zeros(batch, NUM_LEGS, 3, 3, device=device)
    return LegCommands(tau_ff=z3, force_ff=z3, q_des=z3, qd_des=z3, p_des=z3,
                       v_des=z3, kp_cart=z33, kd_cart=z33, kp_joint=z33,
                       kd_joint=z33)


def init_estimator_state(body_height, batch: int, device="cpu"
                         ) -> EstimatorState:
    up = torch.eye(3, dtype=torch.float32, device=device)[2]
    com_z = torch.as_tensor(body_height, dtype=torch.float32, device=device)
    return EstimatorState(
        contact_phase=_zeros(batch, NUM_LEGS, device=device),
        foot_contact_history=_zeros(batch, NUM_LEGS, 3, device=device),
        ground_normal_yaw=up.repeat(batch, 1),
        ground_normal_world=up.repeat(batch, 1),
        com_z=com_z.expand(batch).clone(),
    )


def init_locomotion_state(horizon: int = HORIZON, batch: int = 1,
                          device="cpu") -> LocomotionState:
    return LocomotionState(
        iteration_counter=_zeros(batch, device=device, dtype=torch.int32),
        first_run=torch.ones(batch, dtype=torch.bool, device=device),
        first_swing=torch.ones((batch, NUM_LEGS), dtype=torch.bool,
                               device=device),
        swing_time_remaining=_zeros(batch, NUM_LEGS, device=device),
        p0=_zeros(batch, NUM_LEGS, 3, device=device),
        pf=_zeros(batch, NUM_LEGS, 3, device=device),
        f_ff=_zeros(batch, NUM_LEGS, 3, device=device),
        swing_memory=_zeros(batch, 2, NUM_LEGS, 3, device=device),
        qp_state=init_qp_state(horizon * 12, horizon * 20, batch, device),
    )


def init_fsm_state(initial: int = 2, batch: int = 1, device="cpu"
                   ) -> FSMStateData:
    """Default initial state RECOVERY_STAND, in TRANSITIONING with
    next_state=initial so the first FSM tick would run the state's
    on-enter."""
    def i32(v):
        return torch.full((batch,), v, dtype=torch.int32, device=device)
    return FSMStateData(
        state=i32(initial), op_mode=i32(1), next_state=i32(initial),
        rc_flag=i32(1), rc_state_iter=i32(0), rc_motion_start=i32(0),
        rc_initial_jpos=_zeros(batch, NUM_LEGS, 3, device=device),
        locomotion_unsafe=torch.zeros(batch, dtype=torch.bool, device=device),
    )


def init_control_state(body_height, horizon: int = HORIZON,
                       fsm_initial: int = 2, batch: int = 1, device="cpu"
                       ) -> ControlState:
    return ControlState(
        est=init_estimator_state(body_height, batch, device),
        loco=init_locomotion_state(horizon, batch, device),
        fsm=init_fsm_state(fsm_initial, batch, device))
