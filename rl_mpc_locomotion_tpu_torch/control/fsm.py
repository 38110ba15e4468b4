"""Control FSM as data: int state + transition protocol, batched.

Counterpart of ``rl_mpc_locomotion_tpu/control/fsm.py``: every robot of the
batch carries its own FSM state in ``FSMStateData`` ((B,) tensors) and every
update is a masked select (``torch.where``) per field, so robots in
different states share one tick.

State ids: 0 = PASSIVE, 1 = LOCOMOTION, 2 = RECOVERY_STAND.

Protocol: a commanded transition takes two zero-command ticks, the
detection tick (mode -> TRANSITIONING, no run) and the transitioning tick
(exit/enter, no run); the new state runs from the third tick.

Reference quirks kept, as the JAX package keeps them:
- the roll check and the leg-y check apply fabs to a *boolean*, so only
  the positive direction triggers (``locomotion_safe``);
- FoldLegs interpolates with the roll-over ramp length while its completion
  checks fold_ramp + fold_settle;
- the StandUp -> refold tick emits zero commands.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.robots import RobotParams
from . import locomotion
from .locomotion import _where_tree
from .types import (ControlConfig, ControlState, FSMStateData, LegCommands,
                    LegData, StateEstimate, init_estimator_state,
                    init_locomotion_state, zero_leg_commands)

PASSIVE, LOCOMOTION, RECOVERY_STAND = 0, 1, 2
STAND_UP, FOLD_LEGS, ROLL_OVER = 0, 1, 2
MODE_NORMAL, MODE_TRANSITIONING = 0, 1

# Recovery-stand targets
FOLD_JPOS = torch.tensor([[0.0, 1.4, -2.7], [-0.0, 1.4, -2.7],
                          [0.0, 1.4, -2.7], [-0.0, 1.4, -2.7]])
STAND_JPOS = torch.tensor([[0.0, 0.8, -1.6]] * 4)
ROLL_JPOS = torch.tensor([[1.3, 3.1, -2.77], [0.0, 1.6, -2.77],
                          [1.3, 3.1, -2.77], [0.0, 1.6, -2.77]])
PASSIVE_JPOS = torch.tensor([[0.0, 0.01, 0.01]] * 4)

KP_JOINT_DEFAULT = 80.0
KD_JOINT_DEFAULT = 1.0
MAX_ROLL_PITCH_RAD = 40.0 * math.pi / 180.0

_poses = {}


def _pose(name, device):
    """One of the constant joint poses on ``device``, copied there once."""
    key = (name, torch.device(device))
    if key not in _poses:
        _poses[key] = {"fold": FOLD_JPOS, "stand": STAND_JPOS,
                       "roll": ROLL_JPOS, "passive": PASSIVE_JPOS}[name].to(
                           device)
    return _poses[key]


def _ramp_iters(cfg: ControlConfig):
    """Iteration counts scale with the controller dt."""
    s = cfg.dt * 100.0
    return dict(
        fold_ramp=int(45 / s), fold_settle=int(75 / s),
        standup_ramp=int(30 / s), standup_settle=int(30 / s),
        rollover_ramp=int(13 / s), rollover_settle=int(15 / s),
    )


def _joint_pd_commands(q_des) -> LegCommands:
    """Joint PD toward q_des (B,4,3) with the default gains for all legs."""
    b, dev = q_des.shape[0], q_des.device
    eye = torch.eye(3, dtype=q_des.dtype, device=dev)
    return zero_leg_commands(b, dev)._replace(
        q_des=q_des,
        kp_joint=(eye * KP_JOINT_DEFAULT).expand(b, 4, 3, 3),
        kd_joint=(eye * KD_JOINT_DEFAULT).expand(b, 4, 3, 3),
    )


def locomotion_safe(cfg: ControlConfig, se: StateEstimate,
                    leg_data: LegData):
    """Safety predicate, (B,) bool."""
    if not cfg.check_safety:
        return torch.ones(se.rpy.shape[0], dtype=torch.bool,
                          device=se.rpy.device)
    roll_bad = se.rpy[:, 0] > MAX_ROLL_PITCH_RAD          # fabs-of-bool quirk
    pitch_bad = torch.abs(se.rpy[:, 1]) > MAX_ROLL_PITCH_RAD
    leg_above_hip = torch.any(leg_data.p[..., 2] > 0, dim=-1)
    leg_y_bad = torch.any(leg_data.p[..., 1] > 0.18, dim=-1)  # fabs-of-bool
    return torch.logical_not(roll_bad | pitch_bad | leg_above_hip | leg_y_bad)


def _upside_down(se: StateEstimate):
    """rBody[2,2] < 0."""
    return se.r_body[:, 2, 2] < 0


def _recovery_commands(cfg: ControlConfig, fsm: FSMStateData,
                       leg_data: LegData, se: StateEstimate):
    """One RecoveryStand tick: (LegCommands, new fsm fields)."""
    it = _ramp_iters(cfg)
    dev = leg_data.q.device
    curr = fsm.rc_state_iter - fsm.rc_motion_start
    upside = _upside_down(se)

    def interp(max_iter, fin):
        b = torch.clamp(curr.to(torch.float32) / max_iter, 0.0, 1.0)
        b = b[:, None, None]
        return (1.0 - b) * fsm.rc_initial_jpos + b * fin

    fold, stand, roll = (_pose("fold", dev), _pose("stand", dev),
                         _pose("roll", dev))
    # --- StandUp; the body height check uses the *constant* parameter, so
    # something-wrong reduces to upside-down (reference quirk)
    su_refold = torch.logical_and(curr > int(it["standup_ramp"] * 0.7),
                                  upside)
    su_cmds = _joint_pd_commands(interp(it["standup_ramp"], stand))

    # --- FoldLegs: interpolation uses rollover_ramp (reference quirk)
    # while completion checks fold_ramp + fold_settle
    fl_done = curr >= (it["fold_ramp"] + it["fold_settle"])
    fl_cmds = _joint_pd_commands(interp(it["rollover_ramp"], fold))

    # --- RollOver
    ro_done = curr > (it["rollover_ramp"] + it["rollover_settle"])
    ro_cmds = _joint_pd_commands(interp(it["rollover_ramp"], roll))

    is_su = fsm.rc_flag == STAND_UP
    is_fl = fsm.rc_flag == FOLD_LEGS
    is_ro = fsm.rc_flag == ROLL_OVER

    cmds = _where_tree(is_su, su_cmds, _where_tree(is_fl, fl_cmds, ro_cmds))
    # the StandUp->refold tick emits no commands (reference falls through)
    refold = is_su & su_refold
    cmds = _where_tree(refold, zero_leg_commands(refold.shape[0], dev), cmds)

    fold_done = is_fl & fl_done
    roll_done = is_ro & ro_done
    switch = refold | fold_done | roll_done
    new_flag = torch.where(
        refold, FOLD_LEGS,
        torch.where(fold_done, torch.where(upside, ROLL_OVER, STAND_UP),
                    torch.where(roll_done, FOLD_LEGS, fsm.rc_flag))
    ).to(torch.int32)
    new_initial = _where_tree(refold, leg_data.q, _where_tree(
        fold_done, fold.expand_as(leg_data.q), _where_tree(
            roll_done, roll.expand_as(leg_data.q), fsm.rc_initial_jpos)))
    new_motion_start = torch.where(switch, fsm.rc_state_iter + 1,
                                   fsm.rc_motion_start)
    new_fsm = fsm._replace(rc_flag=new_flag, rc_initial_jpos=new_initial,
                           rc_motion_start=new_motion_start,
                           rc_state_iter=fsm.rc_state_iter + 1)
    return cmds, new_fsm


def _recovery_on_enter(fsm: FSMStateData, leg_data: LegData,
                       se: StateEstimate) -> FSMStateData:
    """RecoveryStand's on-enter."""
    upside = _upside_down(se)
    h = se.position[:, 2]
    stand_ok = torch.logical_and(h > 0.2, h < 0.45)
    flag = torch.where(torch.logical_and(torch.logical_not(upside), stand_ok),
                       STAND_UP, FOLD_LEGS).to(torch.int32)
    zero = torch.zeros_like(fsm.rc_state_iter)
    return fsm._replace(rc_flag=flag, rc_state_iter=zero,
                        rc_motion_start=zero, rc_initial_jpos=leg_data.q)


def _passive_commands(passive_iter) -> LegCommands:
    """Passive run: small joint PD for the first 10 ticks, then zero."""
    b, dev = passive_iter.shape[0], passive_iter.device
    cmds = _joint_pd_commands(_pose("passive", dev).expand(b, 4, 3))
    active = passive_iter < 10
    return _where_tree(active, cmds, zero_leg_commands(b, dev))


def solve_gate(cfg: ControlConfig, state: ControlState):
    """The batch's QP gate for an FSM tick, as a 0-dim bool tensor on the
    device: some robot is in LOCOMOTION and some robot's MPC schedule
    fires. Robots entering locomotion this tick do not run it yet (2-tick
    protocol), so the state at the start of the tick decides. A caller that
    passes ``bool(solve_gate(...))`` to ``fsm_step`` reads it back once."""
    any_loco = torch.any(state.fsm.state == LOCOMOTION)
    any_due = torch.any((state.loco.iteration_counter + 1)
                        % cfg.iterations_between_mpc == 0)
    return torch.logical_and(any_loco, any_due)


def fsm_step(params: RobotParams, cfg: ControlConfig, state: ControlState,
             se: StateEstimate, leg_data: LegData, commands, weights,
             gait_id, control_mode, passive_iter,
             solve_gate: Optional[bool] = None):
    """One FSM-mode control tick for the batch.

    Args:
      control_mode: Python int or (B,) integer tensor, the requested state
        {0 passive, 1 locomotion, 2 recovery}.
      passive_iter: (B,) int32 tick count within the passive state.
      solve_gate: Python bool or None, passed to ``locomotion.step``.
    Returns:
      (new ControlState, LegCommands, new passive_iter, metrics)
    """
    fsm = state.fsm
    cur = fsm.state
    b, dev = cur.shape[0], cur.device
    if isinstance(control_mode, torch.Tensor):
        control_mode = control_mode.to(torch.int32).expand(b)
    else:
        control_mode = torch.full((b,), int(control_mode), dtype=torch.int32,
                                  device=dev)
    normal = fsm.op_mode == MODE_NORMAL

    # ---- checkTransition for each state -------------------------------
    safe = locomotion_safe(cfg, se, leg_data)
    # PASSIVE can go to RECOVERY only
    req_passive = torch.where(control_mode == RECOVERY_STAND, RECOVERY_STAND,
                              PASSIVE)
    # LOCOMOTION: any request honoured when safe; unsafe forces RECOVERY
    req_loco = torch.where(safe, control_mode, RECOVERY_STAND)
    unsafe_trigger = torch.logical_and(cur == LOCOMOTION,
                                       torch.logical_not(safe))
    # RECOVERY: any request honoured
    req = torch.where(cur == PASSIVE, req_passive,
                      torch.where(cur == LOCOMOTION, req_loco, control_mode)
                      ).to(torch.int32)

    transition_detected = torch.logical_and(normal, req != cur)
    run_tick = torch.logical_and(normal, torch.logical_not(
        transition_detected))

    # ---- run the three states (masked) --------------------------------
    run_loco = torch.logical_and(run_tick, cur == LOCOMOTION)
    new_loco, new_est, loco_cmds, metrics = locomotion.step(
        params, cfg, state.loco, state.est, se, leg_data, commands, weights,
        gait_id, solve_gate)

    rec_cmds, rec_fsm = _recovery_commands(cfg, fsm, leg_data, se)
    pas_cmds = _passive_commands(passive_iter)

    run_rec = torch.logical_and(run_tick, cur == RECOVERY_STAND)
    run_pas = torch.logical_and(run_tick, cur == PASSIVE)

    cmds = _where_tree(run_loco, loco_cmds, _where_tree(
        run_rec, rec_cmds, _where_tree(run_pas, pas_cmds,
                                       zero_leg_commands(b, dev))))

    # commit state only for the state that actually ran
    loco_state = _where_tree(run_loco, new_loco, state.loco)
    est_state = _where_tree(run_loco, new_est, state.est)
    fsm = _where_tree(run_rec, rec_fsm, fsm)
    passive_iter = torch.where(run_pas, passive_iter + 1, passive_iter)

    # ---- transition protocol ------------------------------------------
    transitioning = fsm.op_mode == MODE_TRANSITIONING
    # transitioning tick: complete switch + on-enter of the new state
    enter_state = fsm.next_state
    enter_loco = torch.logical_and(transitioning, enter_state == LOCOMOTION)
    enter_rec = torch.logical_and(transitioning,
                                  enter_state == RECOVERY_STAND)

    # Locomotion's on-enter: planner re-initialised, estimator reset
    loco_reset = init_locomotion_state(cfg.horizon, b, dev)
    est_reset = init_estimator_state(params.body_height, b, dev)
    loco_state = _where_tree(enter_loco, loco_reset, loco_state)
    est_state = _where_tree(enter_loco, est_reset, est_state)
    rec_entered = _recovery_on_enter(fsm, leg_data, se)
    fsm = _where_tree(enter_rec, rec_entered, fsm)
    passive_iter = torch.where(
        torch.logical_and(transitioning, enter_state == PASSIVE), 0,
        passive_iter)

    new_state_id = torch.where(transitioning, enter_state, cur)
    new_mode = torch.where(
        transitioning, MODE_NORMAL,
        torch.where(transition_detected, MODE_TRANSITIONING, fsm.op_mode)
    ).to(torch.int32)
    new_next = torch.where(transition_detected, req, fsm.next_state)

    fsm = fsm._replace(
        state=new_state_id, op_mode=new_mode, next_state=new_next,
        locomotion_unsafe=torch.logical_or(fsm.locomotion_unsafe,
                                           unsafe_trigger))

    new_control_state = ControlState(est=est_state, loco=loco_state, fsm=fsm)
    metrics = dict(metrics)
    metrics["fsm_state"] = new_state_id
    metrics["locomotion_unsafe"] = fsm.locomotion_unsafe
    return new_control_state, cmds, passive_iter, metrics
