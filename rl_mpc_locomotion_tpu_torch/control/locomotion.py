"""Convex-MPC locomotion planner as a batched step function.

Counterpart of ``rl_mpc_locomotion_tpu/control/locomotion.py``:

- all mutable planner state lives in ``LocomotionState``,
- legs are an axis written out, robots the leading axis ``B``,
- the MPC solve is gated by a Python ``if`` on a Python bool
  (``solve_gate``), so the QP only runs on solve ticks, while the per-robot
  counters mask the commit with ``torch.where``,
- nothing on this path reads a tensor back to the host.

Statement ordering follows the reference planner's ``run`` exactly,
including the quirks that matter for trace parity:
- pFoot is computed with the *previous* tick's CoM height, while foot
  placement uses the height updated this tick,
- the y foot-placement feedback has an extra dtMPC factor,
- the desired z velocity is zero and z position held,
- stance legs reuse the last computed swing-trajectory sample.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.robots import RobotParams
from ..ops import bezier, gait
from ..ops import qp as qp_mod
from ..ops import rotations as rot
from ..ops import srb_dynamics as srb
from ..ops.cuda import mpc_assembly
from ..ops.leg_kinematics import hip_locations, side_sign
from . import state_estimator
from .types import (ControlConfig, EstimatorState, LegData, LocomotionState,
                    StateEstimate, zero_leg_commands)

# Cartesian swing gains
KP_SWING = torch.diag(torch.tensor([700.0, 700.0, 150.0]))
KD_SWING = torch.diag(torch.tensor([7.0, 7.0, 7.0]))

_gains = {}


def _swing_gains(device):
    device = torch.device(device)
    if device not in _gains:
        _gains[device] = (KP_SWING.to(device), KD_SWING.to(device),
                          0.2 * torch.eye(3, device=device))
    return _gains[device]


def _solve_mpc(params: RobotParams, cfg: ControlConfig, se: StateEstimate,
               com_z, foot_positions, mpc_table, weights, commands,
               qp_state: qp_mod.QPState):
    """One dense MPC solve for the batch: the problem's assembly (with
    ``use_kernel``, one kernel on the card:
    ``mpc_assembly.assemble_mpc_batch``), then ``qp.solve_qp_chain``."""
    horizon = cfg.horizon
    b = com_z.shape[0]
    dev, dt = com_z.device, com_z.dtype
    if cfg.flat_ground:
        gravity_vec = torch.eye(3, dtype=dt, device=dev)[2]
    else:
        gravity_vec = se.ground_normal_yaw
    mu = params.friction_coeff
    # use_kernel=False keeps the whole pipeline plain, the assembly included
    assemble = (mpc_assembly.assemble_mpc_batch if cfg.qp.use_kernel
                else mpc_assembly.assemble_mpc_batch_reference)
    s_chain, q_vec, lb, ub, mask = assemble(
        *[t.contiguous() for t in (
            se.rpy_body, com_z, se.omega_body, se.v_body, foot_positions,
            mpc_table, weights, commands, gravity_vec, params.body_mass,
            params.body_inertia, params.body_height, mu)],
        dt_mpc=cfg.dt_mpc, horizon=horizon)
    cone = srb.friction_cone_block(mu)
    c_blocks = cone.reshape(-1, 1, 5, 3).expand(b, horizon * 4, 5, 3)

    # receding-horizon warm-start shift: this solve's horizon is the
    # previous one advanced by one gait segment
    qp_state = qp_mod.shift_warm_start(qp_state, horizon)
    x, new_qp_state, diag = qp_mod.solve_qp_chain(
        s_chain, q_vec, weights, cfg.alpha, c_blocks, lb, ub, qp_state,
        cfg.qp, mask=mask, horizon=horizon)
    # sign flip: solver variable is GRF on the body; f_ff is foot-on-ground
    f_ff = -x[:, :12].reshape(b, 4, 3)

    # MPC loss decomposition for telemetry, against the desired state: zero
    # rpy, the CoM at (0, 0, body height), velocity (vx, vy, 0); the third
    # term pairs omega with the desired *linear* velocity, as the reference
    # planner does
    w = weights.reshape(-1, weights.shape[-1])
    desired_velocity = torch.nn.functional.pad(commands[:, :2], (0, 1))
    state_loss = ((se.rpy_body * w[:, 0:3]).sum(-1)
                  + (com_z - params.body_height) * w[:, 5]
                  + ((se.omega_body - desired_velocity) * w[:, 6:9]).sum(-1)
                  + ((se.v_body - desired_velocity) * w[:, 9:12]).sum(-1))
    torque_loss = cfg.alpha * (-x[:, :12]).sum(-1)
    diag = dict(diag)
    diag["mpc_loss"] = state_loss + torque_loss
    return f_ff, new_qp_state, diag


def step(params: RobotParams, cfg: ControlConfig, loco: LocomotionState,
         est: EstimatorState, se: StateEstimate, leg_data: LegData,
         commands, weights, gait_id, solve_gate: Optional[bool] = None):
    """One 100 Hz locomotion tick for the batch.

    Args:
      commands: (B,3) [vx_des, vy_des, yaw_rate_des].
      weights: (13,) or (B,13) MPC weights.
      gait_id: Python int (one gait for the batch) or (B,) integer tensor.
      solve_gate: Python bool marking ticks on which the QP may run; the
        per-robot counters then mask the commit. The caller of a batched
        tick passes it. ``None`` decides from the counters themselves: for a
        batch that means solving on every tick and committing only where a
        robot's counter asks (no read-back, but twice the solves at the
        default schedule); only for ``B == 1``, the single-robot
        convenience path, is the counter read on the host to skip the
        solve, which synchronises with the device.
    Returns:
      (new_loco, new_est, LegCommands, metrics)
    """
    return _step_impl(params, cfg, loco, est, se, leg_data, commands,
                      weights, gait_id, solve_gate)


def _where_tree(cond, new, old):
    """Per-robot select over two containers of (B, ...) tensors by a (B,)
    mask; NamedTuples and dicts nest."""
    if isinstance(new, dict):
        return {k: _where_tree(cond, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return type(new)(*[_where_tree(cond, n, o) for n, o in zip(new, old)])
    c = cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim()))
    return torch.where(c, new, old)


def _step_impl(params: RobotParams, cfg: ControlConfig, loco: LocomotionState,
               est: EstimatorState, se: StateEstimate, leg_data: LegData,
               commands, weights, gait_id,
               solve_gate: Optional[bool] = None):
    b = commands.shape[0]
    dev, dt = commands.device, commands.dtype
    offsets, durations = gait.gait_params(gait_id, dev)
    offsets, durations = offsets.expand(b, 4), durations.expand(b, 4)
    ipm = cfg.iterations_between_mpc
    dt_mpc = cfg.dt_mpc

    iteration, phase = gait.gait_iteration_phase(loco.iteration_counter, ipm)

    hips = hip_locations(params.abad_location)              # (4,3) or (B,4,3)
    foot_positions = hips + leg_data.p                      # (B,4,3) body frame
    p_foot = foot_positions + se.position[:, None, :]       # uses OLD com_z

    # --- first-run initialisation ---
    first = loco.first_run
    est = est._replace(foot_contact_history=torch.where(
        first[:, None, None],
        state_estimator._feet_at_height(foot_positions, params.body_height),
        est.foot_contact_history))
    p0 = torch.where(first[:, None, None], p_foot, loco.p0)

    # --- terrain / CoM estimate ---
    if cfg.flat_ground:
        est = state_estimator.update_flat_ground(est, se, foot_positions)
    else:
        est = state_estimator.update_ground_estimate(est, se, foot_positions)
    zero = torch.zeros_like(est.com_z)
    position = torch.stack([zero, zero, est.com_z], dim=-1)  # (B,3)

    # --- swing timing and foot placement ---
    swing_times = gait.swing_time(durations, dt_mpc)        # (B,4)
    stance_times = gait.stance_time(durations, dt_mpc)      # (B,4)
    swing_remaining = torch.where(loco.first_swing, swing_times,
                                  loco.swing_time_remaining - cfg.dt)

    v_des_robot = torch.stack([commands[:, 0], commands[:, 1], zero], dim=-1)
    swing_height = params.body_height / 3.0

    offset_y = side_sign(dev) * params.abad_link_length[..., None]
    zeros4 = torch.zeros_like(offset_y)
    p_robot = (hips + torch.stack([zeros4, offset_y, zeros4], dim=-1)
               ).expand(b, 4, 3)
    # per-leg yaw correction Rz(-yaw_rate * stance/2)
    yaw_rot = rot.rot_z(-commands[:, 2:3] * stance_times / 2.0)  # (B,4,3,3)
    yaw_corr = torch.einsum('blij,blj->bli', yaw_rot, p_robot)
    pf_new = (position[:, None, :] + yaw_corr
              + v_des_robot[:, None, :] * swing_remaining[..., None])

    p_rel_max = 0.3
    vx, vy = se.v_body[:, 0:1], se.v_body[:, 1:2]
    yaw_rate = commands[:, 2:3]
    pz = position[:, 2:3]
    pfx_rel = (vx * (0.5 + cfg.bonus_swing) * stance_times
               + 0.03 * (vx - v_des_robot[:, 0:1])
               + (0.5 * pz / 9.81) * (vy * yaw_rate))
    # NOTE: the reference multiplies the y term by an extra dtMPC
    pfy_rel = (vy * 0.5 * stance_times * dt_mpc
               + 0.03 * (vy - v_des_robot[:, 1:2])
               + (0.5 * pz / 9.81) * (-vx * yaw_rate))
    pfx_rel = torch.clamp(pfx_rel, -p_rel_max, p_rel_max)
    pfy_rel = torch.clamp(pfy_rel, -p_rel_max, p_rel_max)
    pf = torch.stack([pf_new[..., 0] + pfx_rel, pf_new[..., 1] + pfy_rel,
                      torch.full_like(pfx_rel, -0.003)], dim=-1)

    # --- counter increment + gait tables ---
    counter_new = loco.iteration_counter + 1
    contact_states = gait.contact_state(phase, offsets, durations)
    swing_states = gait.swing_state(phase, offsets, durations)
    mpc_tbl = gait.mpc_table(iteration, offsets, durations)   # (B,h,4)

    # --- MPC solve every iterations_between_mpc ticks ---
    want_solve = (counter_new % ipm) == 0                     # (B,)
    if solve_gate is None:
        # single-robot convenience path only: reads the counter on the host
        run_solve = bool(want_solve.any()) if b == 1 else True
    else:
        run_solve = bool(solve_gate)

    if run_solve:
        f_ff, qp_state, qp_diag = _solve_mpc(
            params, cfg, se, est.com_z, foot_positions, mpc_tbl, weights,
            commands, loco.qp_state)
        if solve_gate is None:
            # per-robot gate: robots not due keep their state and report 0
            f_ff = torch.where(want_solve[:, None, None], f_ff, loco.f_ff)
            qp_state = _where_tree(want_solve, qp_state, loco.qp_state)
            qp_diag = {k: torch.where(
                want_solve.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                torch.zeros_like(v)) for k, v in qp_diag.items()}
    else:
        f_ff, qp_state = loco.f_ff, loco.qp_state
        qp_diag = {k: zero for k in ("primal_violation", "pri_res",
                                     "dua_res", "mpc_loss")}

    # divergence fallback: a solve whose worst constraint violation exceeds
    # the tolerance holds the previous forces and cold-starts the next
    # solve. The deferred-rho memory is RETAINED through the fallback:
    # resetting rho_mult re-triggers the stall that caused the divergence.
    diverged = qp_diag["primal_violation"] > cfg.qp_divergence_tol
    f_ff = torch.where(diverged[:, None, None], loco.f_ff, f_ff)
    cold = qp_mod.QPState(x=torch.zeros_like(qp_state.x),
                          z=torch.zeros_like(qp_state.z),
                          y=torch.zeros_like(qp_state.y),
                          rho_mult=qp_state.rho_mult)
    qp_state = _where_tree(diverged, cold, qp_state)

    if solve_gate is not None:
        # the gate ran the solve; per-robot counters mask the commit
        f_ff = torch.where(want_solve[:, None, None], f_ff, loco.f_ff)
        qp_state = _where_tree(want_solve, qp_state, loco.qp_state)

    # --- per-leg swing/stance command writing ---
    in_swing = swing_states > 0
    start_swing = torch.logical_and(in_swing, loco.first_swing)
    p0 = torch.where(start_swing[..., None], p_foot, p0)

    swing_p, swing_v, _ = bezier.swing_trajectory(
        p0, pf, swing_height[..., None], swing_states, swing_times)
    # stance legs reuse the last computed sample
    p_des_foot = torch.where(in_swing[..., None], swing_p,
                             loco.swing_memory[:, 0])
    v_des_foot = torch.where(in_swing[..., None], swing_v,
                             loco.swing_memory[:, 1])
    new_swing_memory = torch.stack([p_des_foot, v_des_foot], dim=1)

    p_des_leg = p_des_foot - position[:, None, :] - hips
    v_des_leg = v_des_foot - se.v_body[:, None, :]

    kp_swing, kd_swing, kd_stance = _swing_gains(dev)
    zero33 = torch.zeros((), dtype=dt, device=dev)
    kp_cart = torch.where(in_swing[..., None, None], kp_swing, zero33)
    kd_cart = kd_swing.expand(b, 4, 3, 3)
    force_ff = torch.where(in_swing[..., None], zero33, f_ff)
    kd_joint = torch.where(in_swing[..., None, None], zero33, kd_stance)

    cmds = zero_leg_commands(b, dev)._replace(
        p_des=p_des_leg, v_des=v_des_leg, kp_cart=kp_cart, kd_cart=kd_cart,
        force_ff=force_ff, kd_joint=kd_joint)

    # swing legs have consumed their first-swing init; stance legs re-arm
    first_swing_new = torch.logical_not(in_swing)
    se_contact = torch.where(in_swing, torch.zeros_like(contact_states),
                             contact_states)
    est = est._replace(contact_phase=se_contact)

    new_loco = LocomotionState(
        iteration_counter=counter_new,
        first_run=torch.zeros_like(loco.first_run),
        first_swing=first_swing_new,
        swing_time_remaining=swing_remaining,
        p0=p0, pf=pf, f_ff=f_ff, swing_memory=new_swing_memory,
        qp_state=qp_state)

    metrics = {
        "contact_states": contact_states,
        "swing_states": swing_states,
        "f_ff": f_ff,
        "com_z": est.com_z,
        "qp_primal_violation": qp_diag["primal_violation"],
        "qp_diverged": diverged,
        # per-solve OSQP relative residuals (0 on non-solve ticks)
        "qp_pri_res": qp_diag["pri_res"],
        "qp_dua_res": qp_diag["dua_res"],
        "mpc_loss": qp_diag["mpc_loss"],
    }
    return new_loco, est, cmds, metrics
