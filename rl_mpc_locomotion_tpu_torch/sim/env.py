"""RL environment: MPC-in-the-loop weight-policy env for a batch, on the
device.

Counterpart of ``rl_mpc_locomotion_tpu/sim/env.py``: the policy action is
the 12 MPC cost weights (rescaled from [-1,1]), the controller
(``runner.min_step``) runs inside the env step, the plant is
``sim.physics``, and observations / rewards / resets follow the JAX
package's. Every ``EnvState`` field carries a leading env axis ``B``.

Randomness: the port's ``EnvState`` carries no key. ``reset`` and ``step``
take one ``torch.Generator`` for the whole batch (on the batch's device, so
that drawing does not synchronise with the host); ``reset_from_draws`` is
``reset`` with the draws given, which a test feeds with the JAX package's.

Nothing in ``step`` reads a tensor back to the host: the auto-reset, the
done mask, the scheduled re-draw and the NaN guard are masked selects. The
QP gate is the caller's Python bool: every env's MPC counter restarts at
the global tick on reset, so ``(t + 1) % iterations_between_mpc == 0`` for
the batch's step count ``t`` is exact.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..control import runner
from ..control.locomotion import _where_tree
from ..control.types import ControlConfig, ControlState
from ..models.robots import RobotParams
from ..ops import rotations as rot
from . import physics, randomize as randomize_mod, terrain as terrain_mod

NUM_OBS = 48
NUM_ACTIONS = 12

# action -> MPC weight mapping
MPC_PARAM_SCALE = torch.tensor([4, 4, 4, 20, 20, 20, 1, 1, 1, 1, 1, 1],
                               dtype=torch.float32)
MPC_PARAM_CONST = torch.tensor([5, 5, 5, 50, 50, 50, 1, 1, 1, 1, 1, 1],
                               dtype=torch.float32)

DEFAULT_DOF_POS = torch.tensor([0.0, 0.8, -1.6], dtype=torch.float32
                               ).repeat(4)

NUM_ROBOT_TYPES = 3  # one-hot width for obs_robot_id (models/robots registry)

_consts = {}


def _const(name, device):
    """One of the module's constant vectors on ``device``, copied once."""
    key = (name, torch.device(device))
    if key not in _consts:
        _consts[key] = {"scale": MPC_PARAM_SCALE, "const": MPC_PARAM_CONST,
                        "dof": DEFAULT_DOF_POS}[name].to(device)
    return _consts[key]


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Task configuration (the reference's task YAML equivalents)."""
    episode_length: int = 2000           # 20 s / 0.01
    command_x_range: tuple = (-2.5, 2.5)
    command_y_range: tuple = (-1.0, 1.0)
    command_yaw_range: tuple = (-2.5, 2.5)
    # command-magnitude curriculum: commands drawn at reset are scaled by
    # ramp(global_tick / curriculum_ticks) from curriculum_start_frac -> 1.
    # 0 disables.
    command_curriculum_ticks: int = 0
    command_curriculum_start: float = 0.2
    # append a one-hot robot-type vector (params.robot_id) to observations
    # so one policy can serve a heterogeneous batch; changes the width to
    # num_obs(cfg)
    obs_robot_id: bool = False
    lin_vel_scale: float = 1.0
    ang_vel_scale: float = 1.0
    dof_pos_scale: float = 1.0
    dof_vel_scale: float = 1.0
    # reward scales (pre-dt), multiplied by the controller dt
    rew_lin_vel_xy: float = 1.0
    rew_ang_vel_z: float = 0.5
    rew_torque: float = -0.000025
    rew_lin_vel_z: float = -4.0
    rew_ang_vel_xy: float = -0.05
    rew_collision: float = 0.0
    clip_obs: float = 5.0
    clip_actions: float = 1.0
    base_init_height: float = 0.4
    gait_id: int = 0
    control: ControlConfig = ControlConfig()
    physics: physics.PhysicsConfig = physics.PhysicsConfig()
    # domain randomisation of the *simulated* physics only: the controller
    # keeps the nominal model. None disables.
    dr: Optional[randomize_mod.DomainRandomization] = None


class EnvState(NamedTuple):
    phys: physics.PhysState
    ctrl: ControlState
    commands: torch.Tensor      # (B,3)
    actions: torch.Tensor       # (B,12) last policy action
    torques: torch.Tensor       # (B,12) last applied torques
    progress: torch.Tensor      # (B,) int32
    global_tick: torch.Tensor   # (B,) int32, aligned MPC schedule
    rand: dict                  # DR draws {target: (B, ...)}


def num_obs(cfg: EnvConfig) -> int:
    """Observation width for this config (NUM_OBS + optional robot one-hot)."""
    return NUM_OBS + (NUM_ROBOT_TYPES if cfg.obs_robot_id else 0)


def _stream_dims(cfg: EnvConfig):
    return {"obs": num_obs(cfg), "action": NUM_ACTIONS}


def _sample_commands(generator, cfg: EnvConfig, batch: int, device):
    """(B,3) commands drawn uniformly from the config's ranges (the
    curriculum is applied by ``reset_from_draws``)."""
    u = torch.rand((batch, 3), generator=generator, device=device)
    ranges = (cfg.command_x_range, cfg.command_y_range,
              cfg.command_yaw_range)
    return torch.stack([lo + (hi - lo) * u[:, i]
                        for i, (lo, hi) in enumerate(ranges)], dim=-1)


def _curriculum(cfg: EnvConfig, commands, global_tick):
    """Commands scaled by the command-magnitude curriculum, if any."""
    if cfg.command_curriculum_ticks > 0:
        s0 = cfg.command_curriculum_start
        ramp = s0 + (1.0 - s0) * torch.clamp(
            global_tick / float(cfg.command_curriculum_ticks), 0.0, 1.0)
        commands = commands * ramp[:, None]
    return commands


def _ticks(global_tick, batch, device):
    """(B,) int32 global ticks from a Python int or a tensor."""
    if isinstance(global_tick, torch.Tensor):
        return global_tick.to(device=device, dtype=torch.int32).expand(
            batch).clone()
    return torch.full((batch,), int(global_tick), dtype=torch.int32,
                      device=device)


def reset(params: RobotParams, cfg: EnvConfig, generator, global_tick=0,
          batch: int = 1, device=None) -> EnvState:
    """Reset ``batch`` envs: dof pos scaled by U[0.5,1.5], vel U[-0.1,0.1],
    fresh commands (and DR draws), controller reset. Draws come from
    ``generator``; ``device`` None means the GPU.

    The MPC iteration counter restarts aligned with the *global* solve
    schedule so a batch-wide solve gate stays valid across resets.
    """
    dev = runner._resolve_device(device)
    ticks = _ticks(global_tick, batch, dev)
    q0_scale = 0.5 + torch.rand((batch, 12), generator=generator, device=dev)
    qd0 = -0.1 + 0.2 * torch.rand((batch, 12), generator=generator,
                                  device=dev)
    commands = _sample_commands(generator, cfg, batch, dev)
    rand = ({} if cfg.dr is None else randomize_mod.sample(
        cfg.dr, cfg.physics, params, generator, ticks, _stream_dims(cfg)))
    return reset_from_draws(params, cfg, q0_scale, qd0, commands, ticks, rand)


def reset_from_draws(params: RobotParams, cfg: EnvConfig, q0_scale, qd0,
                     commands, global_tick, rand: dict) -> EnvState:
    """``reset`` with its draws given: ``q0_scale`` (B,12) in [0.5,1.5],
    ``qd0`` (B,12), ``commands`` (B,3) within the config's ranges (before
    the curriculum), ``global_tick`` (B,) int32 and the DR values ``rand``
    (``randomize.sample``'s output, {} without DR)."""
    b, dev = q0_scale.shape[0], q0_scale.device
    q0 = _const("dof", dev) * q0_scale
    phys = physics.init_state(params, q0, cfg.base_init_height, b, dev)
    phys = phys._replace(qd=qd0)
    ctrl = runner.init_state(params, cfg.control, batch=b, device=dev)
    ctrl = ctrl._replace(loco=ctrl.loco._replace(
        iteration_counter=global_tick.to(torch.int32).clone()))
    return EnvState(
        phys=phys, ctrl=ctrl,
        commands=_curriculum(cfg, commands, global_tick),
        actions=torch.zeros((b, NUM_ACTIONS), dtype=torch.float32,
                            device=dev),
        torques=torch.zeros((b, 12), dtype=torch.float32, device=dev),
        progress=torch.zeros((b,), dtype=torch.int32, device=dev),
        global_tick=global_tick.to(torch.int32),
        rand=rand,
    )


def rescale_actions(actions):
    """[-1,1] (B,12) -> MPC weights (B,13), +0 gravity placeholder."""
    dev = actions.device
    w = (torch.clamp(actions, -1.0, 1.0) * _const("scale", dev)
         + _const("const", dev))
    return torch.cat([w, torch.zeros_like(w[:, :1])], dim=-1)


def _body_frame(ph: physics.PhysState):
    """World linear and angular velocity in the body frame, (B,3) each."""
    r_bw = rot.quat_to_rot(ph.quat)  # world->body
    return ((r_bw @ ph.v[..., None])[..., 0],
            (r_bw @ ph.omega[..., None])[..., 0])


def observations(params: RobotParams, cfg: EnvConfig, state: EnvState):
    """The policy's observation, (B, num_obs(cfg))."""
    ph = state.phys
    v_b, w_b = _body_frame(ph)
    cmd_scaled = torch.cat([state.commands[:, :2] * cfg.lin_vel_scale,
                            state.commands[:, 2:] * cfg.ang_vel_scale], dim=-1)
    dof_pos_scaled = (ph.q - _const("dof", ph.q.device)) * cfg.dof_pos_scale
    obs = torch.cat([
        ph.pos, v_b * cfg.lin_vel_scale, w_b * cfg.ang_vel_scale, cmd_scaled,
        dof_pos_scaled, ph.qd * cfg.dof_vel_scale, state.actions], dim=-1)
    obs = torch.clamp(obs, -cfg.clip_obs, cfg.clip_obs)
    if cfg.obs_robot_id:
        # which robot am I? (robot_id -1 = custom robot -> all zeros)
        types = torch.arange(NUM_ROBOT_TYPES, device=obs.device)
        onehot = (params.robot_id.long()[..., None] == types).to(obs.dtype)
        obs = torch.cat([obs, onehot.expand(obs.shape[0], NUM_ROBOT_TYPES)],
                        dim=-1)
    return obs


def _reward_and_reset(params: RobotParams, cfg: EnvConfig, state: EnvState,
                      knee_contact, base_contact):
    """Reward (B,), fall (B,) and timeout (B,). Scales are pre-multiplied
    by the controller dt."""
    dt = cfg.control.dt
    v_b, w_b = _body_frame(state.phys)
    cmd = state.commands

    lin_err = torch.sum(torch.square(cmd[:, :2] - v_b[:, :2]), dim=-1)
    ang_err = torch.square(cmd[:, 2] - w_b[:, 2])
    rew = (torch.exp(-lin_err / 0.25) * (cfg.rew_lin_vel_xy * dt)
           + torch.exp(-ang_err / 0.25) * (cfg.rew_ang_vel_z * dt)
           + torch.square(v_b[:, 2]) * (cfg.rew_lin_vel_z * dt)
           + torch.sum(torch.square(w_b[:, :2]), dim=-1)
           * (cfg.rew_ang_vel_xy * dt)
           + torch.sum(torch.square(state.torques), dim=-1)
           * (cfg.rew_torque * dt)
           + torch.sum(knee_contact, dim=-1) * (cfg.rew_collision * dt))
    rew = torch.clamp_min(rew, 0.0)

    fall = base_contact | torch.any(knee_contact, dim=-1)
    timeout = state.progress > cfg.episode_length
    return rew, fall, timeout


def step(params: RobotParams, cfg: EnvConfig, ter: terrain_mod.Terrain,
         state: EnvState, action, generator,
         solve_gate: Optional[bool] = None,
         weights: Optional[torch.Tensor] = None):
    """One policy step for the batch = one controller tick + physics.

    ``action`` (B,12) in [-1,1]; ``generator`` draws the stream noise, the
    scheduled re-draws and the auto-reset's draws; ``solve_gate`` is the
    batch's QP gate (see the module docstring). ``weights``: optional raw
    (B,13) MPC weights bypassing the action rescale (the A/B eval path).

    Returns (new_state, obs, reward, done, info); envs that are done are
    reset in place.
    """
    spec_a = cfg.dr.spec("action.noise") if cfg.dr is not None else None
    spec_o = cfg.dr.spec("obs.noise") if cfg.dr is not None else None
    if spec_a is not None:
        action = randomize_mod.apply_stream(
            spec_a, state.rand["action.noise"], action, generator,
            state.global_tick)
        action = torch.clamp(action, -cfg.clip_actions, cfg.clip_actions)

    if weights is None:
        weights = rescale_actions(action)
    body_state = physics.root_state_vector(state.phys)

    new_ctrl, torques, ctrl_metrics = runner.min_step(
        params, cfg.control, state.ctrl, state.phys.q, state.phys.qd,
        body_state, state.commands, mpc_weights=weights,
        gait_id=cfg.gait_id, solve_gate=solve_gate)

    # randomised physics: the simulator steps with each env's DR draw while
    # the controller above used the nominal model
    phys_cfg = randomize_mod.apply_to_config(cfg.physics, state.rand)
    phys_params = randomize_mod.apply_to_params(params, state.rand)
    new_phys, foot_forces, foot_contact = physics.step(
        phys_params, phys_cfg, ter, state.phys, torques)

    # trunk/knee collision: any contact point below terrain
    pts = physics.body_contact_points(params, new_phys)
    ground = terrain_mod.sample_height(ter, pts[..., :2])
    pen = ground - pts[..., 2]
    base_contact = torch.any(pen[:, :4] > 0.0, dim=-1)
    knee_contact = pen[:, 4:] > 0.0

    state = state._replace(
        phys=new_phys, ctrl=new_ctrl, actions=action, torques=torques,
        progress=state.progress + 1, global_tick=state.global_tick + 1)

    # scheduled re-randomisation every `frequency` GLOBAL steps (reset
    # always re-draws, below)
    if cfg.dr is not None and cfg.dr.frequency > 0:
        redraw = (state.global_tick % cfg.dr.frequency) == 0
        fresh_rand = randomize_mod.sample(
            cfg.dr, cfg.physics, params, generator, state.global_tick,
            _stream_dims(cfg))
        state = state._replace(rand=_where_tree(redraw, fresh_rand,
                                                state.rand))

    rew, fall, timeout = _reward_and_reset(params, cfg, state, knee_contact,
                                           base_contact)

    # NaN containment: a physics blowup must stay confined to its env, so
    # force a reset and zero the reward
    ph = state.phys
    finite = torch.isfinite(torch.cat(
        [ph.pos, ph.quat, ph.v, ph.omega, ph.q, ph.qd], dim=-1)).all(dim=-1)
    rew = torch.where(finite, rew, 0.0)
    fall = fall | torch.logical_not(finite)
    done = fall | timeout

    # auto-reset (masked)
    fresh = reset(params, cfg, generator, state.global_tick,
                  batch=done.shape[0], device=done.device)
    state = _where_tree(done, fresh, state)

    obs = observations(params, cfg, state)
    if spec_o is not None:
        obs = randomize_mod.apply_stream(
            spec_o, state.rand["obs.noise"], obs, generator,
            state.global_tick)
        obs = torch.clamp(obs, -cfg.clip_obs, cfg.clip_obs)
    # fall vs timeout are distinct terminations: eval survival counts only
    # true falls
    info = {"torques": torques, "foot_contact": foot_contact,
            "f_ff": ctrl_metrics["f_ff"], "com_z": ctrl_metrics["com_z"],
            "fall": fall, "timeout": timeout,
            # QP convergence telemetry (0 on non-solve ticks)
            "qp_pri_res": ctrl_metrics["qp_pri_res"],
            "qp_dua_res": ctrl_metrics["qp_dua_res"],
            "qp_diverged": ctrl_metrics["qp_diverged"]}
    return state, obs, rew, done, info
