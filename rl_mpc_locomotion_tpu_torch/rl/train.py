"""Training loop: the batched env + PPO, on one card or over a mesh.

Counterpart of ``rl_mpc_locomotion_tpu/rl/train.py`` (the reference's
RL_Environment/train.py + rsl_rl's OnPolicyRunner.learn):

- ``make_train_step(...)`` -> one PPO iteration (a rollout of T steps over
  the B envs, then the update), as eager PyTorch on the device. With a
  mesh (``parallel/mesh``, one process a card) each rank steps its slice
  of the env batch and the gradients and statistics are averaged over the
  ranks, so the policy stays the same on every rank.
- ``train(...)`` -> the outer loop with logging and checkpoints.

Randomness: the JAX file splits its seed into an init key and an env key.
Here ``utils/seeding.key`` makes two generators of the seed on the device:
the policy's (initial parameters, action noise, permutations), held by the
``TrainState``, and the env's (resets, DR draws, stream noise), which
``step_fn`` takes as an argument. Both go into the checkpoint.

Nothing inside an iteration reads the device: the QP gate is a Python bool
from the host's tick counter, and the lr, the non-finite guard and the QP
telemetry's percentiles stay on the device. ``train`` reads the metrics
back every 10 iterations and at the end, and nowhere else.

Over a mesh, rank 0 alone logs and writes checkpoints, holding the policy
and rank 0's env slice only: unlike the JAX package, which saves the
sharded env state from every process, the port has no multi-process
checkpointer, so a resume over more than one rank starts fresh episodes.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch

from ..control.runner import _resolve_device
from ..models import robots
from ..models.actor_critic import ActorCritic
from ..models.robots import RobotParams
from ..parallel.mesh import (ENV_AXIS, pmean, psum_grads, replicate,
                             shard_env_batch)
from ..sim import env as env_mod
from ..sim import terrain as terrain_mod
from ..utils import seeding
from . import ppo


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_envs: int = 512
    max_iterations: int = 5000
    save_interval: int = 100
    seed: int = 1
    ppo: ppo.PPOConfig = ppo.PPOConfig()
    env: env_mod.EnvConfig = env_mod.EnvConfig()


def is_per_env(params: RobotParams) -> bool:
    """Stacked (B, ...) per-env params vs a single robot's scalars."""
    return params.body_mass.dim() == 1


def stacked_robot_params(robot_ids, device=None) -> RobotParams:
    """Per-env RobotParams from robot ids (0=Aliengo, 1=Go1, 2=A1), so one
    training batch mixes A1, Go1 and Aliengo. ``device`` None is the GPU."""
    dev = _resolve_device(device)
    ids = torch.as_tensor(robot_ids, dtype=torch.int32, device=dev)
    return robots.select_robot(robots.robot_registry(dev), ids)


def _to_device(tensors, device):
    """A NamedTuple of tensors (RobotParams, Terrain) on ``device``."""
    return type(tensors)(*[x.to(device) if isinstance(x, torch.Tensor)
                           else x for x in tensors])


def make_env_fns(cfg: TrainConfig, ter: terrain_mod.Terrain):
    """Batched (reset, step) over the env batch. The MPC solve gate is one
    Python bool for the whole batch, from the host's step count ``t``
    (every env's counter is aligned on reset), so no tick reads the
    device."""
    ipm = cfg.env.control.iterations_between_mpc

    def reset_batch(params: RobotParams, generator: torch.Generator):
        state = env_mod.reset(params, cfg.env, generator, 0,
                              batch=cfg.num_envs,
                              device=params.body_mass.device)
        return state, env_mod.observations(params, cfg.env, state)

    def step_batch(params: RobotParams, state, actions, t: int,
                   generator: torch.Generator):
        if isinstance(t, torch.Tensor):
            raise TypeError("t is the host's step count, a Python int")
        return env_mod.step(params, cfg.env, ter, state, actions, generator,
                            solve_gate=((t + 1) % ipm) == 0)

    return reset_batch, step_batch


def qp_telemetry(aux: dict) -> dict:
    """Percentiles of the rollout's QP residuals over its solve ticks only
    (residuals are 0 on ticks without a solve), and the diverged share of
    the solves; 0.0 where the rollout solved nothing. On the device."""
    pri = aux["qp_pri_res"].reshape(-1)
    dua = aux["qp_dua_res"].reshape(-1)
    solved = pri > 0.0
    any_solved = torch.any(solved)
    nsolve = torch.clamp_min(torch.sum(solved), 1)

    def pctl(v, p):
        # non-solve ticks sort to the end; the index is clipped on the
        # device (no host read)
        v_sorted = torch.sort(torch.where(solved, v, -torch.inf),
                              descending=True).values
        idx = torch.clamp(((1.0 - p) * nsolve).to(torch.int64), 0,
                          v.shape[0] - 1)
        return torch.where(any_solved, v_sorted.index_select(
            0, idx.reshape(1))[0], 0.0)

    return {"qp_pri_res_p50": pctl(pri, 0.50),
            "qp_pri_res_p99": pctl(pri, 0.99),
            "qp_dua_res_p50": pctl(dua, 0.50),
            "qp_dua_res_p99": pctl(dua, 0.99),
            "qp_diverged_frac": torch.sum(aux["qp_diverged"]) / nsolve}


def make_train_step(params: RobotParams, cfg: TrainConfig,
                    ter: terrain_mod.Terrain, model: ActorCritic,
                    mesh=None):
    """Returns (step_fn, reset_fn).

    ``step_fn(train_state, env_state, obs, tick, env_generator, noise=None,
    perms=None) -> (train_state, env_state, obs, tick + T, metrics)`` runs
    one iteration; ``tick`` is the host's int step count; ``noise`` and
    ``perms`` give the rollout's and the update's draws (see ``ppo``).
    ``reset_fn(env_generator) -> (env_state, obs)``.

    ``params`` may be one robot's RobotParams or a stacked per-env batch
    (heterogeneous training); the env runs on their device.

    ``mesh`` (``parallel.mesh.make_mesh``): ``cfg.num_envs`` is the global
    batch, each rank resets and steps its ``num_envs / mesh.size()`` envs
    (and its rows of per-env params) from ``env_generator``, ``noise`` and
    ``perms`` are this rank's; the update averages the gradients
    (``psum_grads``) and its statistics over ``ENV_AXIS``, and the QP
    telemetry is the mean of the ranks' percentiles. The train state must
    start equal on every rank (``replicate``)."""
    grad_reduce, axis_name = ppo._identity, None
    if mesh is not None:
        if getattr(mesh, "mesh_dim_names", None) != (ENV_AXIS,):
            raise TypeError(f"mesh must be a 1-D DeviceMesh over "
                            f"{ENV_AXIS!r} (parallel.mesh.make_mesh), got "
                            f"{mesh!r}")
        if cfg.num_envs % mesh.size():
            raise ValueError(f"num_envs {cfg.num_envs} does not divide over "
                             f"{mesh.size()} ranks")
        cfg = dataclasses.replace(cfg, num_envs=cfg.num_envs // mesh.size())
        if is_per_env(params):
            params = shard_env_batch(mesh, params)
        grad_reduce, axis_name = psum_grads, ENV_AXIS
    reset_batch, step_batch = make_env_fns(cfg, ter)

    def step_fn(train_state: ppo.TrainState, env_state, obs, tick: int,
                env_generator: torch.Generator, noise=None, perms=None):
        def env_step(es, actions, t):
            return step_batch(params, es, actions, tick + t, env_generator)

        env_state, obs, traj, aux = ppo.rollout(
            model, env_step, env_state, obs, train_state.generator,
            cfg.ppo.num_steps, noise=noise)
        with torch.no_grad():
            _, _, last_value = model(obs)
        train_state, metrics = ppo.ppo_update(
            model, cfg.ppo, train_state, traj, last_value,
            grad_reduce=grad_reduce, axis_name=axis_name, perms=perms)
        if "qp_pri_res" in aux:
            telemetry = qp_telemetry(aux)
            if axis_name is not None:
                # the ranks' percentiles averaged: every rank logs the same
                telemetry = dict(zip(telemetry, pmean(
                    [v.float() for v in telemetry.values()], axis_name)))
            metrics.update(telemetry)
        return (train_state, env_state, obs, tick + cfg.ppo.num_steps,
                metrics)

    def reset_fn(env_generator: torch.Generator):
        return reset_batch(params, env_generator)

    return step_fn, reset_fn


def resume_train_state(resume_from: str, train_state, log_fn=print):
    """Restore a TrainState from a checkpoint path or run directory.

    Directory without a model_<i> basename -> latest-checkpoint discovery
    (the reference's get_load_path). Returns (train_state, start_iteration,
    path)."""
    from ..utils.checkpoint import latest_checkpoint, restore_checkpoint

    path = resume_from
    base = os.path.basename(os.path.normpath(path))
    if not base.startswith("model_"):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(
                f"no model_<i> checkpoints under {path!r}")
        path = found
    train_state = restore_checkpoint(path, train_state)
    start_it = int(os.path.basename(path).split("_")[1])
    log_fn(f"[train] resumed from {path} (iteration {start_it})")
    return train_state, start_it, path


def train(params: RobotParams, cfg: TrainConfig,
          ter: Optional[terrain_mod.Terrain] = None, mesh=None,
          log_fn=print, checkpoint_dir: Optional[str] = None,
          max_iterations: Optional[int] = None,
          log_dir: Optional[str] = None,
          resume_from: Optional[str] = None, device=None):
    """Outer training loop (OnPolicyRunner.learn equivalent), on ``device``
    (None: the GPU; ``params`` and ``ter`` are moved there).

    ``log_dir`` enables the metrics sink (JSONL + TensorBoard scalars via
    utils/metrics.MetricsWriter). ``checkpoint_dir`` gets a checkpoint
    every ``save_interval`` iterations and after the last one (as rsl_rl's
    learn saves at its end). ``resume_from`` restores the train state (a
    path or a run directory: the latest checkpoint in it) and the env
    snapshot beside it, and runs ``max_iterations`` *additional*
    iterations, numbering on from the restored step.

    ``mesh``: the env batch splits over its ranks (``make_train_step``);
    every rank draws its envs from a stream of its own, the policy's
    generator is the same on all; rank 0 alone logs and checkpoints (see
    the module's docstring).

    Returns (train_state, history): the metrics logged, as floats (empty
    on the other ranks)."""
    from ..utils.checkpoint import restore_env_snapshot, save_checkpoint

    rank = 0 if mesh is None else mesh.get_local_rank(ENV_AXIS)
    world = 1 if mesh is None else mesh.size()
    if rank != 0:
        log_fn, checkpoint_dir, log_dir = (lambda *_: None), None, None
    dev = _resolve_device(device)
    params = _to_device(params, dev)
    ter = (terrain_mod.flat(device=dev) if ter is None
           else _to_device(ter, dev))
    num_obs = env_mod.num_obs(cfg.env)
    model = ActorCritic(num_actions=env_mod.NUM_ACTIONS,
                        num_obs=num_obs).to(dev)
    env_generator = seeding.key(cfg.seed, dev, stream=1 + rank)
    train_state = ppo.init_train_state(seeding.key(cfg.seed, dev, stream=0),
                                       model, num_obs, cfg.ppo)
    start_it = 0
    resume_path = None
    if resume_from:
        train_state, start_it, resume_path = resume_train_state(
            resume_from, train_state, log_fn)
    if mesh is not None:
        replicate(mesh, (train_state.model, train_state.opt_state,
                         train_state.lr))
    step_fn, reset_fn = make_train_step(params, cfg, ter, model, mesh)
    env_state, obs = reset_fn(env_generator)
    tick = 0
    if resume_path is not None and world > 1:
        log_fn("[train] episodes reset: the checkpoint holds no env slices "
               "of a mesh")
    elif resume_path is not None:
        # true continuation: episodes keep progress / commands / DR draws,
        # and the env's generator goes on where it was
        snap = restore_env_snapshot(resume_path, {
            "env": env_state, "obs": obs, "tick": tick,
            "generator": env_generator})
        if snap is not None:
            env_state, obs, tick = snap["env"], snap["obs"], snap["tick"]
            log_fn(f"[train] env state restored (tick {tick})")
        else:
            log_fn("[train] no env snapshot in checkpoint — episodes reset")

    iters = max_iterations or cfg.max_iterations
    history = []
    writer = None
    if log_dir:
        from ..utils.metrics import MetricsWriter
        writer = MetricsWriter(log_dir)
    t0 = time.time()
    end_it = start_it + iters
    try:
        for it in range(start_it, end_it):
            train_state, env_state, obs, tick, metrics = step_fn(
                train_state, env_state, obs, tick, env_generator)
            if rank == 0 and (it % 10 == 0 or it == end_it - 1):
                # the only read-back: every metric in one copy
                m = dict(zip(metrics, torch.stack(
                    [v.float() for v in metrics.values()]).tolist()))
                m["iter"] = it
                m["steps_per_s"] = (cfg.ppo.num_steps * cfg.num_envs
                                    * (it - start_it + 1)
                                    / (time.time() - t0))
                history.append(m)
                if writer is not None:
                    writer.write(it, m, prefix="train/")
                log_fn(f"[train] it={it} reward/step={m['mean_reward']:.4f} "
                       f"kl={m['kl']:.4f} lr={m['lr']:.2e} "
                       f"sps={m['steps_per_s']:.0f}")
            if checkpoint_dir and ((it + 1) % cfg.save_interval == 0
                                   or it == end_it - 1):
                save_checkpoint(checkpoint_dir, it + 1, train_state,
                                env_snapshot=None if world > 1 else {
                                    "env": env_state, "obs": obs,
                                    "tick": tick,
                                    "generator": env_generator})
    finally:
        if writer is not None:
            writer.close()
    return train_state, history
