"""A/B evaluation: a trained weight policy against the default MPC weights.

Counterpart of ``rl_mpc_locomotion_tpu/rl/evaluate.py``. Both arms run the
training env (same reward, command distribution, domain randomisation and
initial states, from one seed) and report the mean tracking reward, the
survival rate, the falls and the velocity error.

Arms:
  policy   action = the policy's deterministic mean -> ``rescale_actions``
  default  weights = ``params.mpc_weights`` as they are (past the action
           box, which cannot represent them), action 0

The loop is a Python loop of ``env.step`` over the batch. The QP gate is
the Python bool ``(t + 1) % iterations_between_mpc == 0`` of the loop
counter (every env's MPC counter is aligned with the global tick, also
after an auto-reset). The metrics accumulate on the device and are read
back once, at the end; nothing in a step reads the device. The loop runs
under ``torch.no_grad``.

Randomness: the env's draws (reset, auto-resets, domain randomisation) come
from one generator, ``utils/seeding.key(seed, device, stream=1)`` (the env
stream of ``rl/train``), so the two arms start from the same states.
``initial_state=`` starts from a given batch instead (a test feeds the JAX
package's reset).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..control.weight_policy import policy_mean
from ..models.actor_critic import ActorCritic
from ..models.robots import RobotParams
from ..ops import rotations as rot
from ..sim import env as env_mod
from ..sim import terrain as terrain_mod
from ..utils import seeding

ENV_STREAM = 1


def evaluate(params: RobotParams, cfg, ter: terrain_mod.Terrain,
             policy_params: Optional[dict] = None,
             model: Optional[ActorCritic] = None,
             num_envs: int = 64, num_steps: int = 500, seed: int = 0,
             commands=None, initial_state: Optional[env_mod.EnvState] = None
             ) -> dict:
    """Run one arm for ``num_steps`` steps over ``num_envs`` envs.

    ``policy_params`` None runs the default-weight arm; otherwise the
    policy's parameters by name (``WeightPolicy.params``), applied to
    ``model``. ``commands`` (3,) pins every env to one command (a sweep
    point), also after auto-resets; None keeps the env's random draws (the
    training distribution). The run takes place on the device of
    ``params`` (``ter`` and ``model`` must be there too).

    Returns Python floats: reward_per_step, survival_rate (the share of
    envs that never fell; auto-resets after a fall keep counting), falls,
    lin_vel_err (mean |v_xy - cmd_xy| in the body frame), and num_envs,
    num_steps.
    """
    dev = params.mpc_weights.device
    ipm = cfg.control.iterations_between_mpc
    gen = seeding.key(seed, dev, stream=ENV_STREAM)
    if initial_state is None:
        state = env_mod.reset(params, cfg, gen, 0, batch=num_envs,
                              device=dev)
    else:
        state = initial_state
        num_envs = state.progress.shape[0]
    pinned = (None if commands is None else torch.as_tensor(
        commands, dtype=torch.float32, device=dev).expand(num_envs, 3))
    if policy_params is not None and model is None:
        model = ActorCritic(num_actions=env_mod.NUM_ACTIONS,
                            num_obs=env_mod.num_obs(cfg)).to(dev)
    zeros = torch.zeros((num_envs, env_mod.NUM_ACTIONS), dtype=torch.float32,
                        device=dev)
    default_w = params.mpc_weights.to(torch.float32).expand(num_envs, 13)

    rew_sum = torch.zeros((), dtype=torch.float64, device=dev)
    verr_sum = torch.zeros((), dtype=torch.float64, device=dev)
    falls = torch.zeros((), dtype=torch.int64, device=dev)
    fell = torch.zeros(num_envs, dtype=torch.bool, device=dev)
    with torch.no_grad():
        if pinned is not None:
            state = state._replace(commands=pinned)
        obs = env_mod.observations(params, cfg, state)
        for t in range(num_steps):
            gate = (t + 1) % ipm == 0
            if policy_params is not None:
                mean = policy_mean(model, policy_params, obs)
                state, obs, rew, done, info = env_mod.step(
                    params, cfg, ter, state, mean, gen, solve_gate=gate)
            else:
                state, obs, rew, done, info = env_mod.step(
                    params, cfg, ter, state, zeros, gen, solve_gate=gate,
                    weights=default_w)
            # only true falls count against survival: a timeout is a
            # success, so an eval longer than an episode stays meaningful
            fell |= info["fall"]
            falls += info["fall"].sum()
            if pinned is not None:
                # fresh resets draw random commands
                state = state._replace(commands=pinned)
            v_b = (_quat_rot(state.phys.quat)
                   @ state.phys.v[..., None])[..., 0]
            verr = torch.linalg.vector_norm(
                v_b[:, :2] - state.commands[:, :2], dim=-1)
            rew_sum += rew.sum(dtype=torch.float64)
            verr_sum += verr.sum(dtype=torch.float64)
        n = float(num_envs * num_steps)
        # the one read-back of the run
        rew_mean, verr_mean, n_falls, n_fell = torch.stack([
            rew_sum / n, verr_sum / n, falls.to(torch.float64),
            fell.sum().to(torch.float64)]).tolist()
    return {"reward_per_step": rew_mean, "falls": n_falls,
            "survival_rate": 1.0 - n_fell / num_envs,
            "lin_vel_err": verr_mean,
            "num_envs": num_envs, "num_steps": num_steps}


def _quat_rot(quat):
    return rot.quat_to_rot(quat)


def _mean_ci95(vals):
    """(mean, 95 % CI half-width) over independent seed runs (normal
    approximation; with <= 5 seeds it understates slightly: the CI is a
    margin indicator, not a hypothesis test)."""
    n = len(vals)
    m = sum(vals) / n
    if n < 2:
        return m, 0.0
    var = sum((v - m) ** 2 for v in vals) / (n - 1)
    return m, 1.96 * math.sqrt(var / n)


def _aggregate(runs, seeds):
    """Per-seed eval dicts -> means + ci95 under the original keys."""
    out = {}
    for k in ("reward_per_step", "survival_rate", "falls", "lin_vel_err"):
        m, ci = _mean_ci95([r[k] for r in runs])
        out[k] = m
        out[k + "_ci95"] = ci
    out["num_envs"] = runs[0]["num_envs"]
    out["num_steps"] = runs[0]["num_steps"]
    out["seeds"] = list(seeds)
    out["per_seed"] = runs
    return out


def win_criteria(policy: dict, default: dict) -> dict:
    """Reward AND no regression in survival (1 point of margin) and falls
    (5 % + 1): a policy that scores more reward by falling more is not
    deployable."""
    return {
        "reward": policy["reward_per_step"] >= default["reward_per_step"],
        "survival": policy["survival_rate"] >= default["survival_rate"] - 0.01,
        "falls": policy["falls"] <= default["falls"] * 1.05 + 1.0,
    }


def ab_compare(params: RobotParams, cfg, ter, policy_params,
               model: Optional[ActorCritic] = None, num_envs: int = 64,
               num_steps: int = 500, seed: int = 0,
               command_sweep=None, seeds=None,
               default_runs=None) -> dict:
    """Both arms under identical conditions; an optional command sweep and
    multi-seed aggregation.

    ``seeds``: eval seeds (None = (seed,)); means +- 95 % CI per arm.
    ``default_runs``: the default arm's per-seed ``evaluate`` results, if
    the caller has them (the default arm does not depend on the policy).
    Returns {"policy", "default", "sweep" (with a sweep),
    "win_criteria", "policy_beats_default"}.
    """
    if seeds is None:
        seeds = (seed,)

    def run(pp, s, commands=None):
        return evaluate(params, cfg, ter, pp, model, num_envs, num_steps, s,
                        commands=commands)

    if default_runs is None:
        default_runs = [run(None, s) for s in seeds]
    res = {
        "policy": _aggregate([run(policy_params, s) for s in seeds], seeds),
        "default": _aggregate(list(default_runs), seeds),
    }
    if command_sweep is not None:
        res["sweep"] = [{
            "command": [float(c) for c in cmd],
            "policy": run(policy_params, seed, cmd),
            "default": run(None, seed, cmd),
        } for cmd in command_sweep]
    crit = win_criteria(res["policy"], res["default"])
    res["win_criteria"] = crit
    res["policy_beats_default"] = all(crit.values())
    return res
