"""Training campaigns: train -> multi-seed A/B eval -> run directory.

Counterpart of ``scripts/run_campaigns.py``: each campaign reproduces the
reference's training condition (512 envs, rough random-uniform terrain,
slope-aware MPC, 5000 PPO iterations) with the command-magnitude
curriculum, the obs / action stream-noise domain randomisation and, for the
mixed campaign, robot-one-hot observations so that one policy serves a
heterogeneous batch. Training is ``rl/train.train`` and the eval
``rl/evaluate.ab_compare``, both under the production QP configuration, so
the fused chain-QP kernel runs in every rollout and both eval arms on the
card (its plain version on CPU tensors).

A run lands in ``runs_torch/<name>/`` (git-ignored; the committed
``artifacts/<name>/`` are the JAX package's and are not written): model_<i>
checkpoints (+ env snapshots), metrics.jsonl, reward_curve.png where
matplotlib is installed, eval_ab[_<robot>].json (3-seed mean +- 95 % CI,
survival-gated win criterion).

Usage:
  python -m rl_mpc_locomotion_tpu_torch.scripts.run_campaigns \\
      aliengo_flat aliengo_rough ... [--device cpu] [--iterations N] \\
      [--num-envs N] [--eval-envs N] [--eval-steps N]
  python -m rl_mpc_locomotion_tpu_torch.scripts.run_campaigns --list
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import time

from ..control.types import ControlConfig
from ..models import robots
from ..ops.qp import production_qp_config
from ..sim import physics
from ..sim import terrain as terrain_mod
from ..sim.env import EnvConfig
from ..sim.randomize import DomainRandomization, RandomizationSpec

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RUNS_DIR = os.path.join(REPO_ROOT, "runs_torch")

# the DR recipe: physics / robot draws + obs / action stream noise
# (cfg/dr_rough.yaml is the YAML form of the same recipe)
DR_SPECS = (
    ("physics.friction_mu", RandomizationSpec(range_=(0.6, 1.3))),
    ("robot.body_mass", RandomizationSpec(range_=(0.9, 1.15))),
    ("physics.joint_damping", RandomizationSpec(range_=(0.8, 1.3))),
    ("physics.contact_kn", RandomizationSpec(range_=(0.7, 1.4))),
    ("action.noise", RandomizationSpec(
        distribution="gaussian", operation="additive", range_=(0.0, 0.02),
        range_correlated=(0.0, 0.005))),
    ("obs.noise", RandomizationSpec(
        distribution="gaussian", operation="additive", range_=(0.0, 0.02),
        range_correlated=(0.0, 0.005))),
)

ROBOT_PARAMS = {"aliengo": robots.aliengo_params, "go1": robots.go1_params,
                "a1": robots.a1_params}


def env_config(terrain: str, dr: bool, curriculum: bool,
               robot: str | None = None, obs_robot_id: bool = False,
               leg_coupling: bool = False) -> EnvConfig:
    kw = {}
    if robot == "a1" or robot == "go1":
        kw["base_init_height"] = 0.3
    return EnvConfig(
        control=ControlConfig(qp=production_qp_config(),
                              flat_ground=(terrain == "flat")),
        dr=DomainRandomization(specs=DR_SPECS) if dr else None,
        command_curriculum_ticks=30000 if curriculum else 0,
        command_curriculum_start=0.2,
        obs_robot_id=obs_robot_id,
        physics=physics.PhysicsConfig(leg_coupling=leg_coupling),
        **kw)


@dataclasses.dataclass
class Campaign:
    name: str
    robot: str               # 'aliengo' | 'go1' | 'a1' | 'mixed'
    terrain: str = "rough"
    iterations: int = 5000
    dr: bool = True
    curriculum: bool = True
    obs_robot_id: bool = False
    leg_coupling: bool = False
    num_envs: int = 512
    seed: int = 1


CAMPAIGNS = {
    # the flat-terrain run
    "aliengo_flat": Campaign("aliengo_weight_policy", "aliengo",
                             terrain="flat", iterations=2000, dr=False,
                             curriculum=False),
    "aliengo_rough": Campaign("aliengo_weight_policy_rough", "aliengo"),
    "go1_rough": Campaign("go1_weight_policy_rough", "go1"),
    "a1_rough": Campaign("a1_weight_policy_rough", "a1"),
    "mixed_rough": Campaign("mixed_weight_policy_rough", "mixed",
                            obs_robot_id=True),
    # the higher-fidelity plant: trained on the leg-inertia-coupled dynamics
    "aliengo_coupled": Campaign("aliengo_weight_policy_coupled", "aliengo",
                                leg_coupling=True, iterations=3000),
}


def make_terrain(name: str, device=None):
    from ..control.runner import _resolve_device
    return {"flat": terrain_mod.flat, "rough": terrain_mod.random_uniform,
            "slope": terrain_mod.slope_platform,
            "stairs": terrain_mod.stairs}[name](
                device=_resolve_device(device))


def train_params(c: Campaign, device=None):
    """The campaign's RobotParams: one robot's, or for ``mixed`` a per-env
    batch cycling Aliengo, Go1 and A1."""
    from ..control.runner import _resolve_device
    from ..rl import train as train_mod
    dev = _resolve_device(device)
    if c.robot == "mixed":
        ids = ([0, 1, 2] * (c.num_envs // 3 + 1))[:c.num_envs]
        return train_mod.stacked_robot_params(ids, dev)
    return ROBOT_PARAMS[c.robot](dev)


def train_campaign(c: Campaign, out_dir: str, device=None):
    from ..rl import train as train_mod
    from ..rl.ppo import PPOConfig
    ecfg = env_config(c.terrain, c.dr, c.curriculum,
                      robot=(None if c.robot == "mixed" else c.robot),
                      obs_robot_id=c.obs_robot_id,
                      leg_coupling=c.leg_coupling)
    cfg = train_mod.TrainConfig(num_envs=c.num_envs,
                                max_iterations=c.iterations, seed=c.seed,
                                ppo=PPOConfig(), env=ecfg)
    t0 = time.time()
    _, history = train_mod.train(train_params(c, device), cfg,
                                 make_terrain(c.terrain, device),
                                 checkpoint_dir=out_dir, log_dir=out_dir,
                                 device=device)
    print(f"[campaign {c.name}] trained {c.iterations} it in "
          f"{time.time() - t0:.0f}s")
    return history


def eval_campaign(c: Campaign, out_dir: str, seeds=(0, 1, 2),
                  num_envs=64, num_steps=1000, device=None):
    """Multi-seed A/B on the training env (curriculum off: the full command
    distribution) a robot; survival-gated win criterion."""
    from ..control.runner import _resolve_device
    from ..control.weight_policy import WeightPolicy
    from ..rl import evaluate as eval_mod
    from ..sim.env import num_obs

    dev = _resolve_device(device)
    eval_robots = (["aliengo", "go1", "a1"] if c.robot == "mixed"
                   else [c.robot])
    results = {}
    for robot in eval_robots:
        ecfg = env_config(c.terrain, c.dr, curriculum=False, robot=robot,
                          obs_robot_id=c.obs_robot_id,
                          leg_coupling=c.leg_coupling)
        policy = WeightPolicy(checkpoint=out_dir, num_obs=num_obs(ecfg),
                              device=dev)
        res = eval_mod.ab_compare(ROBOT_PARAMS[robot](dev), ecfg,
                                  make_terrain(c.terrain, dev),
                                  policy.params, policy.model,
                                  num_envs=num_envs, num_steps=num_steps,
                                  seeds=seeds)
        suffix = f"_{robot}" if c.robot == "mixed" else ""
        with open(os.path.join(out_dir, f"eval_ab{suffix}.json"), "w") as f:
            json.dump(res, f, indent=1)
        p, d = res["policy"], res["default"]
        print(f"[campaign {c.name}] eval {robot}: "
              f"reward {p['reward_per_step']:.5f}"
              f"+-{p['reward_per_step_ci95']:.5f} "
              f"vs {d['reward_per_step']:.5f}"
              f"+-{d['reward_per_step_ci95']:.5f} | "
              f"survival {p['survival_rate']:.3f} "
              f"vs {d['survival_rate']:.3f} | "
              f"falls {p['falls']:.0f} vs {d['falls']:.0f} | "
              f"win={res['policy_beats_default']} {res['win_criteria']}")
        results[robot] = res
    return results


def plot_curve(out_dir: str):
    """reward_curve.png from metrics.jsonl; skipped without matplotlib (the
    GPU machine has none), and a plotting error never ends a campaign."""
    try:
        import matplotlib
    except ImportError:
        print("[campaign] reward_curve skipped: no matplotlib here")
        return
    try:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(ln) for ln in f]
        its = [r["train/iter"] for r in rows]
        rew = [r["train/mean_reward"] for r in rows]
        fig, ax = plt.subplots(figsize=(7, 3.5))
        ax.plot(its, rew)
        ax.set_xlabel("PPO iteration")
        ax.set_ylabel("reward / step")
        ax.set_title(os.path.basename(out_dir))
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "reward_curve.png"), dpi=110)
        plt.close(fig)
    except Exception as exc:  # plotting must never end a campaign
        print(f"[campaign] reward_curve failed: {exc!r}")


def remove_checkpoints(out_dir: str, keep) -> None:
    """Delete every model_<i> (and its _env snapshot) of ``out_dir`` whose
    name ``keep(name, step)`` rejects."""
    for entry in os.listdir(out_dir):
        if not entry.startswith("model_"):
            continue
        if not keep(entry, int(entry.split("_")[1])):
            os.remove(os.path.join(out_dir, entry))


def run(key: str, device=None, runs_dir: str = RUNS_DIR,
        iterations: int | None = None, num_envs: int | None = None,
        eval_envs: int = 64, eval_steps: int = 1000,
        eval_seeds=(0, 1, 2)) -> str:
    """Train, plot, evaluate and prune one campaign; returns its run
    directory. ``iterations`` / ``num_envs`` override the campaign's."""
    c = CAMPAIGNS[key]
    c = dataclasses.replace(
        c, iterations=iterations or c.iterations,
        num_envs=num_envs or c.num_envs)
    out_dir = os.path.join(runs_dir, c.name)
    if os.path.isdir(out_dir):
        previous = out_dir + ".previous"
        shutil.rmtree(previous, ignore_errors=True)
        shutil.move(out_dir, previous)
    os.makedirs(out_dir, exist_ok=True)
    train_campaign(c, out_dir, device)
    plot_curve(out_dir)
    eval_campaign(c, out_dir, seeds=eval_seeds, num_envs=eval_envs,
                  num_steps=eval_steps, device=device)
    # keep the final checkpoint and the last few candidates, so that
    # extend_and_select can pick a better snapshot without retraining
    keep_from = (c.iterations // 100 - 5) * 100
    remove_checkpoints(out_dir, lambda _, step: step > keep_from)
    print(f"[campaign {key}] run at {out_dir}")
    return out_dir


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("campaigns", nargs="*")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--runs-dir", default=RUNS_DIR)
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--eval-envs", type=int, default=64)
    ap.add_argument("--eval-steps", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if args.list or not args.campaigns:
        print("campaigns:", ", ".join(CAMPAIGNS))
        return
    for key in args.campaigns:
        run(key, args.device, args.runs_dir, args.iterations, args.num_envs,
            args.eval_envs, args.eval_steps)


if __name__ == "__main__":
    main()
