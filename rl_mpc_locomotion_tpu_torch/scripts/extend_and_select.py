"""Extend a campaign's training and pick the deployment checkpoint by eval.

Counterpart of ``scripts/extend_and_select.py``. PPO on these envs does not
improve monotonically, so the last checkpoint of a run is often not its
best policy. The protocol, with a seed split so that selection cannot
overfit the report:

1. resume the campaign's run and train ``--extra`` more iterations,
   saving every ``save_interval`` (a true continuation: the env snapshot
   and the tick are restored),
2. A/B-evaluate every candidate checkpoint on the selection seeds (0, 1, 2),
3. rank them by (survival-gated wins, survival margin, reward margin)
   (``score``, ``rank``),
4. re-evaluate only the winner on the held-out seeds (3, 4, 5) ->
   eval_ab.json, with a ``selection`` block recording the protocol and
   every candidate's selection scores,
5. delete every other checkpoint.

The default arm does not depend on the checkpoint and runs once a (robot,
seeds). Runs live under ``runs_torch/<name>/`` (``run_campaigns``).

Usage: python -m rl_mpc_locomotion_tpu_torch.scripts.extend_and_select
       go1_rough --extra 500 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

from .run_campaigns import (CAMPAIGNS, ROBOT_PARAMS, RUNS_DIR, env_config,
                            make_terrain, remove_checkpoints, train_params)


def candidates(out_dir: str):
    """Steps of the model_<i> checkpoints in ``out_dir``, ascending."""
    return sorted(int(n.split("_")[1]) for n in os.listdir(out_dir)
                  if n.startswith("model_") and not n.endswith("_env"))


def score(res: dict) -> tuple:
    """(#robot wins, least survival margin, summed reward margin) of one
    checkpoint's {robot: ab_compare result}."""
    wins = sum(r["policy_beats_default"] for r in res.values())
    surv = min(r["policy"]["survival_rate"] - r["default"]["survival_rate"]
               for r in res.values())
    rew = sum(r["policy"]["reward_per_step"] - r["default"]["reward_per_step"]
              for r in res.values())
    return (wins, surv, rew)


def rank(results) -> list:
    """[(score, step, res)] of ``results`` ([(step, res)]), worst first: the
    last entry is the winner (ties go to the later checkpoint)."""
    return sorted(((score(res), step, res) for step, res in results),
                  key=lambda t: (t[0], t[1]))


def selection_record(scored, sel_seeds, hold_seeds, base_step,
                     best_step) -> dict:
    return {
        "protocol": f"best of {len(scored)} checkpoints on seeds "
                    f"{list(sel_seeds)}; reported on held-out seeds "
                    f"{list(hold_seeds)}; mixed score = (#robot wins, min "
                    f"survival margin, sum reward margin)",
        "base_step": base_step, "chosen_step": best_step,
        "candidates": [
            {"step": s,
             "wins": sum(r["policy_beats_default"] for r in res.values()),
             "survival": {rb: r["policy"]["survival_rate"]
                          for rb, r in res.items()},
             "survival_default": {rb: r["default"]["survival_rate"]
                                  for rb, r in res.items()},
             "reward": {rb: r["policy"]["reward_per_step"]
                        for rb, r in res.items()}}
            for _, s, res in scored],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("campaign")
    ap.add_argument("--extra", type=int, default=500)
    ap.add_argument("--sel-seeds", default="0,1,2")
    ap.add_argument("--holdout-seeds", default="3,4,5")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--last-k", type=int, default=0,
                    help="evaluate only the newest K candidates (0 = all)")
    ap.add_argument("--runs-dir", default=RUNS_DIR)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    from ..control.runner import _resolve_device
    from ..control.weight_policy import WeightPolicy
    from ..rl import evaluate as eval_mod
    from ..rl import train as train_mod
    from ..rl.ppo import PPOConfig
    from ..sim.env import num_obs

    dev = _resolve_device(args.device)
    c = CAMPAIGNS[args.campaign]
    out_dir = os.path.join(args.runs_dir, c.name)
    base_step = max(candidates(out_dir))

    # ---- 1. extend (resume = true continuation) ------------------------
    if args.extra > 0:
        ecfg = env_config(c.terrain, c.dr, c.curriculum,
                          robot=(None if c.robot == "mixed" else c.robot),
                          obs_robot_id=c.obs_robot_id,
                          leg_coupling=c.leg_coupling)
        cfg = train_mod.TrainConfig(num_envs=c.num_envs,
                                    max_iterations=args.extra, seed=c.seed,
                                    ppo=PPOConfig(), env=ecfg)
        train_mod.train(train_params(c, dev), cfg, make_terrain(c.terrain,
                                                                dev),
                        checkpoint_dir=out_dir, log_dir=out_dir,
                        resume_from=out_dir, max_iterations=args.extra,
                        device=dev)

    # ---- 2./3. selection over all candidates ---------------------------
    eval_robots = (["aliengo", "go1", "a1"] if c.robot == "mixed"
                   else [c.robot])
    ter = make_terrain(c.terrain, dev)
    sel_seeds = tuple(int(s) for s in args.sel_seeds.split(","))
    hold_seeds = tuple(int(s) for s in args.holdout_seeds.split(","))
    default_cache = {}  # (robot, seeds) -> per-seed default-arm runs

    def ab(step, seeds):
        """{robot: ab_compare result} for one checkpoint."""
        out = {}
        for robot in eval_robots:
            ecfg = env_config(c.terrain, c.dr, curriculum=False, robot=robot,
                              obs_robot_id=c.obs_robot_id,
                              leg_coupling=c.leg_coupling)
            rparams = ROBOT_PARAMS[robot](dev)
            key = (robot, seeds)
            if key not in default_cache:
                default_cache[key] = [
                    eval_mod.evaluate(rparams, ecfg, ter, None, None,
                                      args.envs, args.steps, s)
                    for s in seeds]
            pol = WeightPolicy(
                checkpoint=os.path.join(out_dir, f"model_{step}"),
                num_obs=num_obs(ecfg), device=dev)
            out[robot] = eval_mod.ab_compare(
                rparams, ecfg, ter, pol.params, pol.model,
                num_envs=args.envs, num_steps=args.steps, seeds=seeds,
                default_runs=default_cache[key])
        return out

    cands = candidates(out_dir)
    if args.last_k > 0:
        cands = cands[-args.last_k:]
    results = []
    for step in cands:
        res = ab(step, sel_seeds)
        results.append((step, res))
        for robot, r in res.items():
            p, d = r["policy"], r["default"]
            print(f"model_{step} [{robot}]: win={r['policy_beats_default']} "
                  f"surv {p['survival_rate']:.3f} vs {d['survival_rate']:.3f} "
                  f"rew {p['reward_per_step']:.5f} vs "
                  f"{d['reward_per_step']:.5f}", flush=True)
    scored = rank(results)
    _, best_step, _ = scored[-1]

    # ---- 4. held-out report for the winner only ------------------------
    final = ab(best_step, hold_seeds)
    selection = selection_record(scored, sel_seeds, hold_seeds, base_step,
                                 best_step)
    for robot, r in final.items():
        r["selection"] = selection
        suffix = f"_{robot}" if c.robot == "mixed" else ""
        with open(os.path.join(out_dir, f"eval_ab{suffix}.json"), "w") as f:
            json.dump(r, f, indent=1)
        p, d = r["policy"], r["default"]
        print(f"[extend_and_select {args.campaign}] model_{best_step} "
              f"[{robot}] held-out win={r['policy_beats_default']} "
              f"surv {p['survival_rate']:.3f} vs {d['survival_rate']:.3f} "
              f"falls {p['falls']:.0f} vs {d['falls']:.0f}", flush=True)

    # ---- 5. prune ------------------------------------------------------
    remove_checkpoints(out_dir, lambda _, step: step == best_step)
    return best_step


if __name__ == "__main__":
    main()
