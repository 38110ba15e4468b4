"""Weak scaling of the data-parallel PPO train step over cards ->
MULTIDEV_torch.json.

Counterpart of ``scripts/multidev_scaling.py``, which measures the sharded
step on a virtual CPU device mesh; here the step runs on real cards, one
process a card (``torchrun --nproc-per-node n``), each with a fixed number
of envs (``ENVS_PER_DEVICE``), through ``rl/train.make_train_step(mesh=)``
(the rollout with the fused chain-QP kernel in every second env step, then
the update with one all-reduce of the gradients). Configuration: the
training benchmark's (``bench.train_config``: rough terrain, domain
randomisation, the default ``PPOConfig``, 24 rollout steps).

Every rank runs one warm-up iteration before the timed window (it builds
the kernels and fills the caches), then ``TIMED_ITERS`` iterations, each
between two CUDA events on the rank's card. For each n a row records
``iter_ms`` (the slowest rank's mean), ``env_steps_per_s`` (global envs x
rollout steps over ``iter_ms``), ``weak_scaling_efficiency`` (t_1 / t_n)
and the JAX file's ``sharding_overhead_pct`` against one card running the
same global batch without a mesh.

Usage:
  python -m rl_mpc_locomotion_tpu_torch.scripts.multidev_scaling
      [--counts 1,2,4] [--envs-per-device 4096] [--out PATH]
      [--device cpu]
  torchrun --standalone --nproc-per-node N -m \\
      rl_mpc_locomotion_tpu_torch.scripts.multidev_scaling --worker N
Counts above the cards present are skipped; ``--device cpu`` runs gloo
ranks on the CPU (plain versions, host clock, ``cpu_`` names).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "rl_mpc_locomotion_tpu_torch.scripts.multidev_scaling"
ENVS_PER_DEVICE = 4096      # bench.train_sweep's largest env count
ROLLOUT_STEPS = 24          # the production rsl_rl schedule
WARMUP_ITERS = 1
TIMED_ITERS = 5


def _worker(n_devices: int, envs_per_device: int = ENVS_PER_DEVICE,
            timed_iters: int = TIMED_ITERS, device_type: str = "cuda",
            sharded: bool = True, rollout_steps: int = ROLLOUT_STEPS
            ) -> dict:
    """This process's part of one measurement. ``sharded``: the train step
    over a mesh of ``n_devices`` ranks (this process one of them, as
    ``torchrun`` starts it; a group of one without it), ``envs_per_device``
    envs each; otherwise one device without a mesh running
    ``envs_per_device`` envs. Returns the row (on every rank)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from .. import bench
    from ..models import robots
    from ..models.actor_critic import ActorCritic
    from ..ops.cuda import fused_qp
    from ..ops.qp import production_qp_config
    from ..parallel import distributed
    from ..rl import ppo
    from ..rl import train as train_mod
    from ..sim import env as env_mod
    from ..sim import terrain
    from ..utils import seeding

    on_gpu = device_type == "cuda"
    mesh = None
    if sharded:
        distributed.initialize(backend="nccl" if on_gpu else "gloo")
        dev = distributed.local_device() if on_gpu else torch.device("cpu")
        mesh = distributed.global_env_mesh(device_type)
        if mesh.size() != n_devices:
            raise RuntimeError(f"{mesh.size()} ranks, {n_devices} asked for: "
                               f"run under torchrun --nproc-per-node "
                               f"{n_devices}")
        rank = dist.get_rank()
    else:
        dev = torch.device("cuda", 0) if on_gpu else torch.device("cpu")
        rank = 0
    try:
        global_envs = envs_per_device * (n_devices if sharded else 1)
        cfg = bench.train_config(global_envs, "rough", True, dev)
        # the production QP configuration, the kernel's plain version on
        # CPU tensors
        cfg = dataclasses.replace(
            cfg, ppo=dataclasses.replace(cfg.ppo, num_steps=rollout_steps),
            env=dataclasses.replace(cfg.env, control=dataclasses.replace(
                cfg.env.control, qp=production_qp_config())))
        params = robots.aliengo_params(dev)
        ter = terrain.random_uniform(device=dev)
        num_obs = env_mod.num_obs(cfg.env)
        model = ActorCritic(num_actions=env_mod.NUM_ACTIONS,
                            num_obs=num_obs).to(dev)
        ts = ppo.init_train_state(seeding.key(cfg.seed, dev, stream=0),
                                  model, num_obs, cfg.ppo)
        env_gen = seeding.key(cfg.seed, dev, stream=1 + rank)
        step_fn, reset_fn = train_mod.make_train_step(params, cfg, ter,
                                                      model, mesh)
        es, obs = reset_fn(env_gen)
        tick = 0
        for _ in range(WARMUP_ITERS):
            ts, es, obs, tick, metrics = step_fn(ts, es, obs, tick, env_gen)
        if on_gpu:
            torch.cuda.synchronize(dev)
        if mesh is not None:
            dist.barrier()
        launches0 = fused_qp.launch_count("fused_solve_chain")
        marks = bench._Marks(dev)
        for _ in range(timed_iters):
            marks.mark()
            ts, es, obs, tick, metrics = step_fn(ts, es, obs, tick, env_gen)
        marks.mark()
        times = marks.intervals_ms()
        launches = fused_qp.launch_count("fused_solve_chain") - launches0
        finite = bool(torch.isfinite(torch.stack(
            [v.float() for v in metrics.values()])).all())
        mine = torch.tensor([sum(times) / len(times), float(finite)],
                            dtype=torch.float64, device=dev)
        if mesh is not None:
            every = [torch.zeros_like(mine) for _ in range(mesh.size())]
            dist.all_gather(every, mine)
        else:
            every = [mine]
        per_rank = [float(v[0]) for v in every]
        iter_ms = max(per_rank)
        row = {"n_devices": n_devices if sharded else 1,
               "envs_per_device": envs_per_device,
               "global_envs": global_envs, "rollout_steps": rollout_steps,
               "sharded": sharded,
               **bench._named(on_gpu, {
                   "iter_ms": iter_ms, "iter_ms_per_rank": per_rank,
                   "env_steps_per_s": global_envs * rollout_steps
                   / (iter_ms * 1e-3)}),
               "warmup_iters": WARMUP_ITERS, "timed_iters": timed_iters,
               "row1_launches_per_iteration": launches / timed_iters,
               "metrics_finite": all(bool(v[1]) for v in every),
               **bench._environment(dev)}
    finally:
        if mesh is not None:
            distributed.shutdown()
    if rank == 0:
        print("ROW " + json.dumps(row), flush=True)
    return row


def _run(cmd, timeout=1800) -> dict:
    out = subprocess.run(cmd, capture_output=True, text=True,
                         cwd=REPO_ROOT, timeout=timeout)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("ROW ")]
    if out.returncode != 0 or not line:
        print(out.stdout[-3000:])
        print(out.stderr[-3000:])
        raise RuntimeError(f"worker failed: {' '.join(cmd)}")
    return json.loads(line[-1][4:])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--counts", default="1,2,4")
    ap.add_argument("--envs-per-device", type=int, default=ENVS_PER_DEVICE)
    ap.add_argument("--timed-iters", type=int, default=TIMED_ITERS)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="default: MULTIDEV_torch.json at the repo root")
    ap.add_argument("--device", default=None,
                    help="default: the GPUs; 'cpu' runs gloo ranks")
    ap.add_argument("--worker", type=int, default=None, metavar="N",
                    help="run one rank of an N-rank measurement")
    ap.add_argument("--single", action="store_true",
                    help="with --worker N: one device, no mesh, N x "
                         "--envs-per-device envs")
    args = ap.parse_args(argv)
    import torch
    device_type = "cpu" if args.device == "cpu" else "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: multidev_scaling measures cards "
                         "unless --device cpu is passed")
    if args.worker is not None:
        n = args.worker
        envs = args.envs_per_device * (n if args.single else 1)
        return _worker(n, envs, args.timed_iters, device_type,
                       not args.single)
    available = (torch.cuda.device_count() if device_type == "cuda"
                 else os.cpu_count())
    counts = [int(c) for c in args.counts.split(",")]
    skipped = [n for n in counts if n > available]
    common = ["--envs-per-device", str(args.envs_per_device),
              "--timed-iters", str(args.timed_iters)]
    if device_type == "cpu":
        common += ["--device", "cpu"]
    rows = []
    for n in (c for c in counts if c <= available):
        row = _run([sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", str(n), "-m", MODULE,
                    "--worker", str(n)] + common)
        single = _run([sys.executable, "-m", MODULE, "--worker", str(n),
                       "--single"] + common)
        pre = "" if device_type == "cuda" else "cpu_"
        row[pre + "single_device_same_global_batch_ms"] = single[
            pre + "iter_ms"]
        row[pre + "sharding_overhead_pct"] = 100.0 * (
            row[pre + "iter_ms"] - single[pre + "iter_ms"]) / single[
            pre + "iter_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    pre = "" if device_type == "cuda" else "cpu_"
    t1 = next((r[pre + "iter_ms"] for r in rows if r["n_devices"] == 1),
              None)
    for r in rows:
        r[pre + "weak_scaling_efficiency"] = (
            None if t1 is None else t1 / r[pre + "iter_ms"])
    result = {
        "description": "weak scaling of the data-parallel PPO train step "
                       "(rl/train.make_train_step(mesh=)), one process a "
                       "card, fixed envs a card; sharding_overhead_pct "
                       "against one card running the same global batch "
                       "without a mesh",
        "platform": device_type, "cards_present": available,
        "counts_skipped": skipped, "rows": rows,
        "unmeasured": ([f"n = {n}: {available} card(s) present"
                        for n in skipped] if skipped else [])}
    path = args.out or os.path.join(REPO_ROOT, "MULTIDEV_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
