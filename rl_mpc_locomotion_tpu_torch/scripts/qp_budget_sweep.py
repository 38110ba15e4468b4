"""ADMM iteration-budget sweep on the hardest-robot battery -> JSON.

Counterpart of ``scripts/qp_budget_sweep.py``: the share of solves that hit
the divergence fallback and the residual tails, against the ADMM iteration
budget, on a fixed hard battery (A1 by default, rough terrain, domain
randomisation on, the trained weight policy's mean driving, the full
command distribution), so that the production budget is chosen from
closed-loop evidence. Every budget runs the production QP configuration
with ``iters`` replaced, through the fused chain-QP kernel on the card (its
plain version on CPU tensors).

The loop is ``env.step`` over the batch with the gate ``(t + 1) %
iterations_between_mpc == 0`` from the host's step count; the per-tick
telemetry stays on the device and is read back once, at the end.

Usage:
  python -m rl_mpc_locomotion_tpu_torch.scripts.qp_budget_sweep
      [--robot a1] [--iters 24,28,32] [--envs 64] [--steps 1000]
      [--ckpt DIR] [--out PATH] [--device cpu]
Writes ``artifacts/<robot>_qp_budget_torch.json`` unless ``--out`` says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CKPT = os.path.join(REPO_ROOT, "artifacts", "a1_weight_policy_rough")


def _summarize(gates, diverged, pri, dua, num_envs: int) -> dict:
    """The JAX script's statistics (``scripts/qp_budget_sweep.py:78-103``)
    of one run: ``gates`` (T,) bool, ``diverged`` / ``pri`` / ``dua``
    (T, num_envs). The diverged share over solve ticks, and the p99 of
    each residual over solve ticks only, by the JAX file's index rule
    (``v[n - 1 - clip(int((1 - p) * nsolve), 0, n - 1)]`` of the sorted
    values, non-solve ticks as -inf), in float32 as JAX computes it."""
    gates = np.asarray(gates, bool)
    nsolve = np.int32(max(int(gates.sum()), 1) * num_envs)
    mask = gates[:, None]
    p_flat = np.where(mask, np.asarray(pri, np.float32),
                      -np.inf).astype(np.float32).reshape(-1)
    d_flat = np.where(mask, np.asarray(dua, np.float32),
                      -np.inf).astype(np.float32).reshape(-1)

    def pctl(v, p):
        v = np.sort(v)
        idx = int(np.clip(np.int32(np.float32(1.0 - p) * np.float32(nsolve)),
                          0, v.shape[0] - 1))
        return float(v[v.shape[0] - 1 - idx])

    div = np.where(mask, np.asarray(diverged, np.float32), np.float32(0))
    return {"diverged_frac": float(np.float32(div.sum(dtype=np.float32))
                                   / np.float32(nsolve)),
            "pri_p99": pctl(p_flat, 0.99),
            "dua_p99": pctl(d_flat, 0.99)}


def _env_interval(gates, diverged) -> tuple:
    """(mean, 95 % half-width) of the per-env diverged share over solve
    ticks, each env one sample (normal approximation)."""
    from ..rl.evaluate import _mean_ci95
    gates = np.asarray(gates, bool)
    per_env = (np.asarray(diverged, np.float64)[gates].sum(0)
               / max(int(gates.sum()), 1))
    return _mean_ci95([float(v) for v in per_env])


def measure(robot: str, qp_iters: int, num_envs: int, num_steps: int,
            ckpt: str | None, device=None) -> dict:
    """One budget: ``num_envs`` envs of ``robot`` for ``num_steps`` steps.
    Returns the JAX row's keys (``diverged_frac``, ``pri_p99``, ``dua_p99``,
    ``robot``, ``qp_iters``, ``num_envs``, ``num_steps``, ``wall_s``,
    ``policy``) and ``diverged_frac_env_ci95``, the 95 % half-width over
    the envs."""
    from ..control.runner import _resolve_device
    from ..control.types import ControlConfig
    from ..control.weight_policy import WeightPolicy, policy_mean
    from ..models import robots
    from ..ops.qp import production_qp_config
    from ..sim import env as env_mod
    from ..sim import terrain
    from ..sim.env import EnvConfig
    from ..sim.randomize import DomainRandomization
    from ..utils import seeding

    dev = _resolve_device(device)
    params = {"aliengo": robots.aliengo_params, "go1": robots.go1_params,
              "a1": robots.a1_params}[robot](dev)
    qp = production_qp_config()._replace(iters=qp_iters, use_kernel=True)
    kw = {"base_init_height": 0.3} if robot in ("a1", "go1") else {}
    cfg = EnvConfig(control=ControlConfig(qp=qp, flat_ground=False),
                    dr=DomainRandomization(), **kw)
    ter = terrain.random_uniform(device=dev)
    policy = (WeightPolicy(checkpoint=ckpt, num_obs=env_mod.num_obs(cfg),
                           device=dev) if ckpt else None)
    ipm = cfg.control.iterations_between_mpc
    gen = seeding.key(0, dev, stream=1)

    t0 = time.time()
    gates, div, pri, dua = [], [], [], []
    with torch.no_grad():
        state = env_mod.reset(params, cfg, gen, 0, batch=num_envs,
                              device=dev)
        obs = env_mod.observations(params, cfg, state)
        zeros = torch.zeros((num_envs, env_mod.NUM_ACTIONS),
                            dtype=torch.float32, device=dev)
        for t in range(num_steps):
            gate = ((t + 1) % ipm) == 0
            mean = (policy_mean(policy.model, policy.params, obs)
                    if policy is not None else zeros)
            state, obs, _, _, info = env_mod.step(params, cfg, ter, state,
                                                  mean, gen, solve_gate=gate)
            gates.append(gate)
            div.append(info["qp_diverged"])
            pri.append(info["qp_pri_res"])
            dua.append(info["qp_dua_res"])
        # the one read-back of the run
        div, pri, dua = (torch.stack(x).float().cpu().numpy()
                         for x in (div, pri, dua))
    out = _summarize(gates, div, pri, dua, num_envs)
    out.update(robot=robot, qp_iters=qp_iters, num_envs=num_envs,
               num_steps=num_steps, wall_s=round(time.time() - t0, 1),
               policy="trained" if ckpt else "default",
               diverged_frac_env_ci95=_env_interval(gates, div)[1])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot", default="a1")
    ap.add_argument("--iters", default="24,28,32")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="default: artifacts/<robot>_qp_budget_torch.json")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    from ..bench import _environment
    from ..control.runner import _resolve_device
    dev = _resolve_device(args.device)
    rows = []
    for it in (int(x) for x in args.iters.split(",")):
        row = measure(args.robot, it, args.envs, args.steps,
                      args.ckpt if os.path.isdir(args.ckpt) else None, dev)
        print(json.dumps(row), flush=True)
        rows.append(row)
    path = args.out or os.path.join(REPO_ROOT, "artifacts",
                                    f"{args.robot}_qp_budget_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        # wall_s is the host's clock around a whole run
        json.dump({"rows": rows, **_environment(dev), "clock": "host"}, f,
                  indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
