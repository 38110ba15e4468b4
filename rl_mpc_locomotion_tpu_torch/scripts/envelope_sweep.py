"""Velocity-envelope sweep: where does the gait hold across the command box?

Counterpart of ``scripts/envelope_sweep.py``: every env is pinned to one
(vx, 0, yaw) command a grid point, both arms run (the trained weight policy
against the default MPC weights, ``rl/evaluate.evaluate``), and survival
and velocity-tracking error are recorded a point, on rough terrain with the
slope-aware MPC. The production QP configuration runs the fused chain-QP
kernel on every solve tick on the card (its plain version on CPU tensors).

Output: ``artifacts/<robot>_envelope_torch/envelope.json`` (the JAX file's
keys, written before plotting) and ``envelope.png`` where matplotlib is
installed (``plot``; the GPU machine has none: plot from the JSON
elsewhere with ``--plot-only``).

Usage:
  python -m rl_mpc_locomotion_tpu_torch.scripts.envelope_sweep
      [--ckpt artifacts/aliengo_weight_policy_rough] [--robot aliengo]
      [--envs 64] [--steps 500] [--out-dir DIR] [--device cpu]
  python -m rl_mpc_locomotion_tpu_torch.scripts.envelope_sweep --plot-only DIR
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CKPT = os.path.join(REPO_ROOT, "artifacts",
                            "aliengo_weight_policy_rough")
VX_GRID = np.linspace(-2.5, 2.5, 9)
YAW_GRID = np.linspace(-2.0, 2.0, 5)


def run(ckpt: str, robot: str, num_envs: int, num_steps: int,
        out_dir: str, device=None, vx_grid=VX_GRID,
        yaw_grid=YAW_GRID) -> dict:
    """Both arms at every (vx, yaw) point; writes ``envelope.json`` in
    ``out_dir`` and returns its contents."""
    import torch

    from ..bench import _environment
    from ..control.runner import _resolve_device
    from ..control.types import ControlConfig
    from ..control.weight_policy import WeightPolicy
    from ..models import robots
    from ..ops.qp import production_qp_config
    from ..rl import evaluate as eval_mod
    from ..sim import terrain
    from ..sim.env import EnvConfig

    dev = _resolve_device(device)
    params = {"aliengo": robots.aliengo_params, "go1": robots.go1_params,
              "a1": robots.a1_params}[robot](dev)
    cfg = EnvConfig(control=ControlConfig(qp=production_qp_config(),
                                          flat_ground=False))
    ter = terrain.random_uniform(device=dev)
    policy = WeightPolicy(checkpoint=ckpt, device=dev)

    rows = []
    t0 = time.time()
    for vx in vx_grid:
        for yaw in yaw_grid:
            cmd = torch.tensor([vx, 0.0, yaw], dtype=torch.float32,
                               device=dev)
            row = {"command": [float(vx), 0.0, float(yaw)]}
            for arm, pp in (("policy", policy.params), ("default", None)):
                row[arm] = eval_mod.evaluate(
                    params, cfg, ter, pp, policy.model, num_envs=num_envs,
                    num_steps=num_steps, seed=0, commands=cmd)
            rows.append(row)
            print(f"vx={vx:+.2f} yaw={yaw:+.2f} "
                  f"policy surv={row['policy']['survival_rate']:.2f} "
                  f"verr={row['policy']['lin_vel_err']:.3f} | "
                  f"default surv={row['default']['survival_rate']:.2f} "
                  f"verr={row['default']['lin_vel_err']:.3f}", flush=True)
    ckpt_abs = os.path.abspath(ckpt)
    result = {
        "robot": robot,
        "checkpoint": (os.path.relpath(ckpt_abs, REPO_ROOT)
                       if ckpt_abs.startswith(REPO_ROOT) else ckpt),
        "terrain": "random_uniform", "num_envs": num_envs,
        "num_steps": num_steps, "vx_grid": [float(v) for v in vx_grid],
        "yaw_grid": [float(v) for v in yaw_grid], "rows": rows,
        "wall_s": round(time.time() - t0, 1),
        "environment": {**_environment(dev), "clock": "host"},
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "envelope.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def plot(result: dict, out_dir: str) -> None:
    """Two single-hue sequential heatmaps as small multiples: survival and
    tracking error are different measures, so they get separate panels and
    colorbars."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vx, yaw = result["vx_grid"], result["yaw_grid"]
    nvx, nyaw = len(vx), len(yaw)
    surv = np.zeros((nyaw, nvx))
    verr = np.zeros((nyaw, nvx))
    for i, row in enumerate(result["rows"]):
        iv, iy = divmod(i, nyaw)
        surv[iy, iv] = row["policy"]["survival_rate"]
        verr[iy, iv] = row["policy"]["lin_vel_err"]

    seconds = result["num_steps"] / 100
    ink, muted = "#1a1a1a", "#666666"
    fig, axes = plt.subplots(1, 2, figsize=(11, 3.6))
    for ax, data, cmap, title in (
            (axes[0], surv, "Blues",
             f"survival rate ({seconds:g} s, {result['num_envs']} envs)"),
            (axes[1], verr, "Oranges", "|v_xy − cmd| tracking error (m/s)")):
        im = ax.imshow(data, cmap=cmap, aspect="auto", origin="lower",
                       extent=(vx[0], vx[-1], yaw[0], yaw[-1]),
                       interpolation="nearest")
        ax.set_xlabel("vx command (m/s)", color=muted)
        ax.set_ylabel("yaw-rate command (rad/s)", color=muted)
        ax.set_title(title, color=ink, fontsize=11)
        ax.tick_params(colors=muted, length=0)
        for s in ax.spines.values():
            s.set_visible(False)
        fig.colorbar(im, ax=ax, shrink=0.9).outline.set_visible(False)
    fig.suptitle(f"{result['robot']} weight policy — command envelope "
                 f"(rough terrain)", color=ink, fontsize=12)
    fig.tight_layout()
    path = os.path.join(out_dir, "envelope.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"wrote {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--robot", default="aliengo")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--out-dir", default=None,
                    help="default: artifacts/<robot>_envelope_torch")
    ap.add_argument("--plot-only", default=None, metavar="DIR",
                    help="plot DIR/envelope.json and run nothing")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if args.plot_only:
        with open(os.path.join(args.plot_only, "envelope.json")) as f:
            plot(json.load(f), args.plot_only)
        return
    out_dir = args.out_dir or os.path.join(
        REPO_ROOT, "artifacts", f"{args.robot}_envelope_torch")
    result = run(args.ckpt, args.robot, args.envs, args.steps, out_dir,
                 args.device)
    print(f"wrote {os.path.join(out_dir, 'envelope.json')} "
          f"({result['wall_s']} s)")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("no matplotlib here: plot with --plot-only where it is")
        return
    plot(result, out_dir)


if __name__ == "__main__":
    main()
