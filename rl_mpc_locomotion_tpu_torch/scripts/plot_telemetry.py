"""Plot MPC telemetry logs: the reference's offline loss / tracking analysis
for the port's logs.

Counterpart of ``scripts/plot_telemetry.py``, reading with the port's
``utils/metrics`` and ``utils/native_runtime``. Input:
  - a ``mpclog_*.npz`` written by ``utils/metrics.MPCFrameLogger.flush``;
  - a native ``.bin`` log of full MPC frames;
  - a generic ``.bin`` log with its ``.meta`` sidecar of field names, as
    ``cli play --telemetry`` writes it.
Output: ``<log>_plots.png`` with
  1. the MPC loss (decomposed where the log has it) per tick,
  2. CoM state against desired (z, roll / pitch, vx / vy tracking),
  3. the step-0 GRF vertical forces per leg.

``load_frames`` needs only numpy (it is the half that runs on a machine
without matplotlib, such as the GPU machine); the plots import matplotlib
inside.

Usage: python -m rl_mpc_locomotion_tpu_torch.scripts.plot_telemetry
       logs/mpclog_XXXX.npz [out.png]
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..utils.metrics import MPC_FRAME_SIZE, unpack_mpc_frames


def _smooth(trace, window: int = 20):
    """Neumaier moving-average smoothing (``ops/filters.smooth``)."""
    from ..ops.filters import smooth
    return smooth(np.asarray(trace, np.float32), window).numpy()


def load_frames(path: str) -> dict:
    """The log at ``path`` as named arrays: the MPC frame fields, or
    ``{"_generic": {field: (n,)}}`` for a log with a ``.meta`` sidecar."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    from ..utils.native_runtime import TelemetryLogger
    raw = TelemetryLogger.read(path)
    if raw.ndim == 2 and raw.shape[1] == MPC_FRAME_SIZE:
        # a full MPCFrameLogger frame stream routed through the native log
        return unpack_mpc_frames(raw)
    # generic log: field names from the .meta sidecar (the play CLI writes
    # tick/x/y/z/vx/com_z_est/mpc_loss + per-leg GRFs)
    meta = path + ".meta"
    if not os.path.exists(meta):
        raise SystemExit(f"no .meta sidecar for {path}; unknown frame layout")
    with open(meta) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    if len(names) != raw.shape[1]:
        raise SystemExit(f"{meta}: {len(names)} fields but frames have "
                         f"{raw.shape[1]} columns")
    return {"_generic": {n: raw[:, i] for i, n in enumerate(names)}}


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_generic(d: dict, out: str) -> int:
    """Panels for the play CLI's telemetry fields."""
    n = len(d["tick"])
    if n == 0:
        print("empty log")
        return 1
    plt = _pyplot()
    tick = d["tick"]
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    ax = axes[0, 0]
    ax.plot(tick, d["mpc_loss"])
    ax.set_title("MPC loss (ConvexMPCLocomotion.py:192-215)")
    ax.set_xlabel("control tick")

    ax = axes[0, 1]
    ax.plot(tick, d["z"], label="base z")
    ax.plot(tick, d["com_z_est"], "--", label="com z estimate")
    ax.set_title("height tracking")
    ax.set_xlabel("control tick")
    ax.legend()

    ax = axes[1, 0]
    ax.plot(tick, d["vx"], label="vx", alpha=0.4)
    ax.plot(tick, _smooth(d["vx"]), label="vx (filtered)", lw=2)
    ax.plot(tick, d["x"], label="x")
    ax.set_title("forward progress")
    ax.set_xlabel("control tick")
    ax.legend()

    ax = axes[1, 1]
    for leg, name in enumerate(("FR", "FL", "RR", "RL")):
        key = f"f_{leg}z"
        if key in d:
            ax.plot(tick, d[key], label=f"fz {name}")
    ax.set_title("step-0 GRF vertical forces")
    ax.set_xlabel("control tick")
    ax.set_ylabel("N")
    ax.legend()

    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out} ({n} frames)")
    return 0


def plot_frames(d: dict, out: str) -> int:
    """Panels for full MPC frames (``MPCFrameLogger``)."""
    n = d["com_state"].shape[0]
    if n == 0:
        print("empty log")
        return 1
    plt = _pyplot()
    tick = d["tick"][:, 0]
    com, des, grf, loss = (d["com_state"], d["desired_state"], d["grf"],
                           d["loss"])

    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    ax = axes[0, 0]
    ax.plot(tick, loss[:, 0], label="state loss")
    ax.plot(tick, loss[:, 1], label="torque loss")
    ax.plot(tick, loss[:, 2], label="total", lw=2)
    ax.set_title("MPC loss decomposition (ConvexMPCLocomotion.py:192-215)")
    ax.set_xlabel("control tick")
    ax.legend()

    # state layout: (rpy 0:3, xyz 3:6, omega 6:9, v 9:12, -g)
    ax = axes[0, 1]
    ax.plot(tick, com[:, 5], label="z")
    ax.plot(tick, des[:, 5], "--", label="z desired")
    ax.plot(tick, com[:, 0], label="roll")
    ax.plot(tick, com[:, 1], label="pitch")
    ax.set_title("CoM height & attitude")
    ax.set_xlabel("control tick")
    ax.legend()

    ax = axes[1, 0]
    ax.plot(tick, com[:, 9], label="vx", alpha=0.4)
    ax.plot(tick, _smooth(com[:, 9]), label="vx (filtered)", lw=2)
    ax.plot(tick, des[:, 9], "--", label="vx desired")
    ax.plot(tick, com[:, 10], label="vy", alpha=0.4)
    ax.plot(tick, des[:, 10], "--", label="vy desired")
    ax.set_title("velocity tracking")
    ax.set_xlabel("control tick")
    ax.legend()

    ax = axes[1, 1]
    for leg, name in enumerate(("FR", "FL", "RR", "RL")):
        ax.plot(tick, grf[:, 3 * leg + 2], label=f"fz {name}")
    ax.set_title("step-0 GRF vertical forces")
    ax.set_xlabel("control tick")
    ax.set_ylabel("N")
    ax.legend()

    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out} ({n} frames)")
    return 0


def main(argv) -> int:
    argv = [a for a in argv if a != "--out"]
    if len(argv) < 2:
        print(__doc__)
        return 2
    path = argv[1]
    out = (argv[2] if len(argv) > 2
           else os.path.splitext(path)[0] + "_plots.png")
    d = load_frames(path)
    if "_generic" in d:
        return plot_generic(d["_generic"], out)
    return plot_frames(d, out)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
