"""Trajectory viewer: render a rollout as an animation.

Counterpart of ``rl_mpc_locomotion_tpu/utils/viewer.py``. There is no live
viewer on a headless machine, so a rollout is recorded (trunk pose, trunk
corners, knees and feet a tick, as numpy) and rendered offline as a
skeleton animation (trunk outline + hip -> knee -> foot segments over the
terrain heightfield) to a GIF or MP4 with matplotlib. Used by ``cli play
--render out.gif`` and ``examples/mpc_terrain_show.py --render``.

matplotlib is imported inside ``render`` only: a machine without it (the
GPU machine has none) records frames and fails at ``require_matplotlib``,
which callers call before a rollout rather than after it.
"""
from __future__ import annotations

import importlib.util

import numpy as np
import torch


def require_matplotlib() -> None:
    """Raise ImportError, naming matplotlib, where it is not installed (or
    is blocked in ``sys.modules``)."""
    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError("rendering needs matplotlib, which is not "
                          "installed here; record on this machine and "
                          "render where matplotlib is")


def record_frame(params, phys_state) -> dict:
    """One render frame (host numpy) of a batch-of-one ``PhysState``
    (slice env 0 as ``[0:1]``): ``pos`` (3,), ``corners`` (4,3), ``knees``
    (4,3), ``feet`` (4,3)."""
    from ..sim import physics as physics_mod

    if phys_state.pos.shape[0] != 1:
        raise ValueError("record_frame takes a batch of one env "
                         f"(got {phys_state.pos.shape[0]}); slice [0:1]")
    p_world, _, _, _ = physics_mod.foot_positions_world(params, phys_state)
    pts = physics_mod.body_contact_points(params, phys_state)[0]
    return {"pos": phys_state.pos[0].detach().cpu().numpy(),
            "corners": pts[:4].detach().cpu().numpy(),
            "knees": pts[4:].detach().cpu().numpy(),
            "feet": p_world[0].detach().cpu().numpy()}


def _terrain_patch(ter, x_range, y_range, n=40):
    """Sample the terrain heightfield over a window for the ground mesh."""
    from ..sim import terrain as terrain_mod

    xs = np.linspace(*x_range, n)
    ys = np.linspace(*y_range, n)
    gx, gy = np.meshgrid(xs, ys)
    pts = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], axis=1),
                          dtype=torch.float32, device=ter.height.device)
    gz = terrain_mod.sample_height(ter, pts).cpu().numpy().reshape(gx.shape)
    return gx, gy, gz


def render(frames: list, ter, out_path: str, dt: float = 0.01,
           stride: int = 4, dpi: int = 80, fps: int = 25) -> str:
    """Render recorded frames to ``out_path`` (.gif with pillow, otherwise
    ffmpeg).

    frames: list of ``record_frame`` dicts. stride: render every Nth tick
    (stride 4 at dt 0.01 -> 25 fps real time).
    """
    require_matplotlib()
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    frames = frames[::stride]
    pos = np.array([f["pos"] for f in frames])
    x_rng = (pos[:, 0].min() - 0.6, pos[:, 0].max() + 0.6)
    y_rng = (pos[:, 1].min() - 0.6, pos[:, 1].max() + 0.6)
    gx, gy, gz = _terrain_patch(ter, x_rng, y_rng)

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.computed_zorder = False
    ax.plot_surface(gx, gy, gz, alpha=0.35, color="#b0a890",
                    linewidth=0, zorder=1)
    zmax = float(gz.max()) + 0.8

    # artists updated per frame: trunk outline, 4 legs (2 segments each),
    # feet, CoM trace
    trunk_line, = ax.plot([], [], [], "k-", lw=2, zorder=5)
    leg_lines = [ax.plot([], [], [], "-", color="#c2410c", lw=2,
                         zorder=5)[0] for _ in range(4)]
    foot_pts, = ax.plot([], [], [], "o", color="#1d4ed8", ms=4, zorder=6)
    trace, = ax.plot([], [], [], "-", color="#1d4ed8", lw=1, alpha=0.6,
                     zorder=4)
    ax.set_xlim(*x_rng)
    ax.set_ylim(*y_rng)
    ax.set_zlim(float(gz.min()), zmax)
    ax.set_box_aspect((x_rng[1] - x_rng[0], y_rng[1] - y_rng[0],
                       zmax - float(gz.min())))
    ax.view_init(elev=18, azim=-60)
    title = ax.set_title("")

    # trunk outline order: FR, FL, RR, RL -> draw FR-FL-RL-RR-FR
    order = [0, 1, 3, 2, 0]

    def update(i):
        f = frames[i]
        c = f["corners"][order]
        trunk_line.set_data(c[:, 0], c[:, 1])
        trunk_line.set_3d_properties(c[:, 2])
        for leg in range(4):
            seg = np.stack([f["corners"][leg], f["knees"][leg],
                            f["feet"][leg]])
            leg_lines[leg].set_data(seg[:, 0], seg[:, 1])
            leg_lines[leg].set_3d_properties(seg[:, 2])
        foot_pts.set_data(f["feet"][:, 0], f["feet"][:, 1])
        foot_pts.set_3d_properties(f["feet"][:, 2])
        trace.set_data(pos[:i + 1, 0], pos[:i + 1, 1])
        trace.set_3d_properties(pos[:i + 1, 2])
        title.set_text(f"t = {i * stride * dt:.2f} s")
        return [trunk_line, *leg_lines, foot_pts, trace, title]

    anim = animation.FuncAnimation(fig, update, frames=len(frames),
                                   blit=False)
    writer = "pillow" if out_path.endswith(".gif") else "ffmpeg"
    anim.save(out_path, writer=writer, fps=fps, dpi=dpi)
    plt.close(fig)
    return out_path
