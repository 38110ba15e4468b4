"""Multi-robot / multi-terrain MPC integration demo.

Counterpart of ``examples/mpc_terrain_show.py``: six robots (2x Aliengo,
2x A1, 2x Go1) under the FSM controller at once, as one heterogeneous batch
(per-robot params from ``robots.select_robot``), on a mixed-terrain
heightfield, with scripted commands. The production QP configuration runs
the fused chain-QP kernel on every solve tick on the card; CPU tensors take
its plain version.

Run:  python -m rl_mpc_locomotion_tpu_torch.examples.mpc_terrain_show
      [--seconds S] [--render out.gif] [--device cpu]
(``--render`` draws robot 0 offline, ``utils/viewer``; it needs matplotlib)
"""
from __future__ import annotations

import argparse

import torch

from ..control import fsm, runner
from ..control.types import ControlConfig
from ..models import robots
from ..ops.qp import production_qp_config
from ..sim import physics, terrain

ROBOT_IDS = (0, 0, 2, 2, 1, 1)       # registry order: Aliengo, Go1, A1
NAMES = ("Aliengo", "Aliengo", "A1", "A1", "Go1", "Go1")
# spawn lanes across the terrain quadrants (rough side y < 0, stair side
# y > 0), like the reference demo's env grid
LANE_Y = (-0.6, 0.6, -1.8, 1.8, -3.0, 3.0)
STAND = (0.0, 0.8, -1.6)
COMMAND = (0.4, 0.0, 0.0)


def setup(device=None):
    """(registry, per-robot params, ControlConfig, PhysicsConfig, terrain,
    physics state, control state) of the six robots at their lanes."""
    dev = runner._resolve_device(device)
    registry = robots.robot_registry(dev)
    ids = torch.tensor(ROBOT_IDS, dtype=torch.int32, device=dev)
    params = robots.select_robot(registry, ids)
    # flat_ground=False: the least-squares ground-normal estimator
    # (slope-aware MPC gravity), as the reference demo on its slope + stairs
    cfg = ControlConfig(flat_ground=False, qp=production_qp_config())
    ter = terrain.uneven_patches(seed=0, device=dev)
    n = len(ROBOT_IDS)
    q0 = torch.tensor(STAND, dtype=torch.float32, device=dev).repeat(4)
    pstate = physics.init_state(params, q0, params.body_height + 0.03, n, dev)
    pos = pstate.pos.clone()
    pos[:, 1] = torch.tensor(LANE_Y, dtype=torch.float32, device=dev)
    pstate = pstate._replace(pos=pos)
    cstate = runner.init_state(params, cfg, batch=n, device=dev)
    return (registry, params, cfg, physics.PhysicsConfig(), ter, pstate,
            cstate)


def tick(params, cfg, pcfg, ter, pstate, cstate, passive_iters, commands):
    """One control tick of the batch and one physics step. The QP gate is
    read back once (``fsm.solve_gate``): the FSM's MPC counters are not
    aligned. Returns (pstate, cstate, passive_iters, torques, metrics)."""
    body = physics.root_state_vector(pstate)
    cstate, tau, passive_iters, m = runner.fsm_step(
        params, cfg, cstate, passive_iters, pstate.q, pstate.qd, body,
        commands, control_mode=fsm.LOCOMOTION,
        solve_gate=bool(fsm.solve_gate(cfg, cstate)))
    pstate, _, _ = physics.step(params, pcfg, ter, pstate, tau)
    return pstate, cstate, passive_iters, tau, m


def main(seconds: float = 4.0, render: str | None = None,
         device=None) -> bool:
    if render:
        from ..utils import viewer
        viewer.require_matplotlib()
    registry, params, cfg, pcfg, ter, pstate, cstate = setup(device)
    dev = pstate.pos.device
    n = len(ROBOT_IDS)
    passive_iters = torch.zeros(n, dtype=torch.int32, device=dev)
    commands = torch.tensor(COMMAND, dtype=torch.float32,
                            device=dev).repeat(n, 1)
    params0 = robots.select_robot(registry, ROBOT_IDS[0])
    frames = [] if render else None
    for t in range(int(seconds * 100)):
        pstate, cstate, passive_iters, _, _ = tick(
            params, cfg, pcfg, ter, pstate, cstate, passive_iters, commands)
        if frames is not None:
            frames.append(viewer.record_frame(
                params0, type(pstate)(*(x[0:1] for x in pstate))))
        if t % 100 == 0:
            pos = pstate.pos.cpu().numpy()
            print(f"t={t/100:4.1f}s  " + "  ".join(
                f"{NAMES[i]}[x={pos[i,0]:+.2f} z={pos[i,2]:.2f}]"
                for i in range(n)))
    pos = pstate.pos.cpu().numpy()
    upright = pos[:, 2] > 0.12
    moved = pos[:, 0] > 0.3
    print(f"upright: {upright.sum()}/6, moved forward: {moved.sum()}/6")
    if frames:
        print("rendering", viewer.render(frames, ter, render))
    return bool(upright.all())


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--render", nargs="?", const="show.gif", default=None,
                    metavar="GIF")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    a = ap.parse_args()
    raise SystemExit(0 if main(a.seconds, a.render, a.device) else 1)
