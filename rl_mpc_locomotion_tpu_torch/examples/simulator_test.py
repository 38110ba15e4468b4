"""Sim sanity check: one Aliengo held in a stand pose by joint PD.

Counterpart of ``examples/simulator_test.py``: checks the simulator's set-up,
joint conventions and the stand configuration with no MPC in the loop (so
no QP solve and no kernel launch).

Run:  python -m rl_mpc_locomotion_tpu_torch.examples.simulator_test
      [--seconds S] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..control.runner import _resolve_device
from ..models import robots
from ..sim import physics, terrain

STAND = (0.0, 0.8, -1.6)
KP, KD = 60.0, 2.0


def pd_tick(params, pcfg, ter, stand, state):
    """One 100 Hz tick: joint PD towards ``stand``, then one physics
    step."""
    tau = KP * (stand - state.q) - KD * state.qd
    return physics.step(params, pcfg, ter, state, tau)[0]


def main(seconds: float = 3.0, device=None) -> bool:
    dev = _resolve_device(device)
    params = robots.aliengo_params(dev)
    pcfg = physics.PhysicsConfig()
    ter = terrain.flat(device=dev)
    stand = torch.tensor(STAND, dtype=torch.float32, device=dev).repeat(4)
    state = physics.init_state(params, stand, height=0.345, device=dev)

    for t in range(int(seconds * 100)):
        state = pd_tick(params, pcfg, ter, stand, state)
        if t % 50 == 0:
            print(f"t={t/100:4.1f}s  z={float(state.pos[0, 2]):.3f}  "
                  f"q_err={float((state.q[0] - stand).abs().max()):.4f}  "
                  f"upright w={float(state.quat[0, 0]):.4f}")
    z = float(state.pos[0, 2])
    ok = 0.25 < z < 0.40 and float(state.quat[0, 0]) > 0.99
    print("PASS: robot stands" if ok else f"FAIL: z={z:.3f}")
    return ok


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs on the CPU")
    a = ap.parse_args()
    raise SystemExit(0 if main(a.seconds, a.device) else 1)
