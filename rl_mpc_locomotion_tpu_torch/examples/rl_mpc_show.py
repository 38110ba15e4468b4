"""A/B demo: the default-weight FSM controller against the RL weight policy.

Counterpart of ``examples/rl_mpc_show.py``: two Aliengos on flat ground in
one batch, lane 0 with the robot's default MPC weights, lane 1 with the
weights the policy predicts inside the tick from the previous action. The
production QP configuration runs the fused chain-QP kernel on every solve
tick on the card; CPU tensors take its plain version.

Run:  python -m rl_mpc_locomotion_tpu_torch.examples.rl_mpc_show
      [checkpoint] [--seconds S] [--device cpu]
The command line's checkpoint defaults to the committed
``artifacts/aliengo_weight_policy`` (read from ``weights/``); ``main`` with
``checkpoint=None`` runs a seeded random init.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..control import fsm, runner, weight_policy
from ..control.types import ControlConfig
from ..control.weight_policy import WeightPolicy
from ..models import robots
from ..ops.qp import production_qp_config
from ..sim import physics, terrain

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CHECKPOINT = os.path.join(REPO_ROOT, "artifacts",
                                  "aliengo_weight_policy")
STAND = (0.0, 0.8, -1.6)
COMMAND = (0.5, 0.0, 0.0)


def tick(params, cfg, pcfg, ter, policy, pstate, cstate, passive_iters,
         commands, prev_action):
    """One tick of both lanes: lane 1's weights from the policy on the
    previous action, then the FSM tick of the batch and one physics step.
    Returns (pstate, cstate, passive_iters, lane 1's action (1,12))."""
    body = physics.root_state_vector(pstate)
    w1, a1 = weight_policy.policy_step(
        policy.model, policy.params, body[1:2], pstate.q[1:2],
        pstate.qd[1:2], commands[1:2], prev_action)
    weights = torch.cat([params.mpc_weights[None].to(w1.dtype), w1])
    cstate, tau, passive_iters, _ = runner.fsm_step(
        params, cfg, cstate, passive_iters, pstate.q, pstate.qd, body,
        commands, mpc_weights=weights, control_mode=fsm.LOCOMOTION,
        solve_gate=bool(fsm.solve_gate(cfg, cstate)))
    pstate, _, _ = physics.step(params, pcfg, ter, pstate, tau)
    return pstate, cstate, passive_iters, a1


def main(checkpoint=None, seconds: float = 4.0, device=None) -> bool:
    dev = runner._resolve_device(device)
    params = robots.aliengo_params(dev)
    cfg = ControlConfig(qp=production_qp_config())
    pcfg = physics.PhysicsConfig()
    ter = terrain.flat(device=dev)
    policy = WeightPolicy(checkpoint=checkpoint, device=dev)
    commands = torch.tensor(COMMAND, dtype=torch.float32,
                            device=dev).repeat(2, 1)
    q0 = torch.tensor(STAND, dtype=torch.float32, device=dev).repeat(4)
    pstate = physics.init_state(params, q0, 0.345, 2, dev)
    cstate = runner.init_state(params, cfg, batch=2, device=dev)
    passive_iters = torch.zeros(2, dtype=torch.int32, device=dev)
    prev_action = torch.zeros((1, 12), dtype=torch.float32, device=dev)
    for t in range(int(seconds * 100)):
        pstate, cstate, passive_iters, prev_action = tick(
            params, cfg, pcfg, ter, policy, pstate, cstate, passive_iters,
            commands, prev_action)
        if t % 100 == 0:
            pos = pstate.pos.cpu().numpy()
            print(f"t={t/100:4.1f}s  default[x={pos[0,0]:+.2f} "
                  f"z={pos[0,2]:.3f}]  policy[x={pos[1,0]:+.2f} "
                  f"z={pos[1,2]:.3f}]")
    pos = pstate.pos.cpu().numpy()
    print(f"final: default x={pos[0,0]:.2f}, policy x={pos[1,0]:.2f}")
    return bool((pos[:, 2] > 0.15).all())


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", nargs="?", default=DEFAULT_CHECKPOINT)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    a = ap.parse_args()
    raise SystemExit(0 if main(a.checkpoint, a.seconds, a.device) else 1)
