"""Closed-loop walking on the port alone, on the CPU: the Min-mode
controller under the production QP configuration (on CPU tensors the fused
solve's plain version) against the port's physics, for 3 simulated seconds
on flat ground, one robot of each kind in one heterogeneous batch.

Every robot must meet ``tests/test_closed_loop.py``'s limits: base height
within 0.65 h .. 1.35 h + 0.05 the whole time, |roll|, |pitch| < 0.4 rad,
forward progress of 1.0 m (Aliengo, 0.5 m/s) or 0.5 m (Go1, A1, 0.4 m/s)
at 3 s, |y| < 0.2 m. Then ``cli play`` on the CPU, in Min and Fsm mode.
"""
import numpy as np
import pytest
import torch

from rl_mpc_locomotion_tpu_torch import cli
from rl_mpc_locomotion_tpu_torch.control import runner
from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.ops import rotations as rot
from rl_mpc_locomotion_tpu_torch.ops.cuda import fused_qp
from rl_mpc_locomotion_tpu_torch.ops.qp import production_qp_config
from rl_mpc_locomotion_tpu_torch.sim import physics, terrain
from rl_mpc_locomotion_tpu_torch.utils.native_runtime import TelemetryLogger

TICKS = 300  # 3 s at 100 Hz
# (robot id, vx, min x at 3 s), as tests/test_closed_loop.py's CASES
CASES = [(robots.ALIENGO, 0.5, 1.0), (robots.GO1, 0.4, 0.5),
         (robots.A1, 0.4, 0.5)]


def test_heterogeneous_batch_walks_upright_and_advances():
    ids = torch.tensor([c[0] for c in CASES], dtype=torch.int32)
    params = robots.select_robot(robots.robot_registry("cpu"), ids)
    cfg = ControlConfig(qp=production_qp_config())
    pcfg = physics.PhysicsConfig()
    ter = terrain.flat(device="cpu")
    b = len(CASES)
    commands = torch.tensor([[vx, 0.0, 0.0] for _, vx, _ in CASES])
    q0 = torch.tensor([0.0, 0.8, -1.6]).repeat(4)
    ps = physics.init_state(params, q0, params.body_height + 0.03, b, "cpu")
    cs = runner.init_state(params, cfg, batch=b, device="cpu")
    launches = fused_qp.launch_count()
    zs, tilt = [], []
    for t in range(TICKS):
        body = physics.root_state_vector(ps)
        cs, tau, _ = runner.min_step(params, cfg, cs, ps.q, ps.qd, body,
                                     commands, solve_gate=t % 2 == 1)
        ps, _, _ = physics.step(params, pcfg, ter, ps, tau)
        zs.append(ps.pos[:, 2].clone())
        tilt.append(rot.quat_to_rpy(ps.quat)[:, :2].abs().amax(dim=-1))
    assert fused_qp.launch_count() == launches     # CPU: the plain version
    zs, tilt = torch.stack(zs).numpy(), torch.stack(tilt).numpy()
    pos = ps.pos.numpy()
    h = params.body_height.numpy()
    assert np.isfinite(zs).all() and np.isfinite(pos).all()
    for i, (robot, _, min_x) in enumerate(CASES):
        name = [k for k, v in robots.ROBOT_NAMES.items() if v == robot][0]
        assert zs[:, i].min() > 0.65 * h[i], f"{name} fell"
        assert zs[:, i].max() < 1.35 * h[i] + 0.05, f"{name} flew"
        assert tilt[:, i].max() < 0.4, f"{name} tipped"
        assert pos[i, 0] >= min_x, f"{name} advanced only {pos[i, 0]:.2f} m"
        assert abs(pos[i, 1]) < 0.2, f"{name} drifted {pos[i, 1]:.2f} m"


@pytest.mark.parametrize("mode", ["Min", "Fsm"])
def test_cli_play_on_cpu(capsys, tmp_path, mode):
    """`cli play --device cpu` runs the closed loop and prints its summary;
    without --device it needs the GPU. --telemetry writes a frame a tick,
    --gamepad without a joystick falls back to the scripted commands,
    --render records env 0 and writes the animation, and Policy mode raises
    on a checkpoint it cannot load."""
    cli.main(["play", "--mode", mode, "--num-envs", "2", "--seconds", "0.05",
              "--log-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("t=") for ln in out) == 3
    assert out[-1].startswith("[play] 5 ticks x 2 envs")
    assert "robot-ticks/s" in out[-1] and out[-1].endswith("on cpu")
    with pytest.raises(FileNotFoundError, match="--write-weights"):
        cli.main(["play", "--mode", "Policy", "--device", "cpu",
                  "--checkpoint", str(tmp_path / "nowhere")])
    tele = str(tmp_path / "tele.bin")
    cli.main(["play", "--mode", mode, "--num-envs", "2", "--seconds", "0.02",
              "--device", "cpu", "--telemetry", tele, "--gamepad"])
    assert "no gamepad" in capsys.readouterr().out
    assert TelemetryLogger.read(tele).shape == (2, len(cli.TELEMETRY_FIELDS))
    gif = tmp_path / "a.gif"
    cli.main(["play", "--mode", mode, "--num-envs", "2", "--seconds", "0.02",
              "--device", "cpu", "--render", str(gif)])
    assert "[play] animation written to" in capsys.readouterr().out
    assert gif.stat().st_size > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["play", "--mode", mode, "--seconds", "0.01"])
