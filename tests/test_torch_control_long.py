"""Two properties of the control tick that only show after the first solve,
reproduced in the JAX package and in the PyTorch port on the same inputs.

1. Swing-leg forces in ``metrics["f_ff"]`` are exactly zero over the first
   gait cycle; later the receding-horizon shift of the warm start leaves a
   remainder of order 1e-8 N in a masked variable, in both packages.
2. The fused kernel and the plain QP pipeline define the residuals that drive
   the deferred ``rho_mult`` differently (at x~ against the relaxed x), so
   the two paths of either package agree up to the first solve and part at
   the second; each path of the port follows its JAX counterpart throughout.

Both run on the CPU at a small batch; the Pallas kernel runs in interpret
mode at the full QP width (n = 120) with a narrow robot tile.
"""
import numpy as np

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.control import runner as jrunner
from rl_mpc_locomotion_tpu.control.types import ControlConfig as JControlConfig
from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.ops import qp as jqp
from rl_mpc_locomotion_tpu.ops.pallas import admm_kernel as jadmm
from rl_mpc_locomotion_tpu.ops.pallas import fused_qp as jfused

from rl_mpc_locomotion_tpu_torch.ops.qp import QPConfig, production_qp_config

from test_torch_control_step import (FAST, batched_trajectory,
                                     first_step_swing, run_jax, run_port)


def test_swing_force_remainder_matches_jax():
    """30 ticks of trot, B = 2. On every solve tick, the forces of the legs
    that are off the ground in the first horizon step: exactly 0 through
    the first gait cycle (ticks < 20) in the JAX package, in the port's
    plain pipeline and under the port's production config; at most 1e-7 N
    after it in all three; and the remainder shows up on the same ticks in
    the JAX package and the port's plain pipeline."""
    n_ticks, batch = 30, 2
    traj = batched_trajectory(n_ticks, batch, seed=4)
    commands = np.tile(np.array([0.4, 0.1, 0.2], np.float32), (batch, 1))
    _, j_mets, _ = run_jax(traj, commands, 0, True, FAST)
    _, p_mets, _ = run_port(traj, commands, 0, True,
                            QPConfig(use_kernel=False, **FAST))
    _, f_mets, _ = run_port(traj, commands, 0, True, production_qp_config())

    later = []
    for t in range(1, n_ticks, 2):
        swing = first_step_swing(t, 0, batch)
        assert swing.any()
        left = [float(np.abs(m[t]["f_ff"][swing]).max())
                for m in (j_mets, p_mets, f_mets)]
        if t < 20:
            assert left == [0.0, 0.0, 0.0], f"tick {t}: {left}"
        else:
            assert max(left) <= 1e-7, f"tick {t}: {left}"
            assert (left[0] == 0.0) == (left[1] == 0.0), f"tick {t}: {left}"
            later.append(left)
        # the legs that stand carry the robot: the zeros are not a dead solve
        assert np.abs(j_mets[t]["f_ff"][~swing]).max() > 10.0
        assert np.abs(p_mets[t]["f_ff"][~swing]).max() > 10.0
    # the remainder exists: exact zeros do not hold for the whole run
    assert any(l[0] > 0.0 for l in later) and any(l[1] > 0.0 for l in later)


def _rel(a, b):
    scale = np.maximum(1.0, np.abs(b).max(axis=-1, keepdims=True))
    return float((np.abs(a - b) / scale).max())


def test_kernel_and_plain_pipeline_part_at_second_solve(monkeypatch):
    """4 ticks (two solves) of trot, B = 2, production config with and
    without the kernel, in both packages.

    - each path of the port against its JAX counterpart on every tick:
      torques within 5e-4 of max(1, |tau|), rho_mult within 1e-2 relative;
    - kernel path against plain pipeline, in each package: within 5e-4 up
      to the first solve (ticks 0-2), more than 5e-2 apart at the second
      (tick 3), because rho_mult after the first solve is about 0.1 on the
      kernel path and clipped to 0.01 on the plain pipeline.

    The JAX kernel runs in interpret mode (a spy adds the flag, as
    tests/test_fused_qp.py does) with TR = 8 robots a tile. Ticks without
    a solve take the XLA config on the JAX side: no QP is solved there, and
    tracing the interpreted kernel into an untaken branch costs 30 s."""
    monkeypatch.setattr(jadmm, "TR", 8)
    orig = jfused.fused_solve_chain_batch
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jfused, "fused_solve_chain_batch", spy)
    jqp._make_fused_chain_solver.cache_clear()

    n_ticks, batch = 4, 2
    traj = batched_trajectory(n_ticks, batch, seed=11)
    commands = np.tile(np.array([0.5, 0.0, 0.1], np.float32), (batch, 1))
    params = jrobots.aliengo_params()
    xla_cfg = JControlConfig(
        qp=jqp.production_qp_config()._replace(use_pallas=False))

    def jax_run(use_pallas):
        solve_cfg = JControlConfig(
            qp=jqp.production_qp_config()._replace(use_pallas=use_pallas))
        state = jax.vmap(lambda _: jrunner.init_state(params, xla_cfg))(
            jnp.arange(batch))
        taus = []
        for t, (q, qd, b) in enumerate(traj):
            solve = t % 2 == 1
            cfg = solve_cfg if solve else xla_cfg
            state, tau, _ = jax.vmap(
                lambda s, q1, qd1, b1, c1: jrunner.min_step(
                    params, cfg, s, q1, qd1, b1, c1,
                    solve_gate=jnp.bool_(solve)))(
                        state, jnp.array(q), jnp.array(qd), jnp.array(b),
                        jnp.array(commands))
            taus.append(np.asarray(tau))
        return taus, np.asarray(state.loco.qp_state.rho_mult)

    try:
        jk_taus, jk_rm = jax_run(True)
    finally:
        jqp._make_fused_chain_solver.cache_clear()
    # (tracing may enter the wrapper more than once a solve)
    assert len(calls) >= 2, "the JAX solve ticks did not reach the kernel"
    jx_taus, jx_rm = jax_run(False)

    prod = production_qp_config()
    pk_taus, _, pk_state = run_port(traj, commands, 0, True, prod)
    px_taus, _, px_state = run_port(traj, commands, 0, True,
                                    prod._replace(use_kernel=False))
    pk_rm = pk_state.loco.qp_state.rho_mult.numpy()
    px_rm = px_state.loco.qp_state.rho_mult.numpy()

    for t in range(n_ticks):
        assert _rel(pk_taus[t], jk_taus[t]) < 5e-4, f"kernel path, tick {t}"
        assert _rel(px_taus[t], jx_taus[t]) < 5e-4, f"plain path, tick {t}"
    np.testing.assert_allclose(pk_rm, jk_rm, rtol=1e-2)
    np.testing.assert_allclose(px_rm, jx_rm, rtol=1e-2)

    for name, k_taus, x_taus in (("jax", jk_taus, jx_taus),
                                 ("port", pk_taus, px_taus)):
        for t in range(3):
            assert _rel(k_taus[t], x_taus[t]) < 5e-4, f"{name}, tick {t}"
        assert _rel(k_taus[3], x_taus[3]) > 5e-2, f"{name}: no parting"
    # after two solves the kernel path's multiplier is still ~10x the plain
    # pipeline's, in both packages
    assert np.all(jk_rm / jx_rm > 5.0) and np.all(pk_rm / px_rm > 5.0)
