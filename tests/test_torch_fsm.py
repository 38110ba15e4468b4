"""The port's control FSM against the JAX package, on the CPU.

1. The FSM logic alone: ``locomotion.step`` is replaced, in this test
   process only and in both packages, by one deterministic stand-in of
   plain element-wise arithmetic. Four robots then run side by side through
   ``fsm.fsm_step`` (JAX: eager ``jax.vmap``; port: the batched step) for
   40-60 ticks on the same numpy inputs, covering ``tests/test_fsm.py``'s
   scenarios: the two-tick protocol, passive rejecting locomotion, passive
   -> recovery, the passive PD for 10 ticks, the stand-up ramp, fold when
   upside down (and, at a 4x controller dt, fold -> roll over -> fold ->
   stand up), unsafe roll, and negative roll not triggering. Tolerance:
   FSM states and every command field exactly equal, every tick.
2. The whole ``runner.fsm_step`` un-patched for 4 ticks, entering
   locomotion and solving once: torques within 5e-4 of max(1, |tau|), the
   tolerance of the Min-mode tick's parity test.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.control import fsm as jfsm
from rl_mpc_locomotion_tpu.control import leg_controller as jleg
from rl_mpc_locomotion_tpu.control import locomotion as jloco
from rl_mpc_locomotion_tpu.control import runner as jrunner
from rl_mpc_locomotion_tpu.control import state_estimator as jse
from rl_mpc_locomotion_tpu.control import types as jtypes
from rl_mpc_locomotion_tpu.control.types import ControlConfig as JControlConfig
from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.ops.qp import QPConfig as JQPConfig

from rl_mpc_locomotion_tpu_torch.control import fsm, locomotion, runner, types
from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.ops.qp import QPConfig
from rl_mpc_locomotion_tpu_torch.utils import convert

B = 4
P, L, R = fsm.PASSIVE, fsm.LOCOMOTION, fsm.RECOVERY_STAND
CHEAP = dict(iters=8, iters2=0, adaptive_rho=False, polish=False,
             ruiz_iters=1)


def body_state(height=0.35, roll=0.0, upside_down=False):
    """(13,) root state; quaternion xyzw."""
    quat = ([1.0, 0.0, 0.0, 0.0] if upside_down
            else [math.sin(roll / 2), 0.0, 0.0, math.cos(roll / 2)])
    return np.array([0, 0, height] + quat + [0] * 6, np.float32)


def scenario(t):
    """Per robot at tick t: (q (12,), body (13,), control_mode)."""
    stand = np.tile([0.0, 0.8, -1.6], 4)
    far = np.tile([0.3, 1.1, -2.0], 4)
    rows = [
        # 0: recovery, then locomotion (two-tick protocol), an unsafe
        # positive roll at t = 30-31 forces recovery, then back
        (stand, body_state(roll=0.9 if t in (30, 31) else 0.0),
         R if t < 5 else L),
        # 1: recovery -> locomotion; a negative roll does not trigger
        (stand, body_state(roll=-0.9 if t in (30, 31) else 0.0), L),
        # 2: passive rejects locomotion, then recovery, upside down
        (stand, body_state(upside_down=t >= 15), L if t < 15 else R),
        # 3: stand-up ramp from far joints, upside down from t = 25
        (far, body_state(height=0.3, upside_down=t >= 25), R),
    ]
    q = np.stack([r[0] for r in rows]).astype(np.float32)
    q += 0.01 * np.sin(0.3 * t + np.arange(12, dtype=np.float32))
    body = np.stack([r[1] for r in rows])
    mode = np.array([r[2] for r in rows], np.int32)
    return q, body, mode


INITIAL = [R, R, P, R]


# ---- the stand-in ------------------------------------------------------------

def jax_stand_in(params, cfg, loco, est, se, leg_data, commands, weights,
                 gait_id, solve_gate=None):
    f_ff = 0.5 * loco.f_ff + leg_data.p
    new_loco = loco._replace(iteration_counter=loco.iteration_counter + 1,
                             f_ff=f_ff)
    new_est = est._replace(com_z=0.9 * est.com_z + 0.1 * se.position[2])
    cmds = jtypes.zero_leg_commands()._replace(
        tau_ff=2.0 * leg_data.q + 0.1, force_ff=f_ff,
        kd_joint=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32) * 3.0,
                                  (4, 3, 3)))
    return new_loco, new_est, cmds, {"f_ff": f_ff, "com_z": new_est.com_z}


def port_stand_in(params, cfg, loco, est, se, leg_data, commands, weights,
                  gait_id, solve_gate=None):
    b = commands.shape[0]
    f_ff = 0.5 * loco.f_ff + leg_data.p
    new_loco = loco._replace(iteration_counter=loco.iteration_counter + 1,
                             f_ff=f_ff)
    new_est = est._replace(com_z=0.9 * est.com_z + 0.1 * se.position[:, 2])
    cmds = types.zero_leg_commands(b)._replace(
        tau_ff=2.0 * leg_data.q + 0.1, force_ff=f_ff,
        kd_joint=(torch.eye(3) * 3.0).expand(b, 4, 3, 3))
    return new_loco, new_est, cmds, {"f_ff": f_ff, "com_z": new_est.com_z}


@jax.jit
def _estimate_and_leg_data(q, body):
    jp = jrobots.aliengo_params()
    est0 = jtypes.init_estimator_state(jp.body_height)
    se = jax.vmap(lambda b: jse.update(est0, b))(body)
    ld = jax.vmap(lambda a: jleg.update_data(jp, a, jnp.zeros(12)))(q)
    return se, ld


def _inputs(t):
    """The tick's estimate and leg data as numpy, from the JAX package's
    estimator and leg controller (the same arrays go to both sides)."""
    q, body, mode = scenario(t)
    se, ld = jax.tree.map(np.asarray, _estimate_and_leg_data(q, body))
    return se, ld, mode


def _port_tuple(cls, arrays):
    return cls(**{k: torch.from_numpy(np.array(v))
                  for k, v in arrays._asdict().items()})


@pytest.mark.parametrize("dt,ticks", [(0.01, 40), (0.04, 60)],
                         ids=["dt10ms", "dt40ms"])
def test_fsm_logic_matches_jax_exactly(monkeypatch, dt, ticks):
    """40-60 ticks of four robots in different states: states, passive
    counts and commands bitwise equal to the JAX package's every tick, and
    the behaviours of tests/test_fsm.py on the port's outputs."""
    monkeypatch.setattr(jloco, "step", jax_stand_in)
    monkeypatch.setattr(locomotion, "step", port_stand_in)
    jp = jrobots.aliengo_params()
    params = robots.aliengo_params("cpu")
    jcfg = JControlConfig(dt=dt)
    cfg = ControlConfig(dt=dt)

    jstate = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jrunner.init_state(jp, jcfg, fsm_initial=k) for k in INITIAL])
    state = convert.control_state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu")
    jpi = jnp.zeros(B, jnp.int32)
    pi = torch.zeros(B, dtype=torch.int32)
    zeros3 = jnp.zeros(3, jnp.float32)

    jstep = jax.vmap(lambda s, se, ld, cm, p: jfsm.fsm_step(
        jp, jcfg, s, se, ld, zeros3, jp.mpc_weights, jnp.int32(0), cm, p))
    states, flags, cmd_log = [], [], []
    for t in range(ticks):
        se_np, ld_np, mode = _inputs(t)
        jstate, jcmds, jpi, _ = jstep(jstate, se_np, ld_np, mode, jpi)
        state, cmds, pi, met = fsm.fsm_step(
            params, cfg, state, _port_tuple(types.StateEstimate, se_np),
            _port_tuple(types.LegData, ld_np), torch.zeros(B, 3),
            params.mpc_weights, 0, torch.from_numpy(mode), pi)
        want = jax.tree.map(np.asarray, (jstate, jcmds, jpi))
        got = (convert.control_state_to_numpy(state),
               tuple(c.numpy() for c in cmds), pi.numpy())
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(g, w, err_msg=f"tick {t}")
        states.append(state.fsm.state.numpy().copy())
        flags.append(state.fsm.rc_flag.numpy().copy())
        cmd_log.append(cmds)
        np.testing.assert_array_equal(met["fsm_state"].numpy(), states[-1])
    states = np.stack(states)

    # two-tick protocol: robot 1 enters recovery on tick 0, detects the
    # locomotion request on tick 1 and switches on tick 2, both with zero
    # commands; locomotion runs from tick 3
    np.testing.assert_array_equal(states[:5, 1], [R, R, L, L, L])
    for t in (1, 2):
        assert all(float(c[1].abs().max()) == 0.0 for c in cmd_log[t])
    assert float(cmd_log[3].tau_ff[1].abs().max()) > 0.01
    # unsafe positive roll (ticks 30-31) forces recovery; the mode still
    # asks for locomotion, so the robot goes back two ticks later
    np.testing.assert_array_equal(states[29:35, 0], [L, L, R, R, L, L])
    assert bool(state.fsm.locomotion_unsafe[0])
    # the negative roll does not trigger (fabs-of-bool quirk)
    assert (states[3:, 1] == L).all()
    assert not bool(state.fsm.locomotion_unsafe[1])
    # passive rejects locomotion, accepts recovery; its PD runs 10 ticks
    np.testing.assert_array_equal(states[14:18, 2], [P, P, R, R])
    kp = np.array([float(c.kp_joint[2].abs().max()) for c in cmd_log[:15]])
    np.testing.assert_array_equal(kp[1:11], 80.0)
    np.testing.assert_array_equal(kp[[0] + list(range(11, 15))], 0.0)
    # the stand-up ramp from the joints at entry (tick 0) to the stand pose:
    # halfway after half the ramp, there after the whole ramp
    ramp = fsm._ramp_iters(cfg)["standup_ramp"]
    q_enter = scenario(0)[0][3].reshape(4, 3)
    stand = fsm.STAND_JPOS.numpy()
    half = ramp // 2
    np.testing.assert_allclose(cmd_log[half + 1].q_des[3].numpy(),
                               q_enter + (half / ramp) * (stand - q_enter),
                               rtol=0, atol=1e-6)
    if ramp + 2 < 25:
        np.testing.assert_array_equal(cmd_log[ramp + 2].q_des[3].numpy(),
                                      stand)
    flags = np.stack(flags)
    # upside down: robot 2 enters recovery folding; robot 3 refolds from
    # its stand-up on the tick it turns over
    assert (flags[16:, 2] != fsm.STAND_UP).all()
    assert flags[24, 3] == fsm.STAND_UP and flags[25, 3] == fsm.FOLD_LEGS
    if dt == 0.04:
        # at 4x dt the ramps are 4x shorter: fold -> roll over -> fold
        runs = [f for i, f in enumerate(flags[16:, 2])
                if i == 0 or f != flags[15 + i, 2]]
        assert runs == [fsm.FOLD_LEGS, fsm.ROLL_OVER, fsm.FOLD_LEGS]
        assert flags[-1, 3] == fsm.ROLL_OVER


def test_solve_gate():
    cfg = ControlConfig()
    state = runner.init_state(robots.aliengo_params("cpu"), cfg,
                              fsm_initial=R, batch=3, device="cpu")
    assert not bool(fsm.solve_gate(cfg, state))          # nobody walks
    loco_fsm = state.fsm._replace(state=torch.tensor([R, L, R],
                                                     dtype=torch.int32))
    state = state._replace(fsm=loco_fsm)
    assert not bool(fsm.solve_gate(cfg, state))          # counter 0: not due
    state = state._replace(loco=state.loco._replace(
        iteration_counter=torch.tensor([0, 0, 1], dtype=torch.int32)))
    assert bool(fsm.solve_gate(cfg, state))              # robot 2 is due


def test_runner_fsm_step_matches_jax():
    """Four un-patched ticks of runner.fsm_step: robots start entering
    locomotion, run it, and solve on tick 2; robot 2 sees a roll > 40 deg
    on tick 3."""
    jp = jrobots.aliengo_params()
    params = robots.aliengo_params("cpu")
    jcfg = JControlConfig(qp=JQPConfig(use_pallas=False, **CHEAP))
    cfg = ControlConfig(qp=QPConfig(use_kernel=False, **CHEAP))
    b = 3
    jstate = jax.vmap(lambda _: jrunner.init_state(jp, jcfg, fsm_initial=L))(
        jnp.arange(b))
    state = runner.init_state(params, cfg, fsm_initial=L, batch=b,
                              device="cpu")
    jpi = jnp.zeros(b, jnp.int32)
    pi = torch.zeros(b, dtype=torch.int32)
    cmd = np.tile(np.array([0.4, 0.0, 0.1], np.float32), (b, 1))
    rng = np.random.default_rng(5)
    launches = []
    for t in range(4):
        q = (np.tile([0.0, 0.8, -1.6], (b, 4))
             + 0.02 * rng.normal(size=(b, 12))).astype(np.float32)
        qd = (0.1 * rng.normal(size=(b, 12))).astype(np.float32)
        body = np.stack([body_state(0.34), body_state(0.35, roll=0.1),
                         body_state(0.33, roll=0.9 if t == 3 else 0.0)])
        gate = bool(fsm.solve_gate(cfg, state))
        launches.append(gate)
        # the batch-wide gate, unbatched, as the JAX CLI passes it
        jstate, jtau, jpi, jmet = jax.vmap(
            lambda s, p, a, v, bo, c: jrunner.fsm_step(
                jp, jcfg, s, p, a, v, bo, c, control_mode=L,
                solve_gate=jnp.bool_(gate)))(
            jstate, jpi, q, qd, body, cmd)
        state, tau, pi, met = runner.fsm_step(
            params, cfg, state, pi, torch.from_numpy(q), torch.from_numpy(qd),
            torch.from_numpy(body), torch.from_numpy(cmd), control_mode=L,
            solve_gate=gate)
        jtau = np.asarray(jtau)
        scale = np.maximum(1.0, np.abs(jtau).max(axis=-1, keepdims=True))
        assert (np.abs(tau.numpy() - jtau) / scale).max() < 5e-4, t
        np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
        np.testing.assert_array_equal(met["fsm_state"].numpy(),
                                      np.asarray(jmet["fsm_state"]))
        np.testing.assert_array_equal(met["locomotion_unsafe"].numpy(),
                                      np.asarray(jmet["locomotion_unsafe"]))
    assert launches == [False, False, True, False]
    assert np.abs(np.asarray(jmet["f_ff"])).max() > 1.0     # it solved
    assert met["locomotion_unsafe"].tolist() == [False, False, True]
