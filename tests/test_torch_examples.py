"""The port's headless demos (``rl_mpc_locomotion_tpu_torch/examples``)
against the JAX package's ``examples/``, on the CPU.

- Each ``main`` runs short and meets its own pass criterion, as
  ``tests/test_examples.py`` runs the JAX demos (``rl_mpc_show`` with the
  committed ``artifacts/aliengo_weight_policy``).
- ``simulator_test``: 50 PD ticks from the stand against JAX's jitted
  ``physics.step`` with the same PD, every state field at every tick within
  1e-5 of its scale over the run, max(1, max_t |ref_t|) (the largest
  difference is float32 rounding of the stiff contact that does not grow
  with the ticks: 1.27e-5 rad/s on qd, whose scale is 1.32 rad/s).
- ``mpc_terrain_show``: the six robots' initial physics and control states
  against a restatement of ``examples/mpc_terrain_show.py:45-54`` (its
  ``make_one`` under ``jax.vmap``), exactly; then 6 ticks of the
  heterogeneous batch (recovery stand -> locomotion in ticks 0-3, the first
  solve on tick 4) on the plain pipeline on both sides
  (``use_kernel=False`` / ``use_pallas=False``, JAX jitted with the
  batch-wide gate passed unbatched, as ``tests/test_torch_fsm.py`` does):
  FSM states exactly equal, torques within 5e-4 of max(1, |tau|)
  (``tests/test_torch_fsm.py``'s tolerance for ``runner.fsm_step``).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.control import runner as jrunner
from rl_mpc_locomotion_tpu.control.types import ControlConfig as JControlConfig
from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.ops.qp import production_qp_config as jprod
from rl_mpc_locomotion_tpu.sim import physics as jphysics
from rl_mpc_locomotion_tpu.sim import terrain as jterrain

from rl_mpc_locomotion_tpu_torch.control import fsm
from rl_mpc_locomotion_tpu_torch.examples import (mpc_terrain_show,
                                                  rl_mpc_show, simulator_test)
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.sim import physics, terrain
from rl_mpc_locomotion_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_simulator_test_runs():
    assert simulator_test.main(seconds=1.0, device="cpu")


def test_mpc_terrain_show_runs():
    assert mpc_terrain_show.main(seconds=1.5, device="cpu")


def test_rl_mpc_show_runs():
    ckpt = os.path.join(REPO, "artifacts", "aliengo_weight_policy")
    assert rl_mpc_show.DEFAULT_CHECKPOINT == ckpt
    assert rl_mpc_show.main(checkpoint=ckpt, seconds=1.5, device="cpu")


def test_rl_mpc_show_raises_on_a_checkpoint_that_does_not_load(tmp_path):
    with pytest.raises(FileNotFoundError):
        rl_mpc_show.main(checkpoint=str(tmp_path / "none"), seconds=0.01,
                         device="cpu")


def test_simulator_test_pd_ticks_match_jax():
    jp = jrobots.aliengo_params()
    jpcfg, jter = jphysics.PhysicsConfig(), jterrain.flat()
    jstand = jnp.tile(jnp.array(simulator_test.STAND, jnp.float32), 4)
    jst = jphysics.init_state(jp, jstand, height=0.345)

    @jax.jit
    def jtick(state):
        tau = (simulator_test.KP * (jstand - state.q)
               - simulator_test.KD * state.qd)
        return jphysics.step(jp, jpcfg, jter, state, tau)[0]

    params = robots.aliengo_params("cpu")
    stand = torch.tensor(simulator_test.STAND).repeat(4)
    st = physics.init_state(params, stand, height=0.345)
    pcfg, ter = physics.PhysicsConfig(), terrain.flat()
    got, want = [], []
    for _ in range(50):
        jst = jtick(jst)
        st = simulator_test.pd_tick(params, pcfg, ter, stand, st)
        got.append([x[0].numpy().astype(np.float64) for x in st])
        want.append([np.asarray(x, np.float64) for x in jst])
    for i, name in enumerate(jst._fields):
        g = np.stack([r[i] for r in got])
        w = np.stack([r[i] for r in want])
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() / scale < 1e-5, name
    assert 0.25 < float(st.pos[0, 2]) < 0.40


def _jax_six(cfg):
    """examples/mpc_terrain_show.py:45-54: registry, ids, lanes, make_one
    under jax.vmap."""
    registry = jrobots.robot_registry()
    robot_ids = jnp.array(mpc_terrain_show.ROBOT_IDS, jnp.int32)
    lane_y = jnp.array(mpc_terrain_show.LANE_Y, jnp.float32)

    def make_one(rid, y):
        p = jrobots.select_robot(registry, rid)
        q0 = jnp.tile(jnp.array([0.0, 0.8, -1.6], jnp.float32), 4)
        ps = jphysics.init_state(p, q0, height=p.body_height + 0.03)
        ps = ps._replace(pos=ps.pos.at[1].set(y))
        return ps, jrunner.init_state(p, cfg)

    return registry, robot_ids, jax.vmap(make_one)(robot_ids, lane_y)


def test_mpc_terrain_show_initial_states_match_jax():
    _, _, (jps, jcs) = _jax_six(JControlConfig(flat_ground=False))
    _, params, cfg, _, ter, ps, cs = mpc_terrain_show.setup("cpu")
    assert not cfg.flat_ground and cfg.qp.use_kernel
    np.testing.assert_array_equal(
        ter.height.numpy(), np.asarray(jterrain.uneven_patches(0).height))
    for name, got, want in zip(jps._fields, ps, jps):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    got = jax.tree.leaves(convert.control_state_to_numpy(cs))
    want = jax.tree.leaves(jcs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    for name, got, want in zip(params._fields, params,
                               jrobots.select_robot(
                                   jrobots.robot_registry(),
                                   jnp.array(mpc_terrain_show.ROBOT_IDS))):
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)


def test_mpc_terrain_show_ticks_match_jax():
    """Six ticks of the six-robot batch from recovery stand into
    locomotion (the first solve on tick 4), plain pipeline both sides."""
    jcfg = JControlConfig(flat_ground=False,
                          qp=jprod()._replace(use_pallas=False))
    registry, robot_ids, (jps, jcs) = _jax_six(jcfg)
    jpcfg, jter = jphysics.PhysicsConfig(), jterrain.uneven_patches(seed=0)
    n = len(mpc_terrain_show.ROBOT_IDS)
    jcmd = jnp.tile(jnp.array(mpc_terrain_show.COMMAND, jnp.float32), (n, 1))

    @jax.jit
    def jtick(pstate, cstate, passive_iters, gate):
        def one(rid, ps, cs, pi, cmd):
            p = jrobots.select_robot(registry, rid)
            body = jphysics.root_state_vector(ps)
            cs, tau, pi, m = jrunner.fsm_step(p, jcfg, cs, pi, ps.q, ps.qd,
                                              body, cmd, control_mode=1,
                                              solve_gate=gate)
            ps, _, _ = jphysics.step(p, jpcfg, jter, ps, tau)
            return ps, cs, pi, tau, m["fsm_state"]
        return jax.vmap(one, in_axes=(0, 0, 0, 0, 0))(
            robot_ids, pstate, cstate, passive_iters, jcmd)

    _, params, cfg, pcfg, ter, ps, cs = mpc_terrain_show.setup("cpu")
    cfg = dataclasses.replace(cfg, qp=cfg.qp._replace(use_kernel=False))
    jpi = jnp.zeros(n, jnp.int32)
    pi = torch.zeros(n, dtype=torch.int32)
    cmd = torch.tensor(mpc_terrain_show.COMMAND).repeat(n, 1)
    gates = []
    for t in range(6):
        gate = bool(fsm.solve_gate(cfg, cs))
        gates.append(gate)
        jps, jcs, jpi, jtau, jstate = jtick(jps, jcs, jpi, jnp.bool_(gate))
        ps, cs, pi, tau, m = mpc_terrain_show.tick(params, cfg, pcfg, ter,
                                                   ps, cs, pi, cmd)
        np.testing.assert_array_equal(m["fsm_state"].numpy(),
                                      np.asarray(jstate))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
        jtau = np.asarray(jtau)
        scale = np.maximum(1.0, np.abs(jtau).max(axis=-1, keepdims=True))
        assert (np.abs(tau.numpy() - jtau) / scale).max() < 5e-4, t
    assert gates == [False] * 4 + [True, False]
    assert (m["fsm_state"] == fsm.LOCOMOTION).all()
    assert float(m["f_ff"].abs().max()) > 1.0             # it solved
