"""The port's domain randomisation and RL environment against the JAX
package, on the CPU.

JAX's PRNG streams cannot be reproduced in torch, so the tests take the JAX
package's draws (its keys split as it splits them) and feed them to the
port's functions that take drawn values (``randomize.sample_from``,
``_draw_from``, ``apply_stream_from``, ``env.reset_from_draws``), or copy a
state the JAX package drew (``convert.env_state_from_numpy``).

Tolerances: constants, ``rescale_actions``, ``reset_from_draws`` and the
randomised values exactly equal (or within 1e-6 of max(1, |ref|) where a
float op order may differ); ``observations`` and ``_reward_and_reset``
within 1e-6; over 3 eager ``env.step`` ticks (one MPC solve) torques within
5e-4 of max(1, |tau|) (the Min-mode tick's parity tolerance), the physics
state and observations within 1e-3 of max(1, |ref|), rewards within 1e-5,
done flags exactly; envs that reset are compared on progress, counters and
the ranges of their fresh draws.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.control.types import ControlConfig as JControlConfig
from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.ops.qp import QPConfig as JQPConfig
from rl_mpc_locomotion_tpu.sim import env as jenv
from rl_mpc_locomotion_tpu.sim import randomize as jrand
from rl_mpc_locomotion_tpu.sim import terrain as jterrain

from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.ops.qp import QPConfig
from rl_mpc_locomotion_tpu_torch.sim import env, randomize
from rl_mpc_locomotion_tpu_torch.utils import convert

B = 3
CHEAP = dict(iters=8, iters2=0, adaptive_rho=False, polish=False,
             ruiz_iters=1)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def to_np(tree):
    return jax.tree.map(np.array, tree)


def test_constants_and_rescale_actions():
    assert (env.NUM_OBS, env.NUM_ACTIONS, env.NUM_ROBOT_TYPES) == (
        jenv.NUM_OBS, jenv.NUM_ACTIONS, jenv.NUM_ROBOT_TYPES)
    for name in ("MPC_PARAM_SCALE", "MPC_PARAM_CONST", "DEFAULT_DOF_POS"):
        np.testing.assert_array_equal(getattr(env, name).numpy(),
                                      np.asarray(getattr(jenv, name)))
    for robot_id in (False, True):
        assert env.num_obs(env.EnvConfig(obs_robot_id=robot_id)) == \
            jenv.num_obs(jenv.EnvConfig(obs_robot_id=robot_id))
    a = np.random.default_rng(0).uniform(-3, 3, (5, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        env.rescale_actions(torch.from_numpy(a)).numpy(),
        np.asarray(jax.vmap(jenv.rescale_actions)(a)))


# ---- randomize ---------------------------------------------------------------

SCHEDULED = (
    ("physics.friction_mu", dict(range_=(0.6, 1.3), schedule="linear",
                                 schedule_steps=100)),
    ("robot.body_mass", dict(distribution="gaussian", operation="additive",
                             range_=(0.5, 2.0), schedule="constant",
                             schedule_steps=50)),
    ("robot.body_inertia", dict(range_=(0.9, 1.1))),
    ("physics.contact_kn", dict(range_=(0.7, 1.4))),
    ("obs.noise", dict(distribution="gaussian", operation="additive",
                       range_=(0.0, 0.05), range_correlated=(0.0, 0.02))),
)


def _dr_pair(specs=SCHEDULED, frequency=0):
    j = jrand.DomainRandomization(
        specs=tuple((t, jrand.RandomizationSpec(**kw)) for t, kw in specs),
        frequency=frequency)
    p = randomize.DomainRandomization(
        specs=tuple((t, randomize.RandomizationSpec(**kw))
                    for t, kw in specs), frequency=frequency)
    return j, p


def _jax_raw_draws(jdr, keys, stream_dims):
    """The JAX package's raw draws of ``sample`` for each env's key, as the
    port's ``draw`` returns them: {target: (B, ...)}."""
    out = {}
    for target, spec in jdr.specs:
        if target in jrand.STREAM_TARGETS:
            dim = stream_dims[target.split(".")[0]]
            shape, rng_ = (dim,), spec.range_correlated
        else:
            group, field = target.split(".")
            nominal = jrand._nominal(target, jenv.physics.PhysicsConfig(),
                                     jrobots.aliengo_params())
            shape, rng_ = jnp.shape(nominal), spec.range_
        i = [t for t, _ in jdr.specs].index(target)
        out[target] = np.stack([np.asarray(jrand._sample_range(
            jax.random.split(k, len(jdr.specs))[i], spec, rng_, shape))
            for k in keys])
    return out


def test_randomize_matches_jax():
    """identity, the schedules, sample (JAX's draws applied by the port),
    stream noise, from_dict, apply_to_config / apply_to_params."""
    jdr, pdr = _dr_pair()
    jp, pp = jrobots.aliengo_params(), robots.aliengo_params("cpu")
    jcfg, pcfg = jenv.physics.PhysicsConfig(), env.physics.PhysicsConfig()
    dims = {"obs": 48, "action": 12}

    ident = randomize.identity(pcfg, pdr, pp, dims, batch=2)
    for t, v in jrand.identity(jcfg, jdr, jp, dims).items():
        np.testing.assert_array_equal(ident[t].numpy(),
                                      np.broadcast_to(v, (2,) + v.shape))
    assert randomize.identity(pcfg) == {}

    steps = np.array([0, 30, 50, 99, 200], np.int32)
    for _, spec in jdr.specs:
        want = np.broadcast_to(np.asarray(jax.vmap(
            lambda s: jrand._ramp(spec, s))(steps)), steps.shape)
        got = randomize._ramp(spec, torch.from_numpy(steps))
        got = np.broadcast_to(np.asarray(got, np.float32), steps.shape)
        np.testing.assert_array_equal(got, want)

    keys = jax.random.split(jax.random.PRNGKey(4), len(steps))
    want = to_np(jax.vmap(lambda k, s: jrand.sample(
        jdr, jcfg, jp, k, s, stream_dims=dims))(keys, steps))
    raw = {t: torch.from_numpy(v)
           for t, v in _jax_raw_draws(jdr, keys, dims).items()}
    got = randomize.sample_from(pdr, pcfg, pp, raw, torch.from_numpy(steps))
    assert set(got) == set(want)
    for t in want:
        assert got[t].shape == want[t].shape, t
        assert rel_err(got[t].numpy(), want[t]) < 1e-6, t
    # the port's own draws: shapes, and the ranges of the uniform ones
    drawn = randomize.sample(pdr, pcfg, pp, torch.Generator().manual_seed(0),
                             torch.full((4,), 1000, dtype=torch.int32), dims)
    assert {t: tuple(v.shape) for t, v in drawn.items()} == {
        "physics.friction_mu": (4,), "robot.body_mass": (4,),
        "robot.body_inertia": (4, 3, 3), "physics.contact_kn": (4,),
        "obs.noise": (4, 48)}
    mu = drawn["physics.friction_mu"].numpy()
    assert (mu >= 0.6).all() and (mu <= 1.3).all()

    # stream noise: JAX's uncorrelated draw fed to the port
    spec = jdr.spec("obs.noise")
    value = np.random.default_rng(1).normal(size=(len(steps), 48)
                                            ).astype(np.float32)
    corr = want["obs.noise"]
    want_s = np.asarray(jax.vmap(lambda c, v, k, s: jrand.apply_stream(
        spec, c, v, k, s))(corr, value, keys, steps))
    eps = np.stack([np.asarray(jrand._sample_range(k, spec, spec.range_,
                                                   (48,))) for k in keys])
    got_s = randomize.apply_stream_from(
        pdr.spec("obs.noise"), torch.from_numpy(corr),
        torch.from_numpy(value), torch.from_numpy(eps),
        torch.from_numpy(steps))
    assert rel_err(got_s.numpy(), want_s) < 1e-6

    d = {"frequency": 7, "specs": {"physics.friction_mu": {
        "range": [0.5, 1.5], "schedule": "linear", "schedule_steps": 10},
        "action.noise": {"range_correlated": [0.0, 0.1]}}}
    for (tj, sj), (tp, sp) in zip(jrand.from_dict(d).specs,
                                  randomize.from_dict(d).specs):
        assert tj == tp and dataclasses.astuple(sj) == \
            dataclasses.astuple(sp)
    assert randomize.from_dict({}).specs == randomize.DEFAULT_SPECS
    assert randomize.from_dict(d).frequency == 7
    with pytest.raises(ValueError, match="unknown randomization target"):
        randomize._nominal("bogus.x", pcfg, pp)

    cfg2 = randomize.apply_to_config(pcfg, got)
    assert cfg2.friction_mu is got["physics.friction_mu"]
    assert cfg2.contact_kn is got["physics.contact_kn"]
    assert cfg2.joint_damping == pcfg.joint_damping
    p2 = randomize.apply_to_params(pp, got)
    assert p2.body_mass is got["robot.body_mass"]
    assert p2.body_inertia is got["robot.body_inertia"]


# ---- env ---------------------------------------------------------------------

def _jax_reset_draws(jcfg, key, global_tick):
    """The draws JAX's reset makes from ``key``, split as it splits them."""
    r1, r2, r3, _ = jax.random.split(key, 4)
    q0_scale = jax.random.uniform(r1, (12,), minval=0.5, maxval=1.5)
    qd0 = jax.random.uniform(r2, (12,), minval=-0.1, maxval=0.1)
    kx, ky, kw = jax.random.split(r3, 3)
    rngs = (jcfg.command_x_range, jcfg.command_y_range,
            jcfg.command_yaw_range)
    cmd = jnp.stack([jax.random.uniform(k, (), minval=lo, maxval=hi)
                     for k, (lo, hi) in zip((kx, ky, kw), rngs)])
    return q0_scale, qd0, cmd


def test_reset_from_draws_matches_jax_reset():
    """JAX's reset against the port's reset_from_draws on JAX's draws, with
    DR and the command curriculum on, at nonzero global ticks."""
    jdr, pdr = _dr_pair(frequency=5)
    jcfg = jenv.EnvConfig(dr=jdr, command_curriculum_ticks=100)
    cfg = env.EnvConfig(dr=pdr, command_curriculum_ticks=100)
    jp, pp = jrobots.go1_params(), robots.go1_params("cpu")
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    ticks = np.array([0, 40, 250], np.int32)
    want = to_np(jax.vmap(lambda k, g: jenv.reset(jp, jcfg, k, g))(
        keys, ticks))
    q0s, qd0, cmd = to_np(jax.vmap(
        lambda k, g: _jax_reset_draws(jcfg, k, g))(keys, ticks))
    rand = convert.rand_from_numpy(want.rand, batch=B)
    got = env.reset_from_draws(pp, cfg, torch.from_numpy(q0s),
                               torch.from_numpy(qd0), torch.from_numpy(cmd),
                               torch.from_numpy(ticks), rand)
    back = convert.env_state_to_numpy(got)
    for w, g in zip(jax.tree.leaves(want._replace(rng=None)),
                    jax.tree.leaves(back)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.ctrl.loco.iteration_counter.numpy(),
                                  ticks)

    # the port's own draws: ranges and shapes
    out = env.reset(pp, cfg, torch.Generator().manual_seed(1), 7, batch=4,
                    device="cpu")
    ratio = out.phys.q.numpy()[:, [1, 2]] / np.array([0.8, -1.6])
    assert (ratio >= 0.5).all() and (ratio <= 1.5).all()
    assert (np.abs(out.phys.qd.numpy()) <= 0.1).all()
    assert (out.global_tick.numpy() == 7).all()
    assert out.rand["obs.noise"].shape == (4, 48)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            env.reset(pp, cfg, torch.Generator(), 0, batch=1)   # the GPU


def _random_states(seed):
    """A JAX EnvState batch with random physics, commands, actions, torques."""
    rng = np.random.default_rng(seed)
    jcfg = jenv.EnvConfig()
    st = to_np(jax.vmap(lambda k: jenv.reset(jrobots.a1_params(), jcfg, k))(
        jax.random.split(jax.random.PRNGKey(seed), 4)))
    quat = rng.normal(size=(4, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    phys = st.phys._replace(
        pos=rng.normal(size=(4, 3)).astype(np.float32),
        quat=quat.astype(np.float32),
        v=rng.normal(size=(4, 3)).astype(np.float32),
        omega=rng.normal(size=(4, 3)).astype(np.float32),
        qd=(5 * rng.normal(size=(4, 12))).astype(np.float32))
    return st._replace(
        phys=phys, actions=rng.uniform(-1, 1, (4, 12)).astype(np.float32),
        torques=(30 * rng.normal(size=(4, 12))).astype(np.float32),
        progress=np.array([0, 5, 2001, 2000], np.int32))


@pytest.mark.parametrize("robot_id", [False, True],
                         ids=["obs48", "obs_robot_id"])
def test_observations_and_reward_match_jax(robot_id):
    """Observations (robot_id -1 included: all-zero one-hot) and the reward
    and termination terms, per env."""
    st = _random_states(3)
    jcfg = jenv.EnvConfig(obs_robot_id=robot_id, rew_collision=-0.5)
    cfg = env.EnvConfig(obs_robot_id=robot_id, rew_collision=-0.5)
    ids = [0, 1, 2, 0]
    jps = [jrobots.aliengo_params(), jrobots.go1_params(),
           jrobots.a1_params(), jrobots.aliengo_params()]
    jps[3] = jps[3]._replace(robot_id=jnp.int32(-1))        # a custom robot
    jp = jax.tree.map(lambda *xs: jnp.stack(xs),
                      *[p._replace(art=None) for p in jps])
    pp = robots.select_robot(robots.robot_registry("cpu"),
                             torch.tensor(ids, dtype=torch.int32))
    pp = pp._replace(robot_id=torch.tensor([0, 1, 2, -1], dtype=torch.int32))
    state = convert.env_state_from_numpy(st)

    want = np.asarray(jax.vmap(lambda p, s: jenv.observations(p, jcfg, s))(
        jp, st))
    got = env.observations(pp, cfg, state).numpy()
    assert got.shape == (4, env.num_obs(cfg)) and rel_err(got, want) < 1e-6
    if robot_id:
        np.testing.assert_array_equal(got[:, -3:], [[1, 0, 0], [0, 1, 0],
                                                    [0, 0, 1], [0, 0, 0]])

    knee = np.array([[0, 0, 0, 0], [1, 0, 0, 1], [0, 0, 0, 0],
                     [0, 1, 0, 0]], bool)
    base = np.array([False, False, True, False])
    want_r = to_np(jax.vmap(lambda p, s, k, b: jenv._reward_and_reset(
        p, jcfg, s, k, b))(jp, st, knee, base))
    got_r = env._reward_and_reset(pp, cfg, state, torch.from_numpy(knee),
                                  torch.from_numpy(base))
    assert rel_err(got_r[0].numpy(), want_r[0]) < 1e-6
    for g, w in zip(got_r[1:], want_r[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want_r[1].any() and want_r[2].any()          # falls, timeouts


@pytest.fixture(scope="module")
def ground():
    ter_j = jterrain.flat(extent=10.0, cell=0.2)
    return ter_j, convert.terrain_from_numpy(to_np(ter_j))


@pytest.mark.parametrize("with_dr", [False, True], ids=["no_dr", "dr"])
def test_env_step_matches_jax(ground, with_dr):
    """Three eager steps (a solve on the second) of JAX's vmapped env.step
    and the port's batched one from the same state; env 2 times out on the
    second step and resets."""
    ter_j, ter = ground
    jdr = jrand.DomainRandomization() if with_dr else None
    pdr = randomize.DomainRandomization() if with_dr else None
    jcfg = jenv.EnvConfig(control=JControlConfig(
        qp=JQPConfig(use_pallas=False, **CHEAP)), episode_length=3, dr=jdr)
    cfg = env.EnvConfig(control=ControlConfig(
        qp=QPConfig(use_kernel=False, **CHEAP)), episode_length=3, dr=pdr)
    jp, pp = jrobots.aliengo_params(), robots.aliengo_params("cpu")
    jstate = jax.vmap(lambda k: jenv.reset(jp, jcfg, k))(
        jax.random.split(jax.random.PRNGKey(21), B))
    jstate = jstate._replace(progress=jnp.array([0, 0, 2], jnp.int32),
                             commands=jnp.array([[0.4, 0.0, 0.1]] * B))
    state = convert.env_state_from_numpy(to_np(jstate))
    gen = torch.Generator().manual_seed(0)
    actions = np.random.default_rng(2).uniform(-1, 1, (3, B, 12)).astype(
        np.float32)
    fresh = np.zeros(B, bool)       # envs reset so far: their draws differ
    for t in range(3):
        gate = (t + 1) % cfg.control.iterations_between_mpc == 0
        jstate, jobs, jrew, jdone, jinfo = to_np(jax.vmap(
            lambda s, a: jenv.step(jp, jcfg, ter_j, s, a,
                                   solve_gate=jnp.bool_(gate)))(
            jstate, actions[t]))
        state, obs, rew, done, info = env.step(
            pp, cfg, ter, state, torch.from_numpy(actions[t]), gen,
            solve_gate=gate)
        same = ~fresh                   # envs that entered the tick alike
        for k in ("fall", "timeout"):
            np.testing.assert_array_equal(info[k].numpy()[same],
                                          jinfo[k][same])
        np.testing.assert_array_equal(done.numpy()[same], jdone[same])
        tau, jtau = info["torques"].numpy()[same], jinfo["torques"][same]
        scale = np.maximum(1.0, np.abs(jtau).max(axis=-1, keepdims=True))
        assert (np.abs(tau - jtau) / scale).max() < 5e-4, t
        assert np.abs(rew.numpy()[same] - jrew[same]).max() < 1e-5, t
        fresh |= jdone
        keep = ~fresh
        for name, g, w in zip(env.physics.PhysState._fields, state.phys,
                              jstate.phys):
            if w.dtype == bool:
                np.testing.assert_array_equal(g.numpy()[keep], w[keep])
            else:
                assert rel_err(g.numpy()[keep], w[keep]) < 1e-3, (t, name)
        assert rel_err(obs.numpy()[keep], jobs[keep]) < 1e-3, t
        if with_dr:
            for k, v in state.rand.items():
                np.testing.assert_array_equal(v.numpy()[keep],
                                              jstate.rand[k][keep])
        # every env, reset or not: the counters, and the reset envs'
        # fresh commands within the ranges
        for k in ("progress", "global_tick"):
            np.testing.assert_array_equal(getattr(state, k).numpy(),
                                          getattr(jstate, k))
        np.testing.assert_array_equal(
            state.ctrl.loco.iteration_counter.numpy(),
            jstate.ctrl.loco.iteration_counter)
        cmd = state.commands.numpy()[fresh]
        assert (np.abs(cmd[:, 0]) <= 2.5).all()
        assert (np.abs(cmd[:, 1]) <= 1.0).all()
    np.testing.assert_array_equal(state.progress.numpy(), [3, 3, 1])
    np.testing.assert_array_equal(fresh, [False, False, True])


def test_env_nan_containment():
    """A non-finite physics state stays in its env: that env is done with
    reward 0 and a finite fresh state; the others carry on."""
    cfg = env.EnvConfig(control=ControlConfig(
        qp=QPConfig(use_kernel=False, **CHEAP)))
    pp = robots.aliengo_params("cpu")
    ter = convert.terrain_from_numpy(to_np(jterrain.flat(extent=10.0,
                                                         cell=0.2)))
    gen = torch.Generator().manual_seed(3)
    state = env.reset(pp, cfg, gen, 0, batch=B, device="cpu")
    qd, v = state.phys.qd.clone(), state.phys.v.clone()
    qd[1, 3] = float("nan")
    v[1, 0] = float("inf")
    state = state._replace(phys=state.phys._replace(qd=qd, v=v))
    state, obs, rew, done, info = env.step(pp, cfg, ter, state,
                                           torch.zeros(B, 12), gen,
                                           solve_gate=False)
    assert done.tolist() == [False, True, False]
    assert float(rew[1]) == 0.0 and bool(info["fall"][1])
    for leaf in state.phys:
        assert torch.isfinite(leaf.float()).all()
    assert torch.isfinite(obs).all()
    assert state.progress.tolist() == [1, 0, 1]
