"""The port's terrain and physics against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions
(``jax.vmap`` over the envs, per-env configs for the domain-randomised
fields) and through the port's batched ones (``device="cpu"``).

Tolerances: terrain grids exactly equal; ``sample_height`` /
``sample_normal`` within 1e-6; ``_contact_force``, one ``substep`` (both
``leg_coupling`` branches), ``root_state_vector`` and
``body_contact_points`` within 1e-5 of max(1, |ref|); a whole ``step`` (five
substeps of a stiff penalty contact, which amplify float32 rounding) within
1e-4 of max(1, |ref|). The port solves the trunk's angular update with the
rotated body-frame inverse instead of an LU solve, which differs only in
rounding.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.sim import physics as jphysics
from rl_mpc_locomotion_tpu.sim import terrain as jterrain

from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.sim import physics, terrain
from rl_mpc_locomotion_tpu_torch.utils import convert

B = 5
IDS = [0, 1, 2, 0, 1]
SUBSTEP_TOL = 1e-5
STEP_TOL = 1e-4


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


TERRAINS = [
    ("flat", {}),
    ("slope_platform", dict(slope=0.15, extent=8.0, cell=0.2)),
    ("stairs", {}),
    ("random_uniform", dict(seed=3, amplitude=0.05)),
    ("uneven_patches", dict(seed=1, extent=12.0, cell=0.1)),
    ("uneven_patches", {}),
]


@pytest.mark.parametrize("name,kw", TERRAINS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(TERRAINS)])
def test_terrain_constructors_match_jax_exactly(name, kw):
    want = getattr(jterrain, name)(**kw)
    got = getattr(terrain, name)(**kw, device="cpu")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def _points(n, seed, extent):
    """World xy points inside the grid, on its edges and beyond it."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.6 * extent, 0.6 * extent, size=(n, 2))
    xy[:4] = [[-extent / 2, -extent / 2], [extent / 2, extent / 2],
              [extent, 0.0], [0.0, -extent]]
    return xy.astype(np.float32)


def test_sample_height_and_normal_match_jax():
    ter_j = jterrain.random_uniform(seed=5, extent=8.0, cell=0.1)
    ter = convert.terrain_from_numpy(jax.tree.map(np.asarray, ter_j))
    xy = _points(64, 0, 8.0)
    h_want = np.asarray(jterrain.sample_height(ter_j, jnp.asarray(xy)))
    h_got = terrain.sample_height(ter, torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(h_got, h_want, rtol=0, atol=1e-6)
    n_want = np.asarray(jterrain.sample_normal(ter_j, jnp.asarray(xy)))
    n_got = terrain.sample_normal(ter, torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(n_got, n_want, rtol=0, atol=1e-6)
    # a non-finite point reads a valid cell and gives a non-finite height
    bad = torch.tensor([[float("nan"), 0.0], [0.0, float("inf")]])
    h = terrain.sample_height(ter, bad)
    assert not torch.isfinite(h[0]) and torch.isfinite(h[1])


# ---- physics ----------------------------------------------------------------

def _jax_params(ids):
    per = [jrobots.aliengo_params, jrobots.go1_params, jrobots.a1_params]
    ps = [per[i]()._replace(art=None) for i in ids]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *ps)


def _port_params(ids):
    return robots.select_robot(robots.robot_registry("cpu"),
                               torch.tensor(ids, dtype=torch.int32))


def _dr_values(seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    return dict(friction_mu=f32(rng.uniform(0.6, 1.3, B)),
                joint_damping=f32(rng.uniform(0.8, 1.3, B)),
                contact_kn=f32(15000.0 * rng.uniform(0.7, 1.4, B)),
                body_mass=f32(rng.uniform(9.0, 27.0, B)))


def _phys_states(seed):
    """B robots in stance around the nominal pose, their feet below, near
    and above the ground, with random velocities, anchors and contacts."""
    rng = np.random.default_rng(seed)
    quat = np.concatenate([np.ones((B, 1)), 0.05 * rng.normal(size=(B, 3))],
                          axis=1)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B),
                    [0.22, 0.26, 0.29, 0.33, 0.45]], axis=1)
    state = dict(
        pos=pos, quat=quat,
        v=0.3 * rng.normal(size=(B, 3)), omega=0.3 * rng.normal(size=(B, 3)),
        q=np.tile([0.0, 0.8, -1.6], (B, 4)) + 0.1 * rng.normal(size=(B, 12)),
        qd=rng.normal(size=(B, 12)),
        anchor=pos[:, None, :2] + 0.2 * rng.normal(size=(B, 4, 2)),
        contact=rng.random((B, 4)) > 0.3,
        f_leg=rng.normal(size=(B, 4, 3)))
    state = {k: (v if v.dtype == bool else v.astype(np.float32))
             for k, v in state.items()}
    tau = (20.0 * rng.normal(size=(B, 12))).astype(np.float32)
    tau[0, :3] = 80.0                       # beyond the torque limit
    return state, tau


def _jax_run(fn, cfg, ter_j, state, tau, dr):
    """fn(params, cfg, ter, state, tau) vmapped over the envs, each env with
    its own DR values substituted."""
    params = _jax_params(IDS)

    def one(p, s, t, mu, damp, kn, mass):
        c = cfg._replace(friction_mu=mu, joint_damping=damp, contact_kn=kn)
        return fn(p._replace(body_mass=mass), c, ter_j, s, t)

    js = jphysics.PhysState(**{k: jnp.asarray(v) for k, v in state.items()})
    out = jax.jit(jax.vmap(one))(params, js, jnp.asarray(tau),
                                 dr["friction_mu"], dr["joint_damping"],
                                 dr["contact_kn"], dr["body_mass"])
    return jax.tree.map(np.asarray, out)


def _port_run(fn, cfg, ter, state, tau, dr):
    params = _port_params(IDS)._replace(
        body_mass=torch.from_numpy(dr["body_mass"]))
    cfg = cfg._replace(friction_mu=torch.from_numpy(dr["friction_mu"]),
                       joint_damping=torch.from_numpy(dr["joint_damping"]),
                       contact_kn=torch.from_numpy(dr["contact_kn"]))
    ps = convert.phys_state_from_numpy(state, batch=B)
    return fn(params, cfg, ter, ps, torch.from_numpy(tau))


def _compare_outputs(got, want, tol):
    (g_state, g_fc, g_ic), (w_state, w_fc, w_ic) = got, want
    for name, g, w in zip(physics.PhysState._fields, g_state, w_state):
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            assert rel_err(g.numpy(), w) < tol, (name, rel_err(g.numpy(), w))
    np.testing.assert_array_equal(g_ic.numpy(), w_ic)
    assert rel_err(g_fc.numpy(), w_fc) < tol


@pytest.fixture(scope="module")
def rough():
    ter_j = jterrain.random_uniform(seed=2, extent=6.0, cell=0.1,
                                    amplitude=0.02)
    return ter_j, convert.terrain_from_numpy(jax.tree.map(np.asarray, ter_j))


def test_contact_force_matches_jax():
    """Feet below, exactly on and above flat ground, with and without a
    previous contact, per-env friction and stiffness."""
    rng = np.random.default_rng(7)
    cfg = physics.PhysicsConfig()
    ter_j = jterrain.flat(extent=4.0, cell=0.1)
    ter = terrain.flat(extent=4.0, cell=0.1)
    z = np.array([-0.02, -0.001, 0.0, 0.01], np.float32)
    p_w = np.concatenate([rng.uniform(-1, 1, (B, 4, 2)),
                          np.broadcast_to(z[None, :, None], (B, 4, 1))],
                         axis=-1).astype(np.float32)
    v_w = rng.normal(size=(B, 4, 3)).astype(np.float32)
    anchor = (p_w[..., :2] + 0.05 * rng.normal(size=(B, 4, 2))
              ).astype(np.float32)
    was = rng.random((B, 4)) > 0.3
    dr = _dr_values(1)

    def jone(p, v, a, w, mu, kn):
        c = jphysics.PhysicsConfig(friction_mu=mu, contact_kn=kn)
        return jphysics._contact_force(c, ter_j, p, v, a, w)

    want = jax.tree.map(np.asarray, jax.vmap(jone)(
        p_w, v_w, anchor, was, dr["friction_mu"], dr["contact_kn"]))
    got = physics._contact_force(
        cfg._replace(friction_mu=torch.from_numpy(dr["friction_mu"]),
                     contact_kn=torch.from_numpy(dr["contact_kn"])),
        ter, torch.from_numpy(p_w), torch.from_numpy(v_w),
        torch.from_numpy(anchor), torch.from_numpy(was))
    assert rel_err(got[0].numpy(), want[0]) < SUBSTEP_TOL
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert rel_err(got[2].numpy(), want[2]) < SUBSTEP_TOL
    # the cases the test means to cover: in contact, not, and slipping
    assert want[1].any() and not want[1].all()
    assert not want[1][:, 2].any()          # exactly on the ground: no contact


@pytest.mark.parametrize("coupling", [False, True],
                         ids=["srb", "leg_coupling"])
def test_substep_matches_jax(rough, coupling):
    ter_j, ter = rough
    state, tau = _phys_states(11)
    dr = _dr_values(2)
    cfg_j = jphysics.PhysicsConfig(leg_coupling=coupling)
    cfg = physics.PhysicsConfig(leg_coupling=coupling)
    want = _jax_run(jphysics.substep, cfg_j, ter_j, state, tau, dr)
    got = _port_run(physics.substep, cfg, ter, state, tau, dr)
    _compare_outputs(got, want, SUBSTEP_TOL)
    assert want[2].any() and not want[2].all()   # some feet in contact


@pytest.mark.parametrize("coupling", [False, True],
                         ids=["srb", "leg_coupling"])
def test_step_matches_jax(rough, coupling):
    ter_j, ter = rough
    state, tau = _phys_states(12)
    dr = _dr_values(3)
    cfg_j = jphysics.PhysicsConfig(leg_coupling=coupling)
    cfg = physics.PhysicsConfig(leg_coupling=coupling)
    want = _jax_run(jphysics.step, cfg_j, ter_j, state, tau, dr)
    got = _port_run(physics.step, cfg, ter, state, tau, dr)
    _compare_outputs(got, want, STEP_TOL)


def test_root_state_and_contact_points_match_jax():
    state, _ = _phys_states(13)
    js = jphysics.PhysState(**{k: jnp.asarray(v) for k, v in state.items()})
    ps = convert.phys_state_from_numpy(state, batch=B)
    np.testing.assert_array_equal(
        physics.root_state_vector(ps).numpy(),
        np.asarray(jax.vmap(jphysics.root_state_vector)(js)))
    want = np.asarray(jax.vmap(jphysics.body_contact_points)(
        _jax_params(IDS), js))
    got = physics.body_contact_points(_port_params(IDS), ps).numpy()
    assert got.shape == (B, 8, 3) and rel_err(got, want) < SUBSTEP_TOL
    # shared (unbatched) parameters broadcast over the batch
    one = np.asarray(jax.vmap(jphysics.body_contact_points,
                              in_axes=(None, 0))(jrobots.go1_params(), js))
    assert rel_err(physics.body_contact_points(
        robots.go1_params("cpu"), ps).numpy(), one) < SUBSTEP_TOL


def test_init_state_and_converter_round_trip():
    jp = jrobots.a1_params()
    q0 = np.tile([0.0, 0.8, -1.6], 4).astype(np.float32)
    want = jax.tree.map(np.asarray, jphysics.init_state(jp, q0, 0.29))
    got = physics.init_state(robots.a1_params("cpu"), torch.from_numpy(q0),
                             0.29, batch=2, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.broadcast_to(
            w, (2,) + w.shape))
    back = convert.phys_state_to_numpy(convert.phys_state_from_numpy(want, 2))
    for a, b in zip(back, convert.phys_state_to_numpy(got)):
        np.testing.assert_array_equal(a, b)


def test_articulated_raises():
    """The articulated plant needs its model: without RobotParams.art (the
    registry's params carry none) a step raises, naming with_articulated;
    tests/test_torch_articulated.py holds the plant itself."""
    state, tau = _phys_states(14)
    ps = convert.phys_state_from_numpy(state, batch=B)
    with pytest.raises(ValueError, match="with_articulated"):
        physics.step(_port_params(IDS), physics.PhysicsConfig(articulated=True),
                     terrain.flat(extent=4.0, device="cpu"), ps,
                     torch.from_numpy(tau))
