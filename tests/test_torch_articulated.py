"""The port's articulated 18-DoF plant (``sim/articulated``) against the
JAX package, on the CPU; then the physics invariants and the closed loop of
``tests/test_articulated.py`` on the port alone.

The same numpy inputs, made from a seed, go through the JAX functions
(``jax.jit(jax.vmap(...))``, one compile for the kinematics / mass matrix /
bias terms and one for ``physics.step``, both at XLA's backend optimisation
level 0, which halves the compile and changes no float32 operation's order)
and through the port's batched ones (``device="cpu"``).

Tolerances, relative to max(1, |ref|) entry by entry:
- ``params_from_urdf`` / ``for_robot``: bitwise (both parse in float64 and
  round once to float32);
- kinematics, point Jacobians, ``H``, ``srb_equivalent`` and
  ``with_articulated``: 1e-5 (float32, sums taken in another order);
- ``rhs``, ``Hdot u``, ``dT/dq`` and one whole ``physics.step``: 1e-4. The
  bias terms are derivatives of the assembly (forward and reverse AD on
  both sides) and a step is five substeps of a stiff penalty contact and an
  18x18 solve, which amplify float32 rounding; the contact forces, whose
  scale is the 15 kN/m spring, are held to 1e-4 of max(1, |f|) as well.
- In float64 the port's closed-form bias terms equal ``torch.func``'s AD
  (jvp / grad) through its own mass matrix, and meet the energy identities
  u . ad*_u(Hu) = 0 and qd . dT/dq = 1/2 u^T Hdot u, both to 1e-10 of the
  terms' scale (rounding).

Port-only (the JAX package's own tests, at B = 3 robots with different
start velocities, to the same limits): free-fall energy drift under 1 %,
linear momentum following M g to 2 %, angular momentum about the COM under
leg pumping drifting under 5 %; and the Min-mode MPC walking Aliengo on the
articulated plant for 2 s at B = 2 with ``use_kernel=False`` (z over the
last second > 0.6 body height, mean vx in (0.1, 0.8) for a 0.4 command).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.sim import articulated as jart
from rl_mpc_locomotion_tpu.sim import physics as jphysics
from rl_mpc_locomotion_tpu.sim import terrain as jterrain

from rl_mpc_locomotion_tpu_torch.control import runner
from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.ops import rotations as rot
from rl_mpc_locomotion_tpu_torch.ops.qp import production_qp_config
from rl_mpc_locomotion_tpu_torch.sim import articulated, physics, terrain
from rl_mpc_locomotion_tpu_torch.utils import convert

KIN_TOL = 1e-5
RHS_TOL = 1e-4
STEP_TOL = 1e-4
B = 8
NU = articulated.NU
KINDS = ["aliengo", "go1", "a1"]
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets")
PORT_PARAMS = {"aliengo": robots.aliengo_params, "go1": robots.go1_params,
               "a1": robots.a1_params}
JAX_PARAMS = {"aliengo": jrobots.aliengo_params, "go1": jrobots.go1_params,
              "a1": jrobots.a1_params}
STAND_Q = np.tile([0.0, 0.8, -1.6], 4).astype(np.float32)
# XLA compiles the reference's Python-unrolled assembly in half the time
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def _stack(*xs):
    return type(xs[0])(*[torch.stack(f) for f in zip(*xs)])


# ---- the model ----------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_params_from_urdf_and_for_robot_match_jax_bitwise(kind):
    want = jart.params_from_urdf(os.path.join(ASSETS, f"{kind}.urdf"), 0.07)
    got = articulated.params_from_urdf(os.path.join(ASSETS, f"{kind}.urdf"),
                                       0.07)
    for got_p, want_p in ((got, want),
                          (articulated.for_robot(kind), jart.for_robot(kind))):
        for name, g, w in zip(articulated.ArticulatedParams._fields, got_p,
                              want_p):
            w = np.asarray(w)
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
            assert articulated.ART_RANKS[name] == w.ndim


def test_for_robot_gives_tensors_of_its_own():
    """The cache keeps numpy arrays: a caller writing into its tensors
    changes no later call's model."""
    first = articulated.for_robot("go1")
    first.link_mass.zero_()
    assert float(articulated.for_robot("go1").link_mass.sum()) > 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_srb_equivalent_and_with_articulated_match_jax(kind):
    jp = jart.with_articulated(JAX_PARAMS[kind](), kind)
    tp = articulated.with_articulated(PORT_PARAMS[kind]("cpu"), kind)
    for name in ("body_mass", "body_inertia"):
        assert rel_err(getattr(tp, name).numpy(),
                       np.asarray(getattr(jp, name))) < KIN_TOL, name
        assert getattr(tp, name).shape == np.asarray(getattr(jp, name)).shape
    for g, w in zip(tp.art, jp.art):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the composite at seeded poses, COM offset included
    q = np.random.default_rng(3).uniform(-1.2, 1.2, (4, 12)).astype(
        np.float32)
    want = jax.tree.map(np.asarray, jax.vmap(
        lambda qq: jart.srb_equivalent(jp.art, qq))(q))
    got = articulated.srb_equivalent(tp.art, torch.from_numpy(q))
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < KIN_TOL
    # srb_match=False keeps the controller's tuned constants
    keep = articulated.with_articulated(PORT_PARAMS[kind]("cpu"), kind,
                                        srb_match=False)
    assert float(keep.body_mass) == float(PORT_PARAMS[kind]().body_mass)


# ---- kinematics, H, bias terms: one JAX compile -------------------------------

def _jax_bundle(art, q, u, q_forces):
    """One robot: kinematics, every link's and foot's point Jacobian, H,
    dynamics_rhs and the two bias terms on their own."""
    kin = jart.leg_kinematics(art, q)
    jac_links = jnp.stack([
        jnp.stack([jart.point_jacobian(kin, leg, i, kin["com"][leg, i])
                   for i in range(3)]) for leg in range(4)])
    jac_feet = jnp.stack([jart.point_jacobian(kin, leg, 2, kin["foot"][leg])
                          for leg in range(4)])
    h_mat, rhs = jart.dynamics_rhs(art, q, u, q_forces)
    _, hdot_u = jax.jvp(lambda qq: jart.mass_matrix(art, qq) @ u, (q,),
                        (u[6:],))
    dtdq = jax.grad(jart._kinetic, argnums=1)(art, q, u)
    return dict(kin=kin, jac_links=jac_links, jac_feet=jac_feet,
                H=jart.mass_matrix(art, q), H_rhs=h_mat, rhs=rhs,
                hdot_u=hdot_u, dtdq=dtdq)


@pytest.fixture(scope="module")
def bundle():
    """8 seeded poses over the whole joint range, velocities and forces;
    the JAX results (vmapped over a stacked model: robots 0-4 Aliengo, 5
    Go1, 6-7 A1) and the port's inputs."""
    rng = np.random.default_rng(0)
    q = rng.uniform(-1.2, 1.2, (B, 12)).astype(np.float32)
    u = rng.normal(size=(B, NU)).astype(np.float32)
    u[:, 6:] *= 3.0
    q_forces = (10.0 * rng.normal(size=(B, NU))).astype(np.float32)
    kinds = ["aliengo"] * 5 + ["go1"] + ["a1"] * 2
    jarts = [jart.for_robot(k) for k in kinds]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jarts)
    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(_jax_bundle),
                                            compiler_options=FAST_COMPILE)(
        stacked, q, u, q_forces))
    # JAX's stacked model carried across (utils/convert)
    port_art = convert.articulated_params_from_numpy(
        jax.tree.map(np.asarray, stacked))
    inputs = [torch.from_numpy(x) for x in (q, u, q_forces)]
    return want, port_art, inputs


def test_leg_kinematics_matches_jax(bundle):
    want, art, (q, _, _) = bundle
    got = articulated.leg_kinematics(art, q)
    assert set(got) == set(want["kin"])
    for k, w in want["kin"].items():
        assert tuple(got[k].shape) == w.shape, k
        assert rel_err(got[k].numpy(), w) < KIN_TOL, k


@pytest.mark.parametrize("leg", range(4))
def test_point_jacobian_matches_jax_for_every_link_and_foot(bundle, leg):
    want, art, (q, _, _) = bundle
    kin = articulated.leg_kinematics(art, q)
    for i in range(3):
        got = articulated.point_jacobian(kin, leg, i, kin["com"][:, leg, i])
        assert tuple(got.shape) == (B, 3, NU)
        assert rel_err(got.numpy(), want["jac_links"][:, leg, i]) < KIN_TOL
    got = articulated.point_jacobian(kin, leg, 2, kin["foot"][:, leg])
    assert rel_err(got.numpy(), want["jac_feet"][:, leg]) < KIN_TOL


def test_mass_matrix_matches_jax(bundle):
    want, art, (q, _, _) = bundle
    got = articulated.mass_matrix(art, q)
    assert tuple(got.shape) == (B, NU, NU) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want["H"]) < KIN_TOL
    # shared model: each robot's own (here robot 0, an Aliengo)
    one = articulated.mass_matrix(articulated.for_robot("aliengo"), q[:1])
    assert rel_err(one.numpy(), want["H"][:1]) < KIN_TOL


def test_dynamics_rhs_matches_jax(bundle):
    want, art, (q, u, q_forces) = bundle
    h_mat, rhs = articulated.dynamics_rhs(art, q, u, q_forces)
    assert rel_err(h_mat.numpy(), want["H_rhs"]) < KIN_TOL
    assert rel_err(rhs.numpy(), want["rhs"]) < RHS_TOL


def test_bias_terms_match_jax_on_their_own(bundle):
    """Hdot u (forward AD in the direction qd) and dT/dq (the gradient of
    the batch's kinetic energy) each against JAX's jvp / grad."""
    want, art, (q, u, _) = bundle
    h_mat, hdot_u, dtdq = articulated._bias_terms(art, q, u)
    assert rel_err(hdot_u.numpy(), want["hdot_u"]) < RHS_TOL
    assert rel_err(dtdq.numpy(), want["dtdq"]) < RHS_TOL
    assert np.abs(want["hdot_u"]).max() > 1.0 and np.abs(
        want["dtdq"]).max() > 1.0      # the terms the test means to hold
    np.testing.assert_array_equal(h_mat.numpy(), articulated.mass_matrix(
        art, q).numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_float64_bias_terms_equal_torch_func_ad(kind):
    """The closed forms against AD through the port's own assembly in
    float64: Hdot u as torch.func.jvp of q -> H(q) u in the direction qd,
    dT/dq as torch.func.grad of the batch's kinetic energy (the robots are
    independent, so it is each robot's own gradient)."""
    rng = np.random.default_rng(KINDS.index(kind))
    art = articulated.for_robot(kind)
    q = torch.from_numpy(rng.uniform(-1.2, 1.2, (6, 12)))
    u = torch.from_numpy(2.0 * rng.normal(size=(6, NU)))
    _, hdot_u, dtdq = articulated._bias_terms(art, q, u)
    _, hdot_ad = torch.func.jvp(
        lambda qq: (articulated.mass_matrix(art, qq) @ u[..., None])[..., 0],
        (q,), (u[:, 6:],))
    dtdq_ad = torch.func.grad(
        lambda qq: articulated._kinetic(art, qq, u).sum())(q)
    for got, want in ((hdot_u, hdot_ad), (dtdq, dtdq_ad)):
        assert got.dtype == torch.float64
        scale = float(want.abs().max())
        assert scale > 1.0
        assert float((got - want).abs().max()) < 1e-10 * scale


def test_float64_energy_identities_and_mass_matrix():
    """The port in float64: H symmetric positive definite with its v-block
    the total mass, u . ad*_u(Hu) = 0 (the co-adjoint rows do no work) and
    qd . dT/dq = 1/2 u^T Hdot u (so the Euler-Poincare equations conserve
    energy), to 1e-10 of the terms' scale."""
    rng = np.random.default_rng(5)
    art = articulated.for_robot("a1")
    q = torch.from_numpy(rng.uniform(-1.2, 1.2, (4, 12)))
    u = torch.from_numpy(rng.normal(size=(4, NU)))
    h_mat, hdot_u, dtdq = articulated._bias_terms(art, q, u)
    assert h_mat.dtype == torch.float64
    np.testing.assert_allclose(h_mat.numpy(), h_mat.mT.numpy(), atol=1e-12)
    assert torch.linalg.eigvalsh(h_mat).min() > 0
    m_tot = float(art.trunk_mass.double() + art.link_mass.double().sum())
    np.testing.assert_allclose(h_mat[:, :3, :3].numpy(),
                               np.broadcast_to(m_tot * np.eye(3), (4, 3, 3)),
                               rtol=1e-12)
    power = (u[:, 6:] * dtdq).sum(-1)
    half = 0.5 * (u * hdot_u).sum(-1)
    scale = (u[:, 6:].abs() * dtdq.abs()).sum(-1)
    assert float(((power - half).abs() / scale).max()) < 1e-10
    _, rhs = articulated.dynamics_rhs(art, q, u, torch.zeros_like(u))
    # rhs = -Hdot u - ad* + [0, dT/dq]: u . rhs = -u.Hdot u + qd.dT/dq
    work = (u * rhs).sum(-1) + 0.5 * (u * hdot_u).sum(-1)
    assert float((work.abs() / scale).max()) < 1e-10


# ---- one physics.step -----------------------------------------------------------

def _phys_states(seed, b):
    """b robots around the stand pose, some feet below, near and above the
    ground, with random velocities, anchors and contacts."""
    rng = np.random.default_rng(seed)
    quat = np.concatenate([np.ones((b, 1)), 0.05 * rng.normal(size=(b, 3))],
                          axis=1)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = np.stack([rng.uniform(-0.5, 0.5, b), rng.uniform(-0.5, 0.5, b),
                    np.linspace(0.24, 0.45, b)], axis=1)
    state = dict(
        pos=pos, quat=quat,
        v=0.3 * rng.normal(size=(b, 3)), omega=0.3 * rng.normal(size=(b, 3)),
        q=np.tile([0.0, 0.8, -1.6], (b, 4)) + 0.1 * rng.normal(size=(b, 12)),
        qd=rng.normal(size=(b, 12)),
        anchor=pos[:, None, :2] + 0.02 * rng.normal(size=(b, 4, 2)),
        contact=rng.random((b, 4)) > 0.3,
        f_leg=rng.normal(size=(b, 4, 3)))
    state = {k: (v if v.dtype == bool else v.astype(np.float32))
             for k, v in state.items()}
    tau = (20.0 * rng.normal(size=(b, 12))).astype(np.float32)
    tau[0, :3] = 80.0                       # beyond the torque limit
    return state, tau


@pytest.fixture(scope="module")
def jax_step():
    """jax.jit(jax.vmap(physics.step)) over a stacked model and per-env
    joint damping and contact stiffness: one compile, used by both step
    tests."""
    ter = jterrain.random_uniform(seed=2, extent=6.0, cell=0.1,
                                  amplitude=0.02)
    cfg = jphysics.PhysicsConfig(articulated=True)

    def one(params, state, tau, damping, kn):
        c = cfg._replace(joint_damping=damping, contact_kn=kn)
        return jphysics.step(params, c, ter, state, tau)

    fn = jax.jit(jax.vmap(one), compiler_options=FAST_COMPILE)

    def run(kinds, state, tau, damping, kn):
        params = jax.tree.map(lambda *xs: jnp.stack(xs), *[
            jart.with_articulated(JAX_PARAMS[k](), k) for k in kinds])
        js = jphysics.PhysState(**{k: jnp.asarray(v)
                                   for k, v in state.items()})
        return jax.tree.map(np.asarray, fn(params, js, tau, damping, kn))

    return run, convert.terrain_from_numpy(jax.tree.map(np.asarray, ter))


def _compare_step(got, want, n):
    (g_state, g_fc, g_ic), (w_state, w_fc, w_ic) = got, want
    for name, g, w in zip(physics.PhysState._fields, g_state, w_state):
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w[:n], err_msg=name)
        else:
            assert rel_err(g.numpy(), w[:n]) < STEP_TOL, (
                name, rel_err(g.numpy(), w[:n]))
    np.testing.assert_array_equal(g_ic.numpy(), w_ic[:n])
    assert rel_err(g_fc.numpy(), w_fc[:n]) < STEP_TOL
    assert w_ic[:n].any() and not w_ic[:n].all()   # some feet in contact


def test_articulated_step_matches_jax(jax_step):
    """8 Aliengo robots, a shared model and the default config."""
    run, ter = jax_step
    state, tau = _phys_states(11, B)
    cfg = physics.PhysicsConfig()
    want = run(["aliengo"] * B, state, tau,
               np.full(B, cfg.joint_damping, np.float32),
               np.full(B, cfg.contact_kn, np.float32))
    params = articulated.with_articulated(robots.aliengo_params("cpu"),
                                          "aliengo")
    got = physics.step(params, cfg._replace(articulated=True), ter,
                       convert.phys_state_from_numpy(state, batch=B),
                       torch.from_numpy(tau))
    _compare_step(got, want, B)
    np.testing.assert_array_equal(got[0].f_leg.numpy(), state["f_leg"])


def test_articulated_step_stacked_kinds_and_per_env_config(jax_step):
    """A stacked model of the three kinds (B = 3) with per-env joint
    damping and contact stiffness ((B,) tensors), against JAX run per env
    (the first three of the compiled batch of 8)."""
    run, ter = jax_step
    state, tau = _phys_states(12, B)
    rng = np.random.default_rng(4)
    damping = rng.uniform(0.5, 2.0, B).astype(np.float32)
    kn = (15000.0 * rng.uniform(0.7, 1.4, B)).astype(np.float32)
    want = run(KINDS + ["aliengo"] * (B - 3), state, tau, damping, kn)
    per = [articulated.with_articulated(PORT_PARAMS[k]("cpu"), k)
           for k in KINDS]
    params = robots.select_robot(robots.robot_registry("cpu"),
                                 torch.arange(3, dtype=torch.int32))
    params = params._replace(
        body_mass=torch.stack([p.body_mass for p in per]),
        body_inertia=torch.stack([p.body_inertia for p in per]),
        art=_stack(*[p.art for p in per]))
    cfg = physics.PhysicsConfig(articulated=True,
                                joint_damping=torch.from_numpy(damping[:3]),
                                contact_kn=torch.from_numpy(kn[:3]))
    state3 = {k: v[:3] for k, v in state.items()}
    got = physics.step(params, cfg, ter,
                       convert.phys_state_from_numpy(state3, batch=3),
                       torch.from_numpy(tau[:3]))
    _compare_step(got, want, 3)


def test_robot_params_round_trip_with_art():
    jp = jart.with_articulated(jrobots.go1_params(), "go1")
    tp = convert.robot_params_from_numpy(jax.tree.map(np.asarray, jp))
    assert isinstance(tp.art, articulated.ArticulatedParams)
    for g, w in zip(tp.art, jp.art):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = convert.robot_params_to_numpy(tp)
    for a, w in zip(back[-1], jp.art):
        np.testing.assert_array_equal(a, np.asarray(w))
    again = convert.robot_params_from_numpy(back)
    for a, b in zip(again.art, tp.art):
        assert torch.equal(a, b)
    # a stacked model keeps its (B,) axis both ways
    stacked = _stack(*[articulated.for_robot(k) for k in KINDS])
    arrays = convert.articulated_params_to_numpy(stacked)
    assert arrays[0].shape == (3,) and arrays[7].shape == (3, 4, 3, 3, 3)
    for a, b in zip(convert.articulated_params_from_numpy(arrays), stacked):
        assert torch.equal(a, b)
    assert convert.robot_params_to_numpy(robots.a1_params())[-1] is None
    assert convert.robot_params_from_numpy(
        convert.robot_params_to_numpy(robots.a1_params())).art is None


# ---- physics invariants (port only; tests/test_articulated.py's limits) ---------

def _freefall(torques_fn, steps, b=3, dt=0.001, seed=6):
    """b Aliengo robots far above the ground, each with its own start
    velocities; the trajectory of every substep (float32 states)."""
    params = robots.aliengo_params("cpu")._replace(
        art=articulated.for_robot("aliengo"))
    cfg = physics.PhysicsConfig(dt=dt, articulated=True, joint_damping=0.0,
                                joint_friction=0.0)
    ter = terrain.flat(extent=10.0, cell=0.5, device="cpu")
    rng = np.random.default_rng(seed)
    st = physics.init_state(params, torch.from_numpy(STAND_Q), 50.0, b,
                            "cpu")
    base = np.array([[0.3, -0.2, 0.5], [0.4, 0.3, -0.2]])
    st = st._replace(
        v=torch.from_numpy((base[0] * rng.uniform(0.5, 1.5, (b, 3))
                            ).astype(np.float32)),
        omega=torch.from_numpy((base[1] * rng.uniform(0.5, 1.5, (b, 3))
                                ).astype(np.float32)),
        qd=torch.from_numpy(rng.uniform(0.25, 0.75, (b, 12)).astype(
            np.float32)))
    traj = []
    for t in range(steps):
        st, _, _ = articulated.substep(params, cfg, ter, st, torques_fn(t, b))
        traj.append(st)
    return cfg, params.art, physics.PhysState(
        *[torch.stack(x) for x in zip(*traj)])


def _energy_momentum(art, traj):
    """Per substep and robot (T,b): energy, world linear momentum and
    angular momentum about the world COM, evaluated in float64."""
    t_len, b = traj.pos.shape[:2]
    f64 = {k: getattr(traj, k).double().reshape((t_len * b,) + tuple(
        getattr(traj, k).shape[2:])) for k in ("pos", "quat", "v", "omega",
                                               "q", "qd")}
    art64 = articulated.ArticulatedParams(*[x.double() for x in art])
    r_wb = rot.quat_to_rot(f64["quat"]).mT
    u = torch.cat([(r_wb.mT @ f64["v"][..., None])[..., 0],
                   (r_wb.mT @ f64["omega"][..., None])[..., 0], f64["qd"]],
                  dim=-1)
    h = articulated.mass_matrix(art64, f64["q"])
    hu = (h @ u[..., None])[..., 0]
    ke = 0.5 * (u * hu).sum(-1)
    kin = articulated.leg_kinematics(art64, f64["q"])
    coms_b = torch.cat([kin["com"].reshape(-1, 12, 3),
                        art64.trunk_com.expand(t_len * b, 1, 3)], dim=1)
    masses = torch.cat([art64.link_mass.reshape(12), art64.trunk_mass[None]])
    coms_w = f64["pos"][:, None] + coms_b @ r_wb.mT
    pe = physics.GRAVITY * (masses * coms_w[..., 2]).sum(-1)
    p_w = (r_wb @ hu[:, :3, None])[..., 0]
    com_w = (masses[:, None] * coms_w).sum(1) / masses.sum()
    l_w = ((r_wb @ hu[:, 3:6, None])[..., 0]
           + torch.linalg.cross(f64["pos"] - com_w, p_w, dim=-1))
    shape = (t_len, b)
    return ((ke + pe).reshape(shape).numpy(),
            p_w.reshape(shape + (3,)).numpy(),
            l_w.reshape(shape + (3,)).numpy(), float(masses.sum()))


@pytest.fixture(scope="module")
def zero_torque_fall():
    cfg, art, traj = _freefall(lambda t, b: torch.zeros(b, 12), 100)
    return cfg, _energy_momentum(art, traj)


def test_freefall_energy_conserved(zero_torque_fall):
    _, (es, _, _, _) = zero_torque_fall
    scale = np.maximum(np.abs(es[0]), 1.0)
    drift = np.abs(es[-1] - es[0]) / scale
    assert (drift < 0.01).all(), drift


def test_freefall_linear_momentum_follows_gravity(zero_torque_fall):
    cfg, (_, ps, _, m_tot) = zero_torque_fall
    steps = len(ps)
    expect = ps[0] + np.array([0, 0, -physics.GRAVITY * m_tot]) * \
        cfg.dt * (steps - 1)
    for i in range(ps.shape[1]):
        np.testing.assert_allclose(ps[-1, i], expect[i],
                                   atol=0.02 * abs(expect[i, 2]))


def test_freefall_angular_momentum_conserved_with_leg_pumping():
    """Internal torques and uniform gravity cannot change L about the COM."""
    phase = torch.arange(12, dtype=torch.float32)
    _, art, traj = _freefall(
        lambda t, b: 8.0 * torch.sin(0.05 * t + phase).expand(b, 12), 150)
    _, _, ls, _ = _energy_momentum(art, traj)
    drift = np.abs(ls[-1] - ls[0]).max(axis=-1)
    scale = np.maximum(np.abs(ls).max(axis=(0, 2)), 1.0)
    assert (drift / scale < 0.05).all(), (ls[0], ls[-1])


# ---- closed loop (port only) ---------------------------------------------------

def test_aliengo_trot_on_the_articulated_plant():
    """Min-mode MPC (use_kernel=False: on the CPU the plain versions) walks
    two Aliengo robots on the articulated plant for 2 s; the controller
    keeps the reference's tuned SRB constants (model mismatch, as in
    tests/test_articulated.py)."""
    b, n = 2, 200
    params = robots.aliengo_params("cpu")._replace(
        art=articulated.for_robot("aliengo"))
    cfg = ControlConfig(qp=production_qp_config()._replace(use_kernel=False))
    pcfg = physics.PhysicsConfig(articulated=True)
    ter = terrain.flat(extent=10.0, cell=0.5, device="cpu")
    q0 = torch.from_numpy(STAND_Q).expand(b, 12).clone()
    q0[1] += 0.02 * torch.tensor([1.0, -1.0, 0.5]).repeat(4)
    ps = physics.init_state(params, q0, float(params.body_height) + 0.03, b,
                            "cpu")
    cs = runner.init_state(params, cfg, batch=b, device="cpu")
    cmd = torch.tensor([0.4, 0.0, 0.0]).expand(b, 3)
    zs, vxs = [], []
    for t in range(n):
        body = physics.root_state_vector(ps)
        cs, tau, _ = runner.min_step(params, cfg, cs, ps.q, ps.qd, body, cmd,
                                     solve_gate=t % 2 == 1)
        ps, _, _ = physics.step(params, pcfg, ter, ps, tau)
        zs.append(ps.pos[:, 2])
        vxs.append(ps.v[:, 0])
    zs, vxs = torch.stack(zs).numpy(), torch.stack(vxs).numpy()
    assert np.isfinite(zs).all() and np.isfinite(ps.pos.numpy()).all()
    z_late = zs[n // 2:]
    assert (z_late > 0.6 * float(params.body_height)).all(), z_late.min()
    vx_late = vxs[n // 2:].mean(axis=0)
    assert ((0.1 < vx_late) & (vx_late < 0.8)).all(), vx_late
