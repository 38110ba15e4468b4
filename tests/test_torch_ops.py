"""The port's math core against the JAX package, function by function.

Inputs are made with numpy from a seed and fed to both: the JAX function
under ``jax.vmap`` (it is written for one robot), the port's function on the
whole batch on the CPU. Tolerance 1e-5 absolute unless stated.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.ops import bezier as jbezier
from rl_mpc_locomotion_tpu.ops import gait as jgait
from rl_mpc_locomotion_tpu.ops import leg_kinematics as jkin
from rl_mpc_locomotion_tpu.ops import rotations as jrot
from rl_mpc_locomotion_tpu.ops import srb_dynamics as jsrb

from rl_mpc_locomotion_tpu_torch.models import robots as trobots
from rl_mpc_locomotion_tpu_torch.ops import bezier as tbezier
from rl_mpc_locomotion_tpu_torch.ops import gait as tgait
from rl_mpc_locomotion_tpu_torch.ops import leg_kinematics as tkin
from rl_mpc_locomotion_tpu_torch.ops import rotations as trot
from rl_mpc_locomotion_tpu_torch.ops import srb_dynamics as tsrb

B = 7
ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def rng_for(name):
    return np.random.default_rng(sum(map(ord, name)))


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


# ---- rotations ---------------------------------------------------------------

def _rot_inputs(name):
    rng = rng_for(name)
    theta = rng.uniform(-3, 3, B).astype(np.float32)
    vec = rng.normal(size=(B, 3)).astype(np.float32)
    rpy = rng.uniform(-1.2, 1.2, (B, 3)).astype(np.float32)
    quat = unit_quats(rng, B)
    return theta, vec, rpy, quat


ROT_CASES = {
    "rot_x": lambda th, v, rpy, q: (th,),
    "rot_y": lambda th, v, rpy, q: (th,),
    "rot_z": lambda th, v, rpy, q: (th,),
    "skew": lambda th, v, rpy, q: (v,),
    "quat_to_rot": lambda th, v, rpy, q: (q,),
    "rot_body_to_world": lambda th, v, rpy, q: (q,),
    "quat_to_rpy": lambda th, v, rpy, q: (q,),
    "rpy_to_rot": lambda th, v, rpy, q: (rpy,),
    "rpy_to_quat": lambda th, v, rpy, q: (rpy,),
    "quat_rotate_inverse": lambda th, v, rpy, q: (q, v),
}


@pytest.mark.parametrize("name", sorted(ROT_CASES))
def test_rotations(name):
    args = ROT_CASES[name](*_rot_inputs(name))
    want = jax.vmap(getattr(jrot, name))(*map(jnp.array, args))
    close(getattr(trot, name)(*map(T, args)), want)


def test_rot_to_quat_and_rpy_all_branches():
    """Rotations that reach each of the four Shepperd branches (trace > 0
    and the three near-pi turns about x, y, z)."""
    rng = rng_for("rot_to_quat")
    rpys = np.concatenate([
        rng.uniform(-1.0, 1.0, (4, 3)),
        [[3.0, 0.1, 0.2], [0.1, 1.2, 3.0], [0.2, 0.1, 3.1], [3.1, 0.05, 3.0]],
    ]).astype(np.float32)
    rots = np.asarray(jax.vmap(jrot.rpy_to_rot)(jnp.array(rpys)))
    close(trot.rot_to_quat(T(rots)), jax.vmap(jrot.rot_to_quat)(jnp.array(rots)))
    close(trot.rot_to_rpy(T(rots)), jax.vmap(jrot.rot_to_rpy)(jnp.array(rots)))


def test_axis_angle_and_rot_from_normals():
    rng = rng_for("normals")
    axis = rng.normal(size=(B, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = rng.uniform(-2, 2, B).astype(np.float32)
    close(trot.axis_angle_to_rot(T(axis), T(theta)),
          jax.vmap(jrot.axis_angle_to_rot)(jnp.array(axis), jnp.array(theta)))
    normal = np.array([0, 0, 1], np.float32) + 0.2 * rng.normal(size=(B, 3)
                                                                ).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    normal[0] = [0, 0, 1]      # parallel normals: the clamped-norm branch
    up = np.array([0, 0, 1], np.float32)
    want = jax.vmap(lambda g: jrot.rot_from_normals(jnp.array(up), g))(
        jnp.array(normal))
    close(trot.rot_from_normals(T(up), T(normal)), want)


# ---- gait ----------------------------------------------------------------------

def test_gait_tables_equal():
    np.testing.assert_array_equal(tgait.GAIT_OFFSETS.numpy(),
                                  np.asarray(jgait.GAIT_OFFSETS))
    np.testing.assert_array_equal(tgait.GAIT_DURATIONS.numpy(),
                                  np.asarray(jgait.GAIT_DURATIONS))
    np.testing.assert_array_equal(tkin.SIDE_SIGN.numpy(),
                                  np.asarray(jkin.SIDE_SIGN))
    assert (tgait.N_SEGMENTS, tgait.NUM_GAITS) == (jgait.N_SEGMENTS,
                                                   jgait.NUM_GAITS)


@pytest.mark.parametrize("gait_id", range(8))
def test_gait_functions_every_tick_of_a_cycle(gait_id):
    """All 20 ticks of a gait cycle (and the wrap), exact equality: phases
    are multiples of 0.5 in both, so contact tables may not flip."""
    counters = np.arange(0, 23, dtype=np.int32)
    n = len(counters)
    j_off, j_dur = jgait.gait_params(jnp.int32(gait_id))
    t_off, t_dur = tgait.gait_params(gait_id, "cpu")
    close(t_off, j_off, 0)
    close(t_dur, j_dur, 0)
    ids = torch.full((n,), gait_id, dtype=torch.int32)
    b_off, b_dur = tgait.gait_params(ids)
    assert b_off.shape == (n, 4)
    close(b_off[3], j_off, 0)

    j_it, j_ph = jax.vmap(lambda c: jgait.gait_iteration_phase(c, 2))(
        jnp.array(counters))
    t_it, t_ph = tgait.gait_iteration_phase(T(counters), 2)
    close(t_it, j_it, 0)
    close(t_ph, j_ph, 0)
    for name in ("contact_state", "swing_state", "mpc_table"):
        want = jax.vmap(lambda p: getattr(jgait, name)(p, j_off, j_dur))(j_ph)
        got = getattr(tgait, name)(t_ph, b_off, b_dur)
        close(got, want, 1e-7)
    close(tgait.swing_time(b_dur, 0.02)[0], jgait.swing_time(j_dur, 0.02), 1e-7)
    close(tgait.stance_time(b_dur, 0.02)[0], jgait.stance_time(j_dur, 0.02),
          1e-7)


def test_gait_id_is_clipped():
    a, _ = tgait.gait_params(torch.tensor([-3, 99]))
    close(a[0], jgait.GAIT_OFFSETS[0], 0)
    close(a[1], jgait.GAIT_OFFSETS[7], 0)
    close(tgait.gait_params(99, "cpu")[1], jgait.GAIT_DURATIONS[7], 0)


# ---- bezier --------------------------------------------------------------------

def test_cubic_bezier_family():
    rng = rng_for("bezier")
    y0 = rng.normal(size=(B, 3)).astype(np.float32)
    yf = rng.normal(size=(B, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (B, 1)).astype(np.float32)
    for name in ("cubic_bezier", "cubic_bezier_d1", "cubic_bezier_d2"):
        close(getattr(tbezier, name)(T(y0), T(yf), T(x)),
              getattr(jbezier, name)(jnp.array(y0), jnp.array(yf),
                                     jnp.array(x)))


def test_swing_trajectory():
    """(B,4) legs at phases that cover both halves and the ends."""
    rng = rng_for("swing")
    p0 = rng.normal(size=(B, 4, 3)).astype(np.float32) * 0.2
    pf = p0 + rng.normal(size=(B, 4, 3)).astype(np.float32) * 0.1
    phase = rng.uniform(0, 1, (B, 4)).astype(np.float32)
    phase[0] = [0.0, 0.5, 1.0, 0.25]
    st = rng.uniform(0.05, 0.2, (B, 4)).astype(np.float32)
    height = np.float32(0.1167)
    per_leg = jax.vmap(jbezier.swing_trajectory, in_axes=(0, 0, None, 0, 0))
    want = jax.vmap(per_leg, in_axes=(0, 0, None, 0, 0))(
        jnp.array(p0), jnp.array(pf), height, jnp.array(phase), jnp.array(st))
    got = tbezier.swing_trajectory(T(p0), T(pf), torch.tensor(height),
                                   T(phase), T(st))
    for g, w, tol in zip(got, want, (1e-5, 1e-4, 2e-3)):
        # velocity and acceleration divide by swing_time (down to 0.05 s)
        # and its square: absolute error scales with 1/st and 1/st^2
        close(g, w, tol)


# ---- leg kinematics, robots ----------------------------------------------------

def test_leg_fk_jacobian_and_hips():
    rng = rng_for("legs")
    q = rng.uniform(-1.5, 1.5, (B, 4, 3)).astype(np.float32)
    jp = jrobots.aliengo_params()
    tp = trobots.aliengo_params("cpu")
    want_p, want_j = jax.vmap(lambda qq: jkin.leg_fk_jacobian(
        qq, jp.abad_link_length, jp.hip_link_length, jp.knee_link_length))(
        jnp.array(q))
    got_p, got_j = tkin.leg_fk_jacobian(T(q), tp.abad_link_length,
                                        tp.hip_link_length,
                                        tp.knee_link_length)
    close(got_p, want_p)
    close(got_j, want_j)
    close(tkin.hip_locations(tp.abad_location),
          jkin.hip_locations(jp.abad_location), 0)
    # per-robot link lengths broadcast
    per = torch.full((B,), float(tp.abad_link_length))
    got_p2, _ = tkin.leg_fk_jacobian(T(q), per, tp.hip_link_length.expand(B),
                                     tp.knee_link_length.expand(B))
    close(got_p2, want_p)


@pytest.mark.parametrize("name", ["aliengo_params", "go1_params", "a1_params",
                                  "robot_registry"])
def test_robot_params(name):
    jp = getattr(jrobots, name)()
    tp = getattr(trobots, name)("cpu")
    for field in tp._fields[:-1]:
        close(getattr(tp, field), getattr(jp, field), 0)
    assert tp.art is None


def test_select_robot():
    reg_j, reg_t = jrobots.robot_registry(), trobots.robot_registry("cpu")
    one = trobots.select_robot(reg_t, 2)
    close(one.body_mass, jrobots.select_robot(reg_j, 2).body_mass, 0)
    ids = torch.tensor([2, 0, 1, 0], dtype=torch.int32)
    many = trobots.select_robot(reg_t, ids)
    assert many.body_inertia.shape == (4, 3, 3)
    close(many.mpc_weights[0], jrobots.a1_params().mpc_weights, 0)


# ---- srb dynamics --------------------------------------------------------------

def _srb_inputs(seed=0):
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    normal = np.array([0, 0, 1], np.float32) + 0.1 * rng.normal(
        size=(B, 3)).astype(np.float32)
    inertia = np.diag([0.033260231, 0.16117211, 0.17460442]).astype(np.float32)
    rot = np.asarray(jax.vmap(jrot.rpy_to_rot)(jnp.array(rpy)))
    inv_inertia_world = np.einsum('bji,jk,bkl->bil', rot,
                                  np.linalg.inv(inertia), rot
                                  ).astype(np.float32)
    feet = (np.array([[0.24, 0.13, -0.3], [0.24, -0.13, -0.3],
                      [-0.24, 0.13, -0.3], [-0.24, -0.13, -0.3]], np.float32)
            + rng.uniform(-0.03, 0.03, (B, 4, 3)).astype(np.float32))
    return rpy, normal, inv_inertia_world, feet


def _chain(seed=0, horizon=10):
    rpy, normal, iiw, feet = _srb_inputs(seed)
    a = jax.vmap(jsrb.build_a_mat)(jnp.array(rpy), jnp.array(normal))
    b = jax.vmap(lambda i, f: jsrb.build_b_mat(1.0 / 18.082, i, f))(
        jnp.array(iiw), jnp.array(feet))
    a_exp, b_exp = jax.vmap(lambda aa, bb: jsrb.discretize_exact(aa, bb, 0.02)
                            )(a, b)
    return (np.asarray(a), np.asarray(b), np.asarray(a_exp),
            np.asarray(b_exp))


def test_build_a_b_discretize():
    rpy, normal, iiw, feet = _srb_inputs()
    a, b, a_exp, b_exp = _chain()
    close(tsrb.build_a_mat(T(rpy), T(normal)), a)
    close(tsrb.build_a_mat(T(rpy), T(normal[0])),
          jax.vmap(lambda r: jsrb.build_a_mat(r, jnp.array(normal[0])))(
              jnp.array(rpy)))
    close(tsrb.build_b_mat(1.0 / 18.082, T(iiw), T(feet)), b)
    close(tsrb.build_b_mat(torch.full((B,), 1.0 / 18.082), T(iiw), T(feet)), b)
    got_a, got_b = tsrb.discretize_exact(T(a), T(b), 0.02)
    close(got_a, a_exp)
    close(got_b, b_exp)


@pytest.mark.parametrize("compat", [True, False])
def test_condense_chain(compat):
    _, _, a_exp, b_exp = _chain(1)
    want = jax.vmap(lambda a, b: jsrb.condense_chain(a, b, 10, compat))(
        jnp.array(a_exp), jnp.array(b_exp))
    got = tsrb.condense_chain(T(a_exp), T(b_exp), 10, compat)
    close(got[0], want[0])
    close(got[1], want[1])
    if compat:
        assert float(got[0][:, -13:].abs().max()) == 0.0


def test_gradient_and_hessian_from_chain():
    """q within 1e-5 of max(1,|q|) (entries reach 1e3); P within 1e-5 of
    max(1,|P|): both are sums of up to 130 float32 products."""
    rng = rng_for("grad")
    _, _, a_exp, b_exp = _chain(2)
    a_qp, s = tsrb.condense_chain(T(a_exp), T(b_exp), 10)
    x0 = rng.normal(size=(B, 13)).astype(np.float32)
    x_des = rng.normal(size=(B, 130)).astype(np.float32)
    w = np.asarray(jrobots.aliengo_params().mpc_weights)
    want_q = jax.vmap(lambda ss, aq, a, d: jsrb.gradient_from_chain(
        ss, aq, a, d, jnp.array(w)))(jnp.array(s.numpy()),
                                     jnp.array(a_qp.numpy()), jnp.array(x0),
                                     jnp.array(x_des))
    got_q = tsrb.gradient_from_chain(s, a_qp, T(x0), T(x_des), T(w))
    scale = max(1.0, float(np.abs(want_q).max()))
    close(got_q / scale, np.asarray(want_q) / scale)
    wb = np.tile(w, (B, 1)) * rng.uniform(0.5, 2, (B, 13)).astype(np.float32)
    want_p = jax.vmap(lambda ss, ww: jsrb.hessian_from_chain(ss, ww, 1e-5))(
        jnp.array(s.numpy()), jnp.array(wb))
    got_p = tsrb.hessian_from_chain(s, T(wb), 1e-5)
    scale = max(1.0, float(np.abs(want_p).max()))
    close(got_p / scale, np.asarray(want_p) / scale)
    close(got_p, got_p.transpose(1, 2), 1e-6 * scale)


def test_hessian_from_chain_small_sizes():
    rng = rng_for("hess-small")
    s = (rng.normal(size=(B, 2, 7, 6)) * 0.4).astype(np.float32)
    w = (np.abs(rng.normal(size=(B, 7))) + 0.2).astype(np.float32)
    want = jax.vmap(lambda ss, ww: jsrb.hessian_from_chain(ss, ww, 1e-4))(
        jnp.array(s), jnp.array(w))
    close(tsrb.hessian_from_chain(T(s), T(w), 1e-4), want)


def test_state_vec_desired_states_bounds_cone():
    rng = rng_for("states")
    v = [rng.normal(size=(B, 3)).astype(np.float32) for _ in range(6)]
    close(tsrb.build_state_vec(*map(T, v[:4])),
          jax.vmap(jsrb.build_state_vec)(*map(jnp.array, v[:4])))
    want = jax.vmap(lambda *a: jsrb.build_desired_states(*a, 0.02, 10))(
        *map(jnp.array, v))
    close(tsrb.build_desired_states(*map(T, v), 0.02, 10), want)

    table = (rng.random((B, 10, 4)) > 0.5).astype(np.float32)
    want_lb, want_ub = jax.vmap(lambda t: jsrb.constraint_bounds(
        t, 18.082, 0.4))(jnp.array(table))
    got_lb, got_ub = tsrb.constraint_bounds(T(table), torch.tensor(18.082),
                                            torch.tensor(0.4))
    close(got_lb, want_lb, 1e-4)    # values up to 2.5e3 N
    close(got_ub, want_ub, 1e-3)
    got_lb2, _ = tsrb.constraint_bounds(T(table), torch.full((B,), 18.082),
                                        torch.full((B,), 0.4))
    close(got_lb2, want_lb, 1e-4)
    close(tsrb.friction_cone_block(torch.tensor(0.4)),
          jsrb.friction_cone_block(0.4), 0)
    assert tsrb.friction_cone_block(torch.full((B,), 0.4)).shape == (B, 5, 3)
    assert (tsrb.STATE_DIM, tsrb.ACTION_DIM, tsrb.GRAVITY, tsrb.F_MAX_SCALE,
            tsrb.F_MIN_SCALE) == (jsrb.STATE_DIM, jsrb.ACTION_DIM,
                                  jsrb.GRAVITY, jsrb.F_MAX_SCALE,
                                  jsrb.F_MIN_SCALE)
