"""The PyTorch port's Min-mode control tick against the JAX package and the
scalar float64 oracle, on the CPU at a small batch.

The same inputs, made with numpy from a seed, go through
``jax.vmap(runner.min_step)`` and through the port's batched
``runner.min_step`` (``device="cpu"``). Both sides run the plain QP pipeline
(``use_pallas=False`` / ``use_kernel=False``) unless a test says otherwise.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.control import runner as jrunner
from rl_mpc_locomotion_tpu.control.types import ControlConfig as JControlConfig
from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.ops.qp import QPConfig as JQPConfig

from rl_mpc_locomotion_tpu_torch.control import runner
from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.ops.qp import QPConfig, production_qp_config
from rl_mpc_locomotion_tpu_torch.utils import convert

from reference_oracle import OracleController
from test_control_step import synthetic_trajectory

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "rl_mpc_locomotion_tpu_torch"

# the production solve shape on the plain pipeline of both packages
FAST = dict(iters=24, iters2=0, adaptive_rho=False, deferred_rho=True,
            polish=False, ruiz_iters=2)


def batched_trajectory(n_ticks, batch, seed):
    """synthetic_trajectory for every robot plus a small per-robot offset
    made from the seed: lists of (B,12), (B,12), (B,13) float32 arrays."""
    rng = np.random.default_rng(seed)
    dq = rng.normal(size=(batch, 12)) * 0.02
    dv = rng.normal(size=(batch, 3)) * 0.05
    out = []
    for q, qd, body in synthetic_trajectory(n_ticks, seed=seed):
        bq = (q[None] + dq).astype(np.float32)
        bqd = np.tile(qd, (batch, 1)).astype(np.float32)
        bb = np.tile(body, (batch, 1)).astype(np.float32)
        bb[:, 7:10] += dv.astype(np.float32)
        out.append((bq, bqd, bb))
    return out


def run_jax(traj, commands, gait_id, explicit_gate, qp_kwargs):
    params = jrobots.aliengo_params()
    cfg = JControlConfig(qp=JQPConfig(use_pallas=False, **qp_kwargs))
    batch = traj[0][0].shape[0]
    state = jax.vmap(lambda _: jrunner.init_state(params, cfg))(
        jnp.arange(batch))
    taus, mets = [], []
    for t, (q, qd, b) in enumerate(traj):
        gate = jnp.bool_(t % 2 == 1) if explicit_gate else None
        state, tau, met = jax.vmap(
            lambda s, q1, qd1, b1, c1: jrunner.min_step(
                params, cfg, s, q1, qd1, b1, c1, gait_id=gait_id,
                solve_gate=gate))(state, jnp.array(q), jnp.array(qd),
                                  jnp.array(b), jnp.array(commands))
        taus.append(np.asarray(tau))
        mets.append(jax.tree.map(np.asarray, met))
    return taus, mets, state


def run_port(traj, commands, gait_id, explicit_gate, qp_cfg, params=None):
    params = robots.aliengo_params("cpu") if params is None else params
    cfg = ControlConfig(qp=qp_cfg)
    batch = traj[0][0].shape[0]
    state = runner.init_state(params, cfg, batch=batch, device="cpu")
    taus, mets = [], []
    cmd = torch.from_numpy(commands)
    for t, (q, qd, b) in enumerate(traj):
        gate = (t % 2 == 1) if explicit_gate else None
        state, tau, met = runner.min_step(
            params, cfg, state, torch.from_numpy(q), torch.from_numpy(qd),
            torch.from_numpy(b), cmd, gait_id=gait_id, solve_gate=gate)
        taus.append(tau.numpy())
        mets.append({k: v.numpy() for k, v in met.items()})
    return taus, mets, state


def first_step_swing(tick, gait_id, batch):
    """(B,4) bool: legs in swing in row 0 of the MPC contact table at the
    solve of ``tick`` (iterations_between_mpc = 2)."""
    from rl_mpc_locomotion_tpu_torch.ops import gait
    offsets, durations = gait.gait_params(gait_id, "cpu")
    it, _ = gait.gait_iteration_phase(torch.full((batch,), tick), 2)
    table = gait.mpc_table(it, offsets.expand(batch, 4),
                           durations.expand(batch, 4))
    return table[:, 0].numpy() == 0.0


def assert_torques_close(got, want, tol, what):
    for t, (g, w) in enumerate(zip(got, want)):
        scale = np.maximum(1.0, np.abs(w).max(axis=-1, keepdims=True))
        err = (np.abs(g - w) / scale).max()
        assert err < tol, f"{what} tick {t}: rel torque err {err:.2e} >= {tol}"


@pytest.mark.parametrize("gait_id,explicit_gate", [
    (0, True),     # trot, the caller passes the solve gate
    (1, False),    # bound, gate decided from the per-robot counters
])
def test_min_step_matches_jax(gait_id, explicit_gate):
    """12 ticks, B = 3 with per-robot offsets: torques within 5e-4 of
    max(1, |tau|) (the tolerance tests/test_control_step.py holds the JAX
    step to), forces within 1e-3 relative, and the carried state at the end."""
    n_ticks, batch = 12, 3
    traj = batched_trajectory(n_ticks, batch, seed=4 + gait_id)
    commands = np.tile(np.array([0.4, 0.1, 0.2], np.float32), (batch, 1))
    commands[:, 0] += np.array([0.0, 0.05, -0.05], np.float32)

    j_taus, j_mets, j_state = run_jax(traj, commands, gait_id, explicit_gate,
                                      FAST)
    p_taus, p_mets, p_state = run_port(traj, commands, gait_id,
                                       explicit_gate,
                                       QPConfig(use_kernel=False, **FAST))
    assert_torques_close(p_taus, j_taus, 5e-4, f"gait {gait_id}")
    for t in range(n_ticks):
        jf, pf = j_mets[t]["f_ff"], p_mets[t]["f_ff"]
        assert np.abs(pf - jf).max() / max(1.0, np.abs(jf).max()) < 1e-3
        np.testing.assert_array_equal(p_mets[t]["contact_states"] > 0,
                                      j_mets[t]["contact_states"] > 0)
        if t % 2 == 1:
            # a solve tick: legs off the ground in the first horizon step
            # get exactly zero force
            assert np.all(pf[first_step_swing(t, gait_id, batch)] == 0.0)
        else:
            np.testing.assert_array_equal(pf, p_mets[t - 1]["f_ff"] if t
                                          else np.zeros_like(pf))

    # carried state: same counters, and the warm start within 1e-3 relative
    j_np = jax.tree.map(np.asarray, j_state)
    back = convert.control_state_to_numpy(p_state)
    np.testing.assert_array_equal(back[1][0], j_np.loco.iteration_counter)
    jx, px = j_np.loco.qp_state.x, p_state.loco.qp_state.x.numpy()
    assert np.abs(px - jx).max() / max(1.0, np.abs(jx).max()) < 1e-3
    np.testing.assert_allclose(p_state.est.com_z.numpy(), j_np.est.com_z,
                               atol=1e-5)


def test_min_step_matches_oracle():
    """Port (ACCURATE_QP, plain pipeline) against the scalar float64 oracle
    over 12 ticks of trot: 5e-4 of max(1, |tau|), as
    tests/test_control_step.py::test_min_mode_trot_flat."""
    n_ticks = 12
    commands = np.array([0.4, 0.1, 0.2], np.float32)
    traj = synthetic_trajectory(n_ticks)
    oracle = OracleController()
    want = [oracle.run(q.astype(float), qd.astype(float), b.astype(float),
                       commands.astype(float))[None] for q, qd, b in traj]
    accurate = QPConfig(iters=300, iters2=300, adaptive_rho=True, polish=True)
    got, _, _ = run_port([(q[None], qd[None], b[None]) for q, qd, b in traj],
                         commands[None], 0, False, accurate)
    assert_torques_close(got, want, 5e-4, "oracle")


def test_production_config_on_cpu_matches_plain_pipeline():
    """The production config routes through ops.cuda.fused_qp, which on CPU
    tensors takes the kernel's plain version. Up to and including the first
    solve the two pipelines compute the same thing: torques within 5e-3 of
    max(1, |tau|). From the second solve on they differ by design: the
    kernel takes its residuals at x~, the plain pipeline at the relaxed x,
    so the deferred rho multipliers part after the first solve (the JAX
    package's two paths do the same). Later ticks are held to what both must
    give: finite torques, no divergence, rho_mult inside its clips."""
    traj = batched_trajectory(12, 2, seed=11)
    commands = np.tile(np.array([0.5, 0.0, 0.1], np.float32), (2, 1))
    fused, f_mets, f_state = run_port(traj, commands, 0, True,
                                      production_qp_config())
    plain, _, _ = run_port(traj, commands, 0, True,
                           production_qp_config()._replace(use_kernel=False))
    assert_torques_close(fused[:3], plain[:3], 5e-3, "fused-vs-plain")
    assert all(np.isfinite(t).all() for t in fused)
    assert not any(m["qp_diverged"].any() for m in f_mets)
    rm = f_state.loco.qp_state.rho_mult.numpy()
    assert np.all((rm >= 1e-3) & (rm <= 1e3))


def test_heterogeneous_batch():
    """A1 + Go1 + Aliengo in one batch through select_robot: robots 0 and 3
    (both Aliengo, same inputs) agree, different robots differ — the check
    of tests/test_control_step.py::test_batch_heterogeneous_robots."""
    ids = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    params = robots.select_robot(robots.robot_registry("cpu"), ids)
    cfg = ControlConfig(qp=QPConfig(iters=20, iters2=0, adaptive_rho=False,
                                    polish=False, ruiz_iters=2))
    state = runner.init_state(params, cfg, batch=4, device="cpu")
    q = torch.tensor([0.0, 0.8, -1.6]).repeat(4, 4)
    qd = torch.zeros(4, 12)
    body = torch.tensor([0, 0, 0.3, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0.0]
                        ).repeat(4, 1)
    cmds = torch.tensor([0.3, 0.0, 0.0]).repeat(4, 1)
    for t in range(4):
        state, taus, _ = runner.min_step(params, cfg, state, q, qd, body,
                                         cmds, solve_gate=(t % 2 == 1))
    taus = taus.numpy()
    assert taus.shape == (4, 12) and np.isfinite(taus).all()
    np.testing.assert_allclose(taus[0], taus[3], atol=1e-5)
    assert np.abs(taus[0] - taus[1]).max() > 0.1


def test_cli_bench_on_cpu(capsys):
    """`cli bench --device cpu` (``bench.bench``): the lockstep loop runs the
    plain versions, launches no kernel, and names its times as CPU times (no
    device time, no solves/s under the device metric's name)."""
    import json
    from rl_mpc_locomotion_tpu_torch import cli
    from rl_mpc_locomotion_tpu_torch.ops.cuda import fused_qp
    before = fused_qp.launch_count()
    cli.main(["bench", "--batch", "4", "--periods", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    d = out["detail"]
    assert fused_qp.launch_count() == before and d["kernel_launches"] == 0
    assert out["metric"] == "mpc_solves_per_s" and d["batch"] == 4
    assert d["device"] == "cpu" and d["torques_finite"] and d["periods"] == 2
    assert d["mpc_period_ms"] is None and out["value"] is None
    assert d["cpu_mpc_period_ms"] > 0 and out["cpu_value"] > 0
    assert d["qp_diverged_frac"] == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):   # default: the GPU
            cli.main(["bench", "--batch", "4", "--periods", "1"])


def test_converter_round_trip():
    """JAX containers -> numpy -> port -> numpy: same leaves, batch added."""
    jp = jrobots.aliengo_params()
    jcfg = JControlConfig()
    jstate = jax.tree.map(np.asarray, jrunner.init_state(jp, jcfg))
    state = convert.control_state_from_numpy(jstate, batch=3, device="cpu")
    ref = runner.init_state(robots.aliengo_params("cpu"), ControlConfig(),
                            batch=3, device="cpu")
    for a, b in zip(jax.tree.leaves(convert.control_state_to_numpy(state)),
                    jax.tree.leaves(convert.control_state_to_numpy(ref))):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back = convert.control_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a[0], b)

    # a state that is already batched keeps its axis
    jb = jax.tree.map(np.asarray, jax.vmap(
        lambda _: jrunner.init_state(jp, jcfg))(jnp.arange(2)))
    assert convert.control_state_from_numpy(jb).loco.p0.shape == (2, 4, 3)

    params_np = jax.tree.map(np.asarray, jp._replace(art=None))
    pp = convert.robot_params_from_numpy(params_np)
    for a, b in zip(pp[:-1], robots.aliengo_params("cpu")[:-1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(convert.robot_params_to_numpy(pp)[:-1], params_np[:-1]):
        np.testing.assert_array_equal(a, b)

    qp = convert.qp_state_from_numpy(
        dict(x=np.ones(12), z=np.zeros(20), y=np.zeros(20), rho_mult=2.0),
        batch=2)
    assert qp.x.shape == (2, 12) and qp.rho_mult.shape == (2,)
    assert qp.x.dtype == torch.float32
    np.testing.assert_array_equal(convert.qp_state_to_numpy(qp)[3], [2., 2.])


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_port_does_not_import_jax():
    """No module of the port nor chip_smoke.py imports jax (or a library
    built on it) or the JAX package: by the sources, and by importing every
    module of the port with jax blocked."""
    banned = {"jax", "jaxlib", "flax", "optax", "orbax",
              "rl_mpc_locomotion_tpu"}
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        hit = _imported_roots(f) & banned
        assert not hit, f"{f.relative_to(REPO)} imports {sorted(hit)}"

    mods = [".".join(f.relative_to(REPO).with_suffix("").parts)
            for f in files[:-1] if f.name != "__init__.py"]
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'rl_mpc_locomotion_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert all(sys.modules.get(n) is None for n in ('jax', 'jaxlib'))\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---- module by module ----------------------------------------------------------

def _estimator_inputs(batch, seed):
    """Random estimator state, root state and foot positions (numpy)."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(batch, 4))
    quat[:, 3] += 3.0                      # xyzw, near identity
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    body = np.concatenate([rng.normal(size=(batch, 3)), quat,
                           rng.normal(size=(batch, 6))], axis=1)
    normal = np.array([0.0, 0.0, 1.0]) + 0.1 * rng.normal(size=(batch, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    est = dict(
        contact_phase=(rng.random((batch, 4)) > 0.4) * rng.random((batch, 4)),
        foot_contact_history=rng.normal(size=(batch, 4, 3)) * 0.2
        + np.array([0, 0, -0.3]),
        ground_normal_yaw=normal, ground_normal_world=normal,
        com_z=0.3 + 0.02 * rng.normal(size=batch))
    est["contact_phase"][0] = 0.0          # a robot with no foot in contact
    feet = rng.normal(size=(batch, 4, 3)) * 0.1 + np.array(
        [[0.24, 0.13, -0.3], [0.24, -0.13, -0.3], [-0.24, 0.13, -0.3],
         [-0.24, -0.13, -0.3]])
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    return {k: f32(v) for k, v in est.items()}, f32(body), f32(feet)


def test_state_estimator_matches_jax():
    """update, update_com_height, update_flat_ground, update_ground_estimate
    (the pseudo-inverse plane fit) and init_contact_history on random
    batched inputs, 1e-5 absolute."""
    from rl_mpc_locomotion_tpu.control import state_estimator as jse
    from rl_mpc_locomotion_tpu.control.types import EstimatorState as JEst
    from rl_mpc_locomotion_tpu_torch.control import state_estimator as tse
    from rl_mpc_locomotion_tpu_torch.control.types import EstimatorState

    batch = 6
    est_np, body, feet = _estimator_inputs(batch, seed=2)
    j_est = JEst(**{k: jnp.array(v) for k, v in est_np.items()})
    t_est = EstimatorState(**{k: torch.from_numpy(v)
                              for k, v in est_np.items()})

    j_se = jax.vmap(jse.update)(j_est, jnp.array(body))
    t_se = tse.update(t_est, torch.from_numpy(body))
    for name in j_se._fields:
        np.testing.assert_allclose(getattr(t_se, name).numpy(),
                                   np.asarray(getattr(j_se, name)),
                                   atol=1e-5, err_msg=name)

    np.testing.assert_allclose(
        tse.update_com_height(t_est, t_se.ground_r_body,
                              torch.from_numpy(feet)).numpy(),
        np.asarray(jax.vmap(jse.update_com_height)(
            j_est, j_se.ground_r_body, jnp.array(feet))), atol=1e-5)
    for name in ("update_flat_ground", "update_ground_estimate"):
        want = jax.vmap(getattr(jse, name))(j_est, j_se, jnp.array(feet))
        got = getattr(tse, name)(t_est, t_se, torch.from_numpy(feet))
        for field in want._fields:
            np.testing.assert_allclose(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                atol=1e-5, err_msg=f"{name}.{field}")
    want = jax.vmap(lambda e, f: jse.init_contact_history(e, f, 0.35))(
        j_est, jnp.array(feet))
    got = tse.init_contact_history(t_est, torch.from_numpy(feet),
                                   torch.tensor(0.35))
    np.testing.assert_allclose(got.foot_contact_history.numpy(),
                               np.asarray(want.foot_contact_history), atol=0)


def test_leg_controller_matches_jax():
    """update_data and compute_torques on random commands, 1e-4 absolute
    (torques reach 1e2)."""
    from rl_mpc_locomotion_tpu.control import leg_controller as jlc
    from rl_mpc_locomotion_tpu.control.types import LegCommands as JCmd
    from rl_mpc_locomotion_tpu_torch.control import leg_controller as tlc
    from rl_mpc_locomotion_tpu_torch.control.types import LegCommands

    rng = np.random.default_rng(3)
    batch = 5
    q = rng.uniform(-1.5, 1.5, (batch, 12)).astype(np.float32)
    qd = rng.normal(size=(batch, 12)).astype(np.float32)
    jp, tp = jrobots.go1_params(), robots.go1_params("cpu")
    j_data = jax.vmap(lambda a, b: jlc.update_data(jp, a, b))(
        jnp.array(q), jnp.array(qd))
    t_data = tlc.update_data(tp, torch.from_numpy(q), torch.from_numpy(qd))
    for name in j_data._fields:
        np.testing.assert_allclose(getattr(t_data, name).numpy(),
                                   np.asarray(getattr(j_data, name)),
                                   atol=1e-5, err_msg=name)
    shapes = {f: (batch, 4, 3, 3) if f.startswith(("kp", "kd"))
              else (batch, 4, 3) for f in JCmd._fields}
    cmd_np = {f: (rng.normal(size=s) * 10).astype(np.float32)
              for f, s in shapes.items()}
    want = jax.vmap(jlc.compute_torques)(
        JCmd(**{k: jnp.array(v) for k, v in cmd_np.items()}), j_data)
    got = tlc.compute_torques(
        LegCommands(**{k: torch.from_numpy(v) for k, v in cmd_np.items()}),
        t_data)
    assert got.shape == (batch, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_min_step_nonflat_ground_matches_oracle():
    """flat_ground=False: the contact-history plane fit and the slope-aware
    gravity column, 12 ticks against the float64 oracle at 5e-4 of
    max(1,|tau|), and the fitted normal at 1e-4 — as
    tests/test_control_step.py::test_min_mode_nonflat_ground_normal."""
    n_ticks = 12
    commands = np.array([0.4, 0.0, 0.0], np.float32)
    traj = synthetic_trajectory(n_ticks, seed=21)
    oracle = OracleController(flat_ground=False)
    want = [oracle.run(q.astype(float), qd.astype(float), b.astype(float),
                       commands.astype(float))[None] for q, qd, b in traj]
    assert abs(oracle.ground_normal_yaw[0]) + abs(
        oracle.ground_normal_yaw[1]) > 1e-4

    params = robots.aliengo_params("cpu")
    cfg = ControlConfig(qp=QPConfig(iters=300, iters2=300, adaptive_rho=True,
                                    polish=True), flat_ground=False)
    state = runner.init_state(params, cfg, batch=1, device="cpu")
    got = []
    for q, qd, b in traj:
        state, tau, _ = runner.min_step(
            params, cfg, state, torch.from_numpy(q[None]),
            torch.from_numpy(qd[None]), torch.from_numpy(b[None]),
            torch.from_numpy(commands[None]))
        got.append(tau.numpy())
    assert_torques_close(got, want, 5e-4, "non-flat oracle")
    np.testing.assert_allclose(state.est.ground_normal_yaw[0].numpy(),
                               oracle.ground_normal_yaw, atol=1e-4)
