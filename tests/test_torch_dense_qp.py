"""The port's dense QP path against the JAX package, on the CPU: the dense
condensation of ``ops/srb_dynamics``, the prebuilt-Hessian solve
(``fused_qp.fused_solve_batch``, kernel row 2) and the scaled solve
(``admm_kernel.solve_scaled_batch``, kernel row 3), and the QP entry points
and the control tick that reach them with ``use_kernel=True``.

The JAX kernels run in interpret mode with ``admm_kernel.N/M/NB/TR`` shrunk
to 12/20/4/8, as tests/test_fused_qp.py and tests/test_pallas_kernel.py do;
the port's wrappers take their plain versions on CPU tensors. The CUDA
sources of rows 2 and 3 also run on the host through tests/host_emulation
against those plain versions. Inputs are numpy arrays made from a seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.control import runner as jrunner
from rl_mpc_locomotion_tpu.control.types import ControlConfig as JControlConfig
from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.ops import qp as jqp
from rl_mpc_locomotion_tpu.ops import srb_dynamics as jsrb
from rl_mpc_locomotion_tpu.ops.pallas import admm_kernel as jadmm
from rl_mpc_locomotion_tpu.ops.pallas import fused_qp as jfused

from rl_mpc_locomotion_tpu_torch.control import runner
from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.ops import qp as tqp
from rl_mpc_locomotion_tpu_torch.ops import srb_dynamics as tsrb
from rl_mpc_locomotion_tpu_torch.ops.cuda import admm_kernel, fused_qp

from test_qp import build_grf_qp
from test_torch_control_step import batched_trajectory
from test_torch_fused_qp import assert_case_covers, chain_problem

SOLVE = dict(iters=30, sigma=1e-6, relax=1.6, rho_base=0.1, rho_eq_scale=1e3,
             ruiz_iters=3, deferred_rho=True)
SCALED = dict(iters=30, sigma=1e-6, relax=1.6)


def T(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.fixture
def small_sizes(monkeypatch):
    # NB=4 blocks -> N=12 vars, M=20 rows; TR=8 robots per tile
    monkeypatch.setattr(jadmm, "N", 12)
    monkeypatch.setattr(jadmm, "M", 20)
    monkeypatch.setattr(jadmm, "NB", 4)
    monkeypatch.setattr(jadmm, "TR", 8)
    return 12, 20, 4, 8


def dense_problem(b, h, sd, nb, seed, warm, alpha=1e-4, **edit):
    """The chain problem of tests/test_torch_fused_qp.py (``edit``: its
    swing / bound_scale) with its raw Hessian built (numpy):
    (P, q, c, lb, ub, mask, x, z, y, rho_mult)."""
    s, w, *rest = chain_problem(b, h, sd, nb, seed=seed, warm=warm, **edit)
    p = tsrb.hessian_from_chain(T(s), T(w), alpha).numpy()
    return [p] + rest


def scaled_problem(b, n, m, nb, seed, warm):
    """A scaled problem as tests/test_pallas_kernel.py::make_problem, with
    per-row rho (some rows boosted as equality rows are), K assembled as the
    pipeline does (P + sigma I + C^T diag(rho) C, P = A A^T + 0.5 I) and an
    optional warm start."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    q = rng.normal(size=(b, n)).astype(np.float32)
    c = rng.normal(size=(b, nb, 5, 3)).astype(np.float32)
    lb = -np.abs(rng.normal(size=(b, m))).astype(np.float32)
    ub = np.abs(rng.normal(size=(b, m))).astype(np.float32)
    rho = np.where(rng.random((b, m)) < 0.2, 30.0, 0.3).astype(np.float32)
    p = np.einsum('bij,bkj->bik', a, a) + (0.5 + SCALED["sigma"]) * np.eye(
        n, dtype=np.float32)
    k = tqp._add_block_diag(T(p), tqp._ct_diag_c(T(c), T(rho))).numpy()
    if warm:
        x = (rng.normal(size=(b, n)) * 0.1).astype(np.float32)
        z = (rng.normal(size=(b, m)) * 0.1).astype(np.float32)
        y = (rng.normal(size=(b, m)) * 0.1).astype(np.float32)
    else:
        x, z, y = (np.zeros((b, d), np.float32) for d in (n, m, m))
    return k, q, c, lb, ub, rho, x, z, y


# ---- ops/srb_dynamics, the dense condensation -------------------------------

def _ab(b, seed):
    """Discretised (A, B) of random robots, from the JAX package (numpy)."""
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-0.2, 0.2, (b, 3)).astype(np.float32)
    feet = rng.uniform(-0.3, 0.3, (b, 4, 3)).astype(np.float32)
    inv_i = np.diag([30.0, 6.2, 5.7]).astype(np.float32)

    def one(r, f):
        a = jsrb.build_a_mat(r, jnp.array([0.0, 0.0, 1.0]))
        bb = jsrb.build_b_mat(1.0 / 18.0, jnp.array(inv_i), f)
        return jsrb.discretize_exact(a, bb, 0.02)
    a_exp, b_exp = jax.vmap(one)(jnp.array(rpy), jnp.array(feet))
    x0 = rng.normal(size=(b, 13)).astype(np.float32)
    x_des = rng.normal(size=(b, 130)).astype(np.float32)
    w = (np.abs(rng.normal(size=13)) + 0.1).astype(np.float32)
    return np.asarray(a_exp), np.asarray(b_exp), x0, x_des, w


@pytest.mark.parametrize("compat", [True, False])
def test_dense_condensation_matches_jax(compat):
    """condense, condense_blocks, build_qp_cost, build_qp_cost_blocks and
    condense_cost (B = 3, h = 10, state 13) against the JAX functions under
    vmap: 1e-5 of max(1, |ref|) for the condensation, 1e-4 for P and q
    (sums of ~130 float32 products)."""
    a_exp, b_exp, x0, x_des, w = _ab(3, seed=1 + compat)
    # the references are jitted: one XLA compile each instead of one a
    # primitive
    j = jax.jit(jax.vmap(lambda a, b: jsrb.condense(a, b, 10, compat)))(
        a_exp, b_exp)
    t = tsrb.condense(T(a_exp), T(b_exp), 10, compat)
    for g, want in zip(t, j):
        assert rel_err(g, want) < 1e-5
    jb = jax.jit(jax.vmap(lambda a, b: jsrb.condense_blocks(
        a, b, 10, compat)))(a_exp, b_exp)
    tb = tsrb.condense_blocks(T(a_exp), T(b_exp), 10, compat)
    for g, want in zip(tb, jb):
        assert rel_err(g, want) < 1e-5
    jw = jnp.array(w)
    costs = {
        "build_qp_cost": (
            jax.jit(jax.vmap(lambda aq, bq, x, xd: jsrb.build_qp_cost(
                aq, bq, x, xd, jw, 1e-5)))(*j, x0, x_des),
            tsrb.build_qp_cost(t[0], t[1], T(x0), T(x_des), T(w), 1e-5)),
        "build_qp_cost_blocks": (
            jax.jit(jax.vmap(lambda aq, bl, x, xd: jsrb.build_qp_cost_blocks(
                aq, bl, x, xd, jw, 1e-5)))(*jb, x0, x_des),
            tsrb.build_qp_cost_blocks(tb[0], tb[1], T(x0), T(x_des), T(w),
                                      1e-5)),
        "condense_cost": (
            jax.jit(jax.vmap(lambda a, b, x, xd: jsrb.condense_cost(
                a, b, x, xd, jw, 1e-5, 10, compat)))(a_exp, b_exp, x0, x_des),
            tsrb.condense_cost(T(a_exp), T(b_exp), T(x0), T(x_des), T(w),
                               1e-5, 10, compat)),
    }
    for name, (want, got) in costs.items():
        for g, wv in zip(got, want):
            assert rel_err(g, wv) < 1e-4, name


def test_apply_constraint_matches_jax():
    """C x and C^T y without C, per-robot mu, exact to float32 rounding."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 120)).astype(np.float32)
    y = rng.normal(size=(4, 200)).astype(np.float32)
    mu = np.array([0.4, 0.5, 0.6, 0.7], np.float32)
    jc = jax.vmap(jsrb.apply_constraint)(jnp.array(x), jnp.array(mu))
    jt = jax.vmap(jsrb.apply_constraint_t)(jnp.array(y), jnp.array(mu))
    assert rel_err(tsrb.apply_constraint(T(x), T(mu)), jc) < 1e-6
    assert rel_err(tsrb.apply_constraint_t(T(y), T(mu)), jt) < 1e-6
    assert rel_err(tsrb.apply_constraint(T(x), 0.4),
                   jax.vmap(lambda v: jsrb.apply_constraint(v, 0.4))(
                       jnp.array(x))) < 1e-6


# ---- kernel row 2: the prebuilt-Hessian solve ---------------------------------

@pytest.mark.parametrize("b,warm,seed", [(11, False, 7), (11, True, 5)])
def test_fused_solve_plain_matches_pallas_interpret(small_sizes, b, warm,
                                                     seed):
    """fused_solve_batch's plain version against the TPU kernel
    (fused_solve_batch, interpret=True) on the same raw P: x within 1e-3,
    z and y within 1e-2 of max(1, |ref|); viol 1e-4 absolute. Both take the
    residuals at x~; the relative residuals carry float32 rounding of about
    5e-6 absolute (measured 3.9e-6), so res is held to 1e-2 relative plus
    1e-5 absolute, and rho_mult, the square root of their ratio, to 1e-2
    relative where both residuals are above 1e-3 and to a ratio in
    [0.8, 1.25] where a robot has converged below that."""
    args = dense_problem(b, 2, 7, 4, seed=seed, warm=warm)
    want = [np.asarray(o) for o in jfused.fused_solve_batch(
        *map(jnp.array, args), **SOLVE, interpret=True)]
    got = [o.numpy() for o in fused_qp.fused_solve_batch(*map(T, args),
                                                         **SOLVE)]
    for name, g, w, tol in zip("xzy", got, want, (1e-3, 1e-2, 1e-2)):
        assert rel_err(g, w) < tol, f"{name}: {rel_err(g, w):.2e}"
    np.testing.assert_allclose(got[4], want[4], atol=1e-4, err_msg="viol")
    np.testing.assert_allclose(got[5], want[5], rtol=1e-2, atol=1e-5,
                               err_msg="res")
    above = (want[5] > 1e-3).all(axis=1)
    np.testing.assert_allclose(got[3][above], want[3][above], rtol=1e-2,
                               err_msg="rho_mult")
    ratio = got[3] / want[3]
    assert np.all((ratio > 0.8) & (ratio < 1.25)), ratio


def test_fused_solve_plain_matches_chain_plain():
    """Rows 1 and 2 share one plain body: the prebuilt-P solve on
    P = hessian_from_chain(s) against the chain solve on s, 1e-5 of
    max(1, |ref|) (the two P builds sum in another order)."""
    s, w, *rest = chain_problem(6, 2, 7, 4, seed=11, warm=True)
    chain = fused_qp.fused_solve_chain_batch(T(s), T(w), *map(T, rest),
                                             alpha=1e-4, **SOLVE)
    dense = fused_qp.fused_solve_batch(
        *map(T, dense_problem(6, 2, 7, 4, seed=11, warm=True)), **SOLVE)
    for g, want in zip(dense, chain):
        assert rel_err(g, want) < 1e-5


# ---- kernel row 3: the scaled solve ---------------------------------------------

@pytest.mark.parametrize("b,warm,iters", [(10, False, 30), (10, True, 30)])
def test_scaled_solve_plain_matches_pallas_interpret(small_sizes, b, warm,
                                                     iters):
    """solve_scaled_batch's plain version against the TPU kernel
    (solve_scaled_batch, interpret=True): x within 1e-3, z and y within 1e-2
    of max(1, |ref|), as tests/test_pallas_kernel.py holds the TPU kernel to
    the XLA path; per-row rho."""
    n, m, nb, _ = small_sizes
    args = scaled_problem(b, n, m, nb, seed=2 + warm, warm=warm)
    kw = dict(SCALED, iters=iters)
    want = jadmm.solve_scaled_batch(*map(jnp.array, args), **kw,
                                    interpret=True)
    got = admm_kernel.solve_scaled_batch(*map(T, args), **kw)
    for name, g, w, tol in zip("xzy", got, want, (1e-3, 1e-2, 1e-2)):
        assert rel_err(g, w) < tol, f"{name}: {rel_err(g, w):.2e}"


def test_scaled_solve_zero_iterations_returns_warm_start():
    """iters = 0 (the profiler's iter0 mode) hands x, z, y back unchanged."""
    args = [T(a) for a in scaled_problem(3, 12, 20, 4, seed=4, warm=True)]
    got = admm_kernel.solve_scaled_batch(*args, iters=0, sigma=1e-6,
                                         relax=1.6)
    for g, want in zip(got, args[6:]):
        torch.testing.assert_close(g, want, rtol=0, atol=0)


# ---- the entry points that reach them --------------------------------------------

def grf_batch(seeds):
    probs = [build_grf_qp(s) for s in seeds]
    return [np.stack([p[i] for p in probs]) for i in range(6)]


def _jax_impl(cfg, p, q, c, lb, ub, x, z, y, rm):
    def one(*a):
        x_u, st, diag = jqp._solve_qp_impl(*a[:5], jqp.QPState(*a[5:]), cfg)
        return x_u, st.z, st.y, st.rho_mult
    return jax.jit(jax.vmap(one))(*map(jnp.array,
                                       (p, q, c, lb, ub, x, z, y, rm)))


def test_solve_qp_kernel_entries_match_jax_at_full_width():
    """n = 120, m = 200, two Aliengo-shaped QPs, JAX under jit(vmap). (1)
    solve_qp with the
    fused-eligible production config (the row-2 entry) against the JAX XLA
    pipeline (use_pallas=False) on the same raw P and mask, cold: x, z, y
    within 2e-3 of max(1, |ref|) (tests/test_torch_fused_qp.py's limit
    between the kernel's definitions and the pipeline's). (2)
    _solve_qp_impl with use_kernel=True, the accurate config (the row-3
    entry, twice a solve), against the JAX pipeline with use_pallas=False:
    1e-4, the two differ only in how K^-1 is formed."""
    p, q, c, lb, ub, mask = grf_batch([0, 7])
    st0 = tqp.init_qp_state(120, 200, batch=2, device="cpu")
    prod = tqp.production_qp_config()
    x_k, st_k, _ = tqp.solve_qp(T(p), T(q), T(c), T(lb), T(ub), st0, prod,
                                mask=T(mask))
    jprod = jqp.production_qp_config()._replace(use_pallas=False)
    want = jax.jit(jax.vmap(lambda *a: jqp.solve_qp(
        *a[:5], jqp.init_qp_state(120, 200), jprod, mask=a[5])))(
        *map(jnp.array, (p, q, c, lb, ub, mask)))
    assert rel_err(x_k, want[0]) < 2e-3
    assert rel_err(st_k.z, want[1].z) < 2e-3
    assert rel_err(st_k.y, want[1].y) < 2e-3

    pm, qm, _ = tqp.mask_swing_variables(
        T(p), T(q), T(mask[:, ::3].reshape(2, 10, 4)))
    zeros = [np.zeros(s, np.float32) for s in ((2, 120), (2, 200), (2, 200))]
    args = (pm.numpy(), qm.numpy(), c, lb, ub, *zeros,
            np.ones(2, np.float32))
    want = _jax_impl(jqp.QPConfig(use_pallas=False), *args)
    got = tqp._solve_qp_impl(*map(T, args[:5]),
                             tqp.QPState(*map(T, args[5:])),
                             tqp.QPConfig(use_kernel=True))
    assert rel_err(got[0], want[0]) < 1e-4
    assert rel_err(got[1].z, want[1]) < 1e-4
    assert rel_err(got[1].y, want[2]) < 1e-4


def test_min_step_accurate_config_matches_jax():
    """4 ticks of the control tick, batch 2, under QPConfig(use_kernel=True)
    (adaptive rho restart and polish, the scaled solve through
    solve_scaled_batch twice a solve) against un-jitted
    jax.vmap(runner.min_step) with use_pallas=False: torques within 5e-4 of
    max(1, |tau|), the tolerance tests/test_torch_control_step.py holds the
    production tick to."""
    n_ticks, batch = 4, 2
    traj = batched_trajectory(n_ticks, batch, seed=9)
    commands = np.tile(np.array([0.4, 0.1, 0.2], np.float32), (batch, 1))
    jparams = jrobots.aliengo_params()
    jcfg = JControlConfig(qp=jqp.QPConfig(use_pallas=False))
    jstate = jax.vmap(lambda _: jrunner.init_state(jparams, jcfg))(
        jnp.arange(batch))
    params = robots.aliengo_params("cpu")
    cfg = ControlConfig(qp=tqp.QPConfig(use_kernel=True))
    state = runner.init_state(params, cfg, batch=batch, device="cpu")
    calls = admm_kernel.solve_scaled_batch
    count = [0]

    def counted(*a, **k):
        count[0] += 1
        return calls(*a, **k)
    admm_kernel.solve_scaled_batch = counted
    try:
        for t, (q, qd, body) in enumerate(traj):
            gate = t % 2 == 1
            jstate, jtau, _ = jax.vmap(
                lambda s, q1, qd1, b1, c1: jrunner.min_step(
                    jparams, jcfg, s, q1, qd1, b1, c1,
                    solve_gate=jnp.bool_(gate)))(
                jstate, jnp.array(q), jnp.array(qd), jnp.array(body),
                jnp.array(commands))
            state, tau, _ = runner.min_step(
                params, cfg, state, T(q), T(qd), T(body), T(commands),
                solve_gate=gate)
            scale = np.maximum(1.0, np.abs(np.asarray(jtau)).max(axis=1,
                                                                 keepdims=True))
            err = (np.abs(tau.numpy() - np.asarray(jtau)) / scale).max()
            assert err < 5e-4, f"tick {t}: {err:.2e}"
    finally:
        admm_kernel.solve_scaled_batch = calls
    assert count[0] == 2 * (n_ticks // 2)   # two scaled solves a solve tick


def test_new_wrappers_reject_what_the_kernels_do_not_take():
    """Shape, dtype, contiguity and size checks of the row-2 and row-3
    wrappers; CPU tensors launch nothing."""
    p, *rest = map(T, dense_problem(2, 2, 7, 4, seed=1, warm=False))
    with pytest.raises(TypeError):
        fused_qp.fused_solve_batch(p.double(), *rest, **SOLVE)
    with pytest.raises(ValueError):
        fused_qp.fused_solve_batch(p[:, :, :-1], *rest, **SOLVE)
    with pytest.raises(ValueError):
        fused_qp.fused_solve_batch(p.transpose(1, 2), *rest, **SOLVE)
    k, *srest = map(T, scaled_problem(2, 12, 20, 4, seed=1, warm=False))
    with pytest.raises(ValueError):
        admm_kernel.solve_scaled_batch(k, *srest[:-1], srest[-1][:, :-1],
                                       **SCALED)
    with pytest.raises(ValueError):
        admm_kernel.solve_scaled_batch(k[:, :11, :11], *srest, **SCALED)
    with pytest.raises(ValueError):
        admm_kernel.solve_scaled_batch(k, *srest, iters=-1, sigma=1e-6,
                                       relax=1.6)
    before = (fused_qp.launch_count(), admm_kernel.launch_count())
    fused_qp.fused_solve_batch(p, *rest, **SOLVE)
    admm_kernel.solve_scaled_batch(k, *srest, **SCALED)
    assert (fused_qp.launch_count(), admm_kernel.launch_count()) == before


# ---- the CUDA sources, on the host and on the card --------------------------------

@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    from host_emulation import library
    lib = library.build(tmp_path_factory.mktemp("emu"))
    if lib is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    return lib


def _ptrs(arrays):
    return [a.ctypes.data for a in arrays]


@pytest.mark.parametrize("b,h,sd,nb,warm,kw", [
    (2, 2, 7, 4, True, dict(iters=10)),
    (1, 10, 13, 40, False, dict(iters=8, ruiz_iters=2)),
    # n = 24 (the tile's second row slot half full), blocks 1 and 6 in
    # swing, bounds a tenth as wide from a cold start: steps that clamp
    (2, 2, 7, 8, False, dict(iters=12, swing=(1, 6), bound_scale=0.1)),
])
def test_fused_solve_source_on_the_host_matches_plain_version(
        emulation, b, h, sd, nb, warm, kw):
    """fused_solve_kernel's source run thread for thread on the host against
    the plain version, at chip_smoke.py's limits (x 1e-3, z/y 1e-2 of
    max(1,|ref|), rho_mult ratio 1 +- 5e-2, viol and res 1e-2). Shared
    memory starts as NaN."""
    kw = {**SOLVE, **kw}
    edit = {k: kw.pop(k) for k in ("swing", "bound_scale") if k in kw}
    args = [np.ascontiguousarray(a)
            for a in dense_problem(b, h, sd, nb, seed=7, warm=warm,
                                   alpha=1e-5, **edit)]
    n, m = 3 * nb, 5 * nb
    outs = [np.full(s, np.nan, np.float32)
            for s in ((b, n), (b, m), (b, m), (b,), (b,), (b, 2))]
    rc = emulation.rlmpc_emulate_fused_solve(
        *_ptrs(args), *_ptrs(outs), b, n, m, nb, kw["iters"],
        kw["ruiz_iters"], int(kw["deferred_rho"]), kw["sigma"], kw["relax"],
        kw["rho_base"], kw["rho_eq_scale"])
    assert rc == 0
    want = [o.numpy() for o in
            fused_qp.fused_solve_batch_reference(*map(T, args), **kw)]
    for name, g, w, tol in zip("xzy", outs, want, (1e-3, 1e-2, 1e-2)):
        assert np.isfinite(g).all(), name
        assert rel_err(g, w) < tol, f"{name}: {rel_err(g, w):.2e}"
    np.testing.assert_allclose(outs[3] / want[3], 1.0, atol=5e-2)
    np.testing.assert_allclose(outs[4], want[4], atol=1e-2)
    np.testing.assert_allclose(outs[5], want[5], atol=1e-2)
    assert_case_covers(edit, args[5], args[3], args[4], want[2])


@pytest.mark.parametrize("b,n,iters,warm", [
    (2, 12, 10, True), (2, 12, 0, True), (1, 120, 8, False),
    (3, 24, 12, True), (2, 24, 30, False),
    # three panels, the last of five pivots: the inverse at an odd panel
    # count (the raw columns' two buffers) and a partial last pivot block
    (2, 21, 12, False),
    # fifteen panels from a warm start
    (1, 120, 12, True)])
def test_scaled_solve_source_on_the_host_matches_plain_version(
        emulation, b, n, iters, warm):
    """scaled_solve_kernel's source on the host against the plain version:
    x 1e-3, z/y 1e-2 of max(1,|ref|); with iters = 0 the warm start comes
    back bit for bit. The cold cases have rows that the steps clamp at a
    bound (z of the plain version equal to l or u)."""
    nb, m = n // 3, 5 * n // 3
    args = scaled_problem(b, n, m, nb, seed=5, warm=warm)
    outs = [np.full(s, np.nan, np.float32) for s in ((b, n), (b, m), (b, m))]
    rc = emulation.rlmpc_emulate_scaled_solve(
        *_ptrs(args), *_ptrs(outs), b, n, m, nb, iters, 1e-6, 1.6)
    assert rc == 0
    want = admm_kernel.solve_scaled_batch_reference(
        *map(T, args), iters=iters, sigma=1e-6, relax=1.6)
    for name, g, w, tol in zip("xzy", outs, want, (1e-3, 1e-2, 1e-2)):
        assert np.isfinite(g).all(), name
        assert rel_err(g, w.numpy()) < tol, name
    if iters == 0:
        for g, a in zip(outs, args[6:]):
            np.testing.assert_array_equal(g, a)
    if not warm:
        z = want[1].numpy()
        assert ((z == args[3]) | (z == args[4])).any()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused_solve", "scaled_solve"])
def test_new_solve_kernels_match_plain_version_on_the_card(kernel):
    """Needs an NVIDIA GPU and nvcc: rows 2 and 3 against their plain
    versions at the small and the full size (x 1e-3, z/y 1e-2 of
    max(1,|ref|)), one launch each. chip_smoke.py makes the same comparison
    at batch 4099."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    for b, h, sd, nb in [(11, 2, 7, 4), (257, 10, 13, 40)]:
        if kernel == "fused_solve":
            args = [T(a).cuda() for a in dense_problem(b, h, sd, nb, 1, True)]
            fn, ref, kw = (fused_qp.fused_solve_batch,
                           fused_qp.fused_solve_batch_reference, SOLVE)
            count = lambda: fused_qp.launch_count("fused_solve")  # noqa: E731
        else:
            args = [T(a).cuda() for a in scaled_problem(b, 3 * nb, 5 * nb, nb,
                                                        1, True)]
            fn, ref, kw = (admm_kernel.solve_scaled_batch,
                           admm_kernel.solve_scaled_batch_reference, SCALED)
            count = admm_kernel.launch_count
        before = count()
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert count() == before + 1
        want = ref(*args, **kw)
        for g, w, tol in zip(got[:3], want[:3], (1e-3, 1e-2, 1e-2)):
            assert rel_err(g.cpu(), w.cpu()) < tol
