"""The port's plain QP pipeline against the JAX package's XLA pipeline and
against a float64 scipy oracle, on the CPU.

Both packages run without their kernels here (``use_pallas=False`` /
``use_kernel=False``); the JAX functions are single-robot and go under
``jax.vmap``. Inputs are numpy arrays made from a seed. Tolerance 1e-4 of
max(1, |ref|) unless stated.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.ops import qp as jqp
from rl_mpc_locomotion_tpu.ops import srb_dynamics as jsrb

from rl_mpc_locomotion_tpu_torch.ops import qp as tqp

from test_qp import build_grf_qp, solve_oracle


def T(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def small_problem(b, n, m, nb, seed=0, warm=False):
    """Random GRF-shaped QP batch as tests/test_fused_qp.py::make_problem,
    pre-masked."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    p = np.einsum('bij,bkj->bik', a, a) + 0.5 * np.eye(n, dtype=np.float32)
    q = rng.normal(size=(b, n)).astype(np.float32) * 3.0
    c = rng.normal(size=(b, nb, 5, 3)).astype(np.float32)
    active = (rng.random((b, nb)) > 0.3).astype(np.float32)
    active[:, 0] = 1.0
    mask = np.repeat(active, 3, axis=1)
    rows = np.repeat(active, 5, axis=1)
    lb = -np.abs(rng.normal(size=(b, m))).astype(np.float32) * rows
    ub = np.abs(rng.normal(size=(b, m))).astype(np.float32) * rows
    p = p * mask[:, :, None] * mask[:, None, :] + np.eye(
        n, dtype=np.float32) * (1.0 - mask)[:, None, :]
    q = q * mask
    if warm:
        x = rng.normal(size=(b, n)).astype(np.float32) * 0.1
        z = rng.normal(size=(b, m)).astype(np.float32) * 0.1
        y = rng.normal(size=(b, m)).astype(np.float32) * 0.1
        rm = rng.uniform(0.5, 2.0, size=(b,)).astype(np.float32)
    else:
        x = np.zeros((b, n), np.float32)
        z = np.zeros((b, m), np.float32)
        y = np.zeros((b, m), np.float32)
        rm = np.ones((b,), np.float32)
    return p, q, c, lb, ub, x, z, y, rm


def grf_batch(seeds):
    probs = [build_grf_qp(s) for s in seeds]
    return [np.stack([p[i] for p in probs]) for i in range(6)]


def test_config_and_state_defaults():
    """Same fields and defaults, use_pallas renamed use_kernel."""
    jf = [f if f != "use_pallas" else "use_kernel" for f in jqp.QPConfig._fields]
    assert list(tqp.QPConfig._fields) == jf
    assert tuple(tqp.QPConfig()) == tuple(jqp.QPConfig())
    assert tuple(tqp.production_qp_config()) == tuple(
        jqp.production_qp_config())
    assert tqp.production_qp_config().use_kernel
    assert tqp._fused_eligible(tqp.production_qp_config())
    assert not tqp._fused_eligible(tqp.QPConfig(use_kernel=True))
    st = tqp.init_qp_state(120, 200, batch=3, device="cpu")
    assert st.x.shape == (3, 120) and st.y.shape == (3, 200)
    assert torch.all(st.rho_mult == 1.0) and st.rho_mult.shape == (3,)


def test_shift_warm_start():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 120)).astype(np.float32)
    z = rng.normal(size=(4, 200)).astype(np.float32)
    y = rng.normal(size=(4, 200)).astype(np.float32)
    rm = rng.uniform(0.5, 2, 4).astype(np.float32)
    want = jax.vmap(lambda *a: jqp.shift_warm_start(jqp.QPState(*a)))(
        *map(jnp.array, (x, z, y, rm)))
    got = tqp.shift_warm_start(tqp.QPState(*map(T, (x, z, y, rm))))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_block_helpers():
    rng = np.random.default_rng(1)
    c = rng.normal(size=(3, 4, 5, 3)).astype(np.float32)
    x = rng.normal(size=(3, 12)).astype(np.float32)
    y = rng.normal(size=(3, 20)).astype(np.float32)
    mat = rng.normal(size=(3, 12, 12)).astype(np.float32)
    jc, jx, jy, jm = map(jnp.array, (c, x, y, mat))
    assert rel_err(tqp._apply_c(T(c), T(x)), jax.vmap(jqp._apply_c)(jc, jx)) < 1e-6
    assert rel_err(tqp._apply_ct(T(c), T(y)), jax.vmap(jqp._apply_ct)(jc, jy)) < 1e-6
    blocks = jax.vmap(jqp._ct_diag_c)(jc, jnp.abs(jy))
    assert rel_err(tqp._ct_diag_c(T(c), T(np.abs(y))), blocks) < 1e-6
    assert rel_err(tqp._add_block_diag(T(mat), T(np.asarray(blocks))),
                   jax.vmap(jqp._add_block_diag)(jm, blocks)) < 1e-6
    k = np.einsum('bij,bkj->bik', mat, mat) + np.eye(12, dtype=np.float32)
    assert rel_err(tqp._spd_inverse(T(k)),
                   jax.vmap(jqp._spd_inverse)(jnp.array(k))) < 1e-4


@pytest.mark.parametrize("size", ["small", "grf"])
def test_ruiz_equilibrate(size):
    if size == "small":
        p, q, c = small_problem(5, 12, 20, 4, seed=3)[:3]
        iters = 3
    else:
        p, q, c = grf_batch([0, 1])[:3]
        iters = 10
    want = jax.vmap(lambda *a: jqp.ruiz_equilibrate(*a, iters))(
        *map(jnp.array, (p, q, c)))
    got = tqp.ruiz_equilibrate(T(p), T(q), T(c), iters)
    for name, g, w in zip(("p_s", "q_s", "c_s", "d", "e", "c_cost"), got, want):
        err = np.abs(g.numpy() - np.asarray(w)).max() / max(
            1e-30, np.abs(np.asarray(w)).max())
        assert err < 1e-4, f"{name}: {err:.2e} relative to its largest entry"


def _jax_solve(cfg, p, q, c, lb, ub, x, z, y, rm):
    def one(p1, q1, c1, l1, u1, x1, z1, y1, rm1):
        x_u, st, diag = jqp._solve_qp_impl(p1, q1, c1, l1, u1,
                                           jqp.QPState(x1, z1, y1, rm1), cfg)
        return x_u, st.z, st.y, st.rho_mult, diag
    return jax.vmap(one)(*map(jnp.array, (p, q, c, lb, ub, x, z, y, rm)))


CASES = {
    "deferred": dict(iters=30, iters2=0, adaptive_rho=False,
                     deferred_rho=True, ruiz_iters=3, polish=False),
    "fixed": dict(iters=25, iters2=0, adaptive_rho=False, deferred_rho=False,
                  ruiz_iters=2, polish=False),
    "adaptive": dict(iters=20, iters2=20, adaptive_rho=True, ruiz_iters=4,
                     polish=False),
    "adaptive+polish": dict(iters=40, iters2=40, adaptive_rho=True,
                            ruiz_iters=4, polish=True),
}


# polish thresholds y at 1e-4 to pick its active set; on the random
# warm-started batch one robot sits on that threshold and the two float32
# implementations choose differently (there the port agrees with its own
# float64 run to 1e-7 and JAX is 3e-3 off), so polish is compared cold.
IMPL_CASES = [(c, w) for c in sorted(CASES) for w in (False, True)
              if not (c == "adaptive+polish" and w)]


@pytest.mark.parametrize("case,warm", IMPL_CASES)
def test_solve_qp_impl_matches_jax(case, warm):
    """Every branch of _solve_qp_impl (deferred rho, fixed rho, immediate
    adaptive restart, polish) at n=12, B=6: x/z/y 1e-4 of max(1,|ref|).
    The relative residuals are differences of nearly equal float32 vectors
    (values down to 1e-6), so they carry the rounding of both sides: 5e-2
    relative plus 1e-5 absolute; rho_mult, the square root of their ratio,
    5e-2 relative (3.4e-2 measured)."""
    args = small_problem(6, 12, 20, 4, seed=5 + warm, warm=warm)
    want = _jax_solve(jqp.QPConfig(use_pallas=False, **CASES[case]), *args)
    p, q, c, lb, ub, x, z, y, rm = map(T, args)
    x_u, st, diag = tqp._solve_qp_impl(
        p, q, c, lb, ub, tqp.QPState(x, z, y, rm),
        tqp.QPConfig(use_kernel=False, **CASES[case]))
    assert rel_err(x_u, want[0]) < 1e-4
    assert rel_err(st.z, want[1]) < 1e-4
    assert rel_err(st.y, want[2]) < 1e-4
    np.testing.assert_allclose(st.rho_mult.numpy(), np.asarray(want[3]),
                               rtol=5e-2)
    for key in ("primal_violation", "pri_res", "dua_res"):
        np.testing.assert_allclose(diag[key].numpy(), np.asarray(want[4][key]),
                                   rtol=5e-2, atol=1e-5, err_msg=key)


def test_solve_qp_impl_reports_its_branches():
    """The diagnostics name the discrete branches each robot took: the rho
    rescale's clip end (-1 low, +1 high, 0 none) where a rescale ran, and
    with polish its active set (equality rows always in it) and whether the
    polished x was kept; a config with neither reports neither."""
    scale, clip = tqp._rho_rescale(torch.tensor([1.0, 1e-7, 1.0, 1e-4]),
                                   torch.tensor([1e-5, 1.0, 1.0, 1.0]))
    torch.testing.assert_close(scale, torch.tensor([1e2, 1e-2, 1.0, 1e-2]))
    assert clip.dtype == torch.int8 and clip.tolist() == [1, -1, 0, -1]
    p, q, c, lb, ub, x, z, y, rm = map(T, small_problem(6, 12, 20, 4, seed=5))
    st = tqp.QPState(x, z, y, rm)
    for case, keys in (("fixed", set()), ("deferred", {"rho_clip"}),
                       ("adaptive", {"rho_clip"}),
                       ("adaptive+polish", {"rho_clip", "polish_active",
                                            "polish_kept"})):
        _, _, diag = tqp._solve_qp_impl(p, q, c, lb, ub, st,
                                        tqp.QPConfig(**CASES[case]))
        assert set(diag) - {"primal_violation", "pri_res", "dua_res"} == keys
        if "rho_clip" in keys:
            assert diag["rho_clip"].shape == (6,)
            assert set(diag["rho_clip"].tolist()) <= {-1, 0, 1}
    assert diag["polish_active"].shape == (6, 20)
    assert bool(diag["polish_active"][(ub - lb) < 1e-9].all())
    assert diag["polish_kept"].shape == (6,)
    assert diag["polish_kept"].dtype == torch.bool


def test_solve_qp_chain_matches_jax():
    """solve_qp_chain with use_kernel=False against the JAX XLA path under
    vmap, from the chain, with a swing mask; n=12 (h=2, state 7). x, y 1e-4
    of max(1,|ref|); rho_mult 5e-2 relative (see above)."""
    rng = np.random.default_rng(8)
    b, h, sd, nb = 5, 2, 7, 4
    n, m, ad = 12, 20, 6
    s = (rng.normal(size=(b, h, sd, ad)) * 0.4).astype(np.float32)
    w = (np.abs(rng.normal(size=(b, sd))) + 0.2).astype(np.float32)
    _, q, c, lb, ub, x, z, y, rm = small_problem(b, n, m, nb, seed=8,
                                                 warm=True)
    mask = (np.abs(ub).reshape(b, nb, 5).max(-1) > 0).astype(np.float32)
    mask = np.repeat(mask, 3, axis=1)
    cfg = dict(iters=30, iters2=0, adaptive_rho=False, deferred_rho=True,
               ruiz_iters=3, polish=False)
    jcfg = jqp.QPConfig(use_pallas=False, **cfg)
    want = jax.vmap(lambda s1, q1, w1, c1, l1, u1, x1, z1, y1, r1, m1:
                    jqp.solve_qp_chain(s1, q1, w1, 1e-4, c1, l1, u1,
                                       jqp.QPState(x1, z1, y1, r1), jcfg,
                                       mask=m1, horizon=h))(
        *map(jnp.array, (s, q, w, c, lb, ub, x, z, y, rm, mask)))
    x_u, st, diag = tqp.solve_qp_chain(
        T(s), T(q), T(w), 1e-4, T(c), T(lb), T(ub),
        tqp.QPState(T(x), T(z), T(y), T(rm)),
        tqp.QPConfig(use_kernel=False, **cfg), mask=T(mask), horizon=h)
    assert rel_err(x_u, want[0]) < 1e-4
    assert rel_err(st.y, want[1].y) < 1e-4
    np.testing.assert_allclose(st.rho_mult.numpy(),
                               np.asarray(want[1].rho_mult), rtol=5e-2)
    assert float(x_u[T(mask) == 0].abs().max()) < 1e-4


def test_full_size_grf_qp_matches_jax_and_scipy():
    """Two Aliengo-shaped QPs (n=120, m=200) under the offline-accuracy
    config: within 1e-4 of the JAX solve, within 2e-4 of the float64 scipy
    oracle (tests/test_qp.py holds JAX to the same), KKT stationarity."""
    accurate = dict(iters=300, iters2=300, adaptive_rho=True, polish=True)
    p, q, c, lb, ub, mask = grf_batch([0, 7])
    st0 = tqp.init_qp_state(120, 200, batch=2, device="cpu")
    x_u, st, diag = tqp.solve_qp(T(p), T(q), T(c), T(lb), T(ub), st0,
                                 tqp.QPConfig(**accurate))
    want = jax.vmap(lambda *a: jqp.solve_qp(
        *a, jqp.init_qp_state(120, 200), jqp.QPConfig(**accurate)))(
        *map(jnp.array, (p, q, c, lb, ub)))
    assert rel_err(x_u, want[0]) < 1e-4
    g = np.asarray(jsrb.friction_cone_block(0.4))
    c_dense = np.kron(np.eye(40), g)
    for i in range(2):
        oracle = solve_oracle(p[i], q[i], c_dense, lb[i], ub[i], mask[i])
        scale = max(1.0, np.abs(oracle).max())
        assert np.abs(x_u[i].numpy() - oracle).max() / scale < 2e-4
    xi, yi = x_u[1].numpy(), st.y[1].numpy()
    grad_scale = max(np.abs(p[1] @ xi).max(), np.abs(q[1]).max())
    assert np.abs(p[1] @ xi + q[1] + c_dense.T @ yi).max() < 5e-3 * grad_scale


def test_mask_swing_variables_and_solve_qp_mask():
    p, q, c, lb, ub, _ = grf_batch([3])
    contact = np.zeros((1, 10, 4), np.float32)
    contact[:, :5, [0, 3]] = 1.0
    contact[:, 5:, [1, 2]] = 1.0
    want = jqp.mask_swing_variables(jnp.array(p[0]), jnp.array(q[0]),
                                    jnp.array(contact[0]))
    got = tqp.mask_swing_variables(T(p), T(q), T(contact))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    # solve_qp(mask=...) masks inside: same answer as pre-masked data
    cfg = tqp.QPConfig(iters=20, iters2=0, adaptive_rho=False, polish=False)
    st0 = tqp.init_qp_state(120, 200, batch=1, device="cpu")
    a, _, _ = tqp.solve_qp(T(p), T(q), T(c), T(lb), T(ub), st0, cfg,
                           mask=got[2])
    b, _, _ = tqp.solve_qp(got[0], got[1], T(c), T(lb), T(ub), st0, cfg)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_unported_kernel_entries_raise(monkeypatch):
    """The name dates from when these entries raised; it now checks the
    opposite. The two kernel branches that raised NotImplementedError before
    their kernels were ported now reach them: solve_qp with a fused-eligible
    config calls fused_qp.fused_solve_batch once, _solve_qp_impl with
    use_kernel calls admm_kernel.solve_scaled_batch once a solve (twice with
    the adaptive-rho restart). Neither raises NotImplementedError any more;
    on CPU tensors the wrappers take their plain versions, and a tensor on
    a device that is neither the CPU nor a card is refused."""
    from rl_mpc_locomotion_tpu_torch.ops.cuda import admm_kernel, fused_qp
    calls = {"fused_solve_batch": 0, "solve_scaled_batch": 0}

    def spy(module, name):
        inner = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return inner(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    spy(fused_qp, "fused_solve_batch")
    spy(admm_kernel, "solve_scaled_batch")
    p, q, c, lb, ub, x, z, y, rm = map(T, small_problem(2, 12, 20, 4))
    st = tqp.QPState(x, z, y, rm)
    x_f, st_f, diag_f = tqp.solve_qp(p, q, c, lb, ub, st,
                                     tqp.production_qp_config())
    assert calls == {"fused_solve_batch": 1, "solve_scaled_batch": 0}
    assert x_f.shape == (2, 12) and torch.isfinite(x_f).all()
    assert set(diag_f) == {"primal_violation", "pri_res", "dua_res"}
    x_k, _, _ = tqp._solve_qp_impl(p, q, c, lb, ub, st,
                                   tqp.QPConfig(use_kernel=True))
    assert calls == {"fused_solve_batch": 1, "solve_scaled_batch": 2}
    assert torch.isfinite(x_k).all()
    with pytest.raises(ValueError, match="unsupported device"):
        fused_qp.fused_solve_batch(
            p.to("meta"), *[t.to("meta") for t in (q, c, lb, ub)],
            torch.ones_like(q, device="meta"),
            *[t.to("meta") for t in (x, z, y, rm)],
            **tqp._fused_kwargs(tqp.production_qp_config()))
