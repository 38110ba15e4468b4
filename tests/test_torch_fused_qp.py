"""The plain PyTorch version of the fused chain-QP kernel against the JAX
package, on the CPU at shrunken sizes.

Two references:
- the TPU kernel itself, ``fused_qp.fused_solve_chain_batch(...,
  interpret=True)``, with ``admm_kernel.N/M/NB/TR`` shrunk to 12/20/4/8 as
  tests/test_fused_qp.py does. Both follow the kernel's definitions
  (residuals at x~), so everything is compared tightly;
- ``hessian_from_chain`` + ``_solve_qp_impl`` (the XLA pipeline), which
  defines ``rho_mult`` and ``res`` differently by design: compared at the
  tolerances of tests/test_fused_qp.py::check_close.

The CUDA kernel is held against this plain version on the card by
chip_smoke.py; on the CPU the wrapper takes the plain version.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.ops import qp as jqp
from rl_mpc_locomotion_tpu.ops.pallas import admm_kernel as jadmm
from rl_mpc_locomotion_tpu.ops.pallas import fused_qp as jfused
from rl_mpc_locomotion_tpu.ops.srb_dynamics import hessian_from_chain

from rl_mpc_locomotion_tpu_torch.ops import qp as tqp
from rl_mpc_locomotion_tpu_torch.ops.cuda import admm_kernel, fused_qp

CFG = dict(alpha=1e-4, iters=30, sigma=1e-6, relax=1.6, rho_base=0.1,
           rho_eq_scale=1e3, ruiz_iters=3, deferred_rho=True)
NAMES = ("x", "z", "y", "rho_mult", "viol", "res")


@pytest.fixture
def small_sizes(monkeypatch):
    # NB=4 blocks -> N=12 vars, M=20 rows; TR=8 robots per tile
    monkeypatch.setattr(jadmm, "N", 12)
    monkeypatch.setattr(jadmm, "M", 20)
    monkeypatch.setattr(jadmm, "NB", 4)
    monkeypatch.setattr(jadmm, "TR", 8)
    return 12, 20, 4, 8


# Legs in stance at each horizon step of a gait, as the contact table has
# them (4 legs a step): a trot (offsets 0, 5, 5, 0, durations 5 of 10) has
# two, so n_s = 60 of 120 variables.
GAITS = {"trot": ((1, 0, 0, 1),) * 5 + ((0, 1, 1, 0),) * 5,
         "stance": ((1, 1, 1, 1),) * 10,
         "three": ((1, 1, 1, 0),) * 10}


def stance_vars(mask):
    """n_s of each robot: 3 x its foot-steps with a mask entry not 0."""
    return 3 * (mask.reshape(mask.shape[0], -1, 3) != 0).any(-1).sum(-1)


def chain_problem(b, h, sd, nb, seed=0, warm=False, swing=(), bound_scale=1.0,
                  gaits=()):
    """Random GRF-shaped chain QP batch (numpy), as
    tests/test_fused_qp.py::_chain_problem plus an optional warm start;
    ``swing`` lists cone blocks put in swing (mask 0, bounds 0) in every
    robot, ``bound_scale`` narrows the bounds and ``gaits`` (names of
    GAITS, robot i taking gaits[i % len]) replaces the random contact
    pattern by a gait's (h = 10, nb = 40), none drawing more numbers."""
    n = nb * 3
    ad = n // h
    m = nb * 5
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(b, h, sd, ad)) * 0.4).astype(np.float32)
    w = (np.abs(rng.normal(size=(b, sd))) + 0.2).astype(np.float32)
    c = rng.normal(size=(b, nb, 5, 3)).astype(np.float32)
    active = (rng.random((b, nb)) > 0.3).astype(np.float32)
    active[:, 0] = 1.0
    active[:, list(swing)] = 0.0
    for i in range(b if gaits else 0):
        active[i] = np.ravel(GAITS[gaits[i % len(gaits)]])
    mask = np.repeat(active, 3, axis=1)
    rows = np.repeat(active, 5, axis=1)
    lb = -np.abs(rng.normal(size=(b, m))).astype(np.float32) * rows
    ub = np.abs(rng.normal(size=(b, m))).astype(np.float32) * rows
    lb, ub = lb * np.float32(bound_scale), ub * np.float32(bound_scale)
    q = (rng.normal(size=(b, n)) * 2.0).astype(np.float32)
    if warm:
        x = (rng.normal(size=(b, n)) * 0.1).astype(np.float32)
        z = (rng.normal(size=(b, m)) * 0.1).astype(np.float32)
        y = (rng.normal(size=(b, m)) * 0.1).astype(np.float32)
        rm = rng.uniform(0.5, 2.0, size=(b,)).astype(np.float32)
    else:
        x = np.zeros((b, n), np.float32)
        z = np.zeros((b, m), np.float32)
        y = np.zeros((b, m), np.float32)
        rm = np.ones((b,), np.float32)
    return s, w, q, c, lb, ub, mask, x, z, y, rm


def assert_case_covers(edit, mask, lb, ub, y):
    """What a case with `edit` (chain_problem's swing / bound_scale, cold
    start) is there for: masked variables, and a dual that moved on an
    inequality row, i.e. an ADMM step that clamped at a bound."""
    if edit.get("swing"):
        assert (mask == 0).any()
    if edit.get("bound_scale", 1.0) != 1.0:
        assert (np.abs(y)[(ub - lb) > 1e-9] > 0).any()


def port(args, fn=None, **cfg):
    fn = fused_qp.fused_solve_chain_batch if fn is None else fn
    out = fn(*[torch.from_numpy(a) for a in args], **{**CFG, **cfg})
    return [o.numpy() for o in out]


def rel_err(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("b,warm,seed", [(11, False, 7), (8, True, 5)])
def test_plain_version_matches_pallas_interpret(small_sizes, b, warm, seed):
    """x/z/y within 1e-4 of max(1,|ref|); res within 1e-3 relative plus 1e-6
    absolute (its values go down to 1e-4, where float32 rounding of the
    residual vector is 1e-7); rho_mult within 3e-3 relative (it is
    sqrt(pri/dua), which carries the rounding of that small dual residual:
    1.2e-3 measured). Both sides follow the kernel's definition; the
    difference is summation order and the inverse scheme in float32."""
    args = chain_problem(b, 2, 7, 4, seed=seed, warm=warm)
    want = [np.asarray(o) for o in jfused.fused_solve_chain_batch(
        *map(jnp.array, args), **CFG, interpret=True)]
    got = port(args)
    for name, g, w in zip(NAMES[:3], got, want):
        assert g.shape == w.shape
        assert rel_err(g, w) < 1e-4, f"{name}: {rel_err(g, w):.2e}"
    np.testing.assert_allclose(got[3], want[3], rtol=3e-3, err_msg="rho_mult")
    np.testing.assert_allclose(got[4], want[4], atol=1e-5, err_msg="viol")
    np.testing.assert_allclose(got[5], want[5], rtol=1e-3, atol=1e-6,
                               err_msg="res")


def test_no_deferred_rho_matches_pallas_interpret(small_sizes):
    """deferred_rho=False passes rho_mult through unchanged on both sides."""
    args = chain_problem(8, 2, 7, 4, seed=3, warm=True)
    cfg = {**CFG, "deferred_rho": False}
    want = [np.asarray(o) for o in jfused.fused_solve_chain_batch(
        *map(jnp.array, args), **cfg, interpret=True)]
    got = port(args, deferred_rho=False)
    assert rel_err(got[0], want[0]) < 1e-4
    np.testing.assert_array_equal(got[3], args[10])
    np.testing.assert_array_equal(want[3], args[10])


def xla_reference(args):
    s, w, q, c, lb, ub, mask, x, z, y, rm = map(jnp.array, args)
    cfg = jqp.QPConfig(iters=CFG["iters"], iters2=0, adaptive_rho=False,
                       deferred_rho=True, ruiz_iters=CFG["ruiz_iters"],
                       polish=False, use_pallas=False)

    def one(s1, w1, q1, c1, l1, u1, m1, x1, z1, y1, rm1):
        p1 = hessian_from_chain(s1, w1, CFG["alpha"])
        pm = p1 * m1[:, None] * m1[None, :] + jnp.diag(1.0 - m1)
        x_u, st, diag = jqp._solve_qp_impl(
            pm, q1 * m1, c1, l1, u1, jqp.QPState(x1, z1, y1, rm1), cfg)
        return (x_u, st.z, st.y, st.rho_mult, diag["primal_violation"],
                jnp.stack([diag["pri_res"], diag["dua_res"]]))
    return [np.asarray(o) for o in jax.vmap(one)(
        s, w, q, c, lb, ub, mask, x, z, y, rm)]


@pytest.mark.parametrize("b,warm,seed", [(11, False, 7), (8, True, 9)])
def test_plain_version_matches_xla_pipeline(b, warm, seed):
    """Against hessian_from_chain + _solve_qp_impl at the tolerances of
    tests/test_fused_qp.py::check_close (x 2e-3, z/y 1e-2 of max(1,|ref|),
    viol 1e-2 absolute); rho_mult and res only to their contract, since the
    two definitions differ: finite, positive, inside the clips, ratio in
    (0.05, 20), res non-negative and below max(50 * ref, 1)."""
    args = chain_problem(b, 2, 7, 4, seed=seed, warm=warm)
    want = xla_reference(args)
    got = port(args)
    for name, g, w, tol in zip(NAMES[:3], got, want, (2e-3, 1e-2, 1e-2)):
        assert rel_err(g, w) < tol, f"{name}: {rel_err(g, w):.2e}"
    np.testing.assert_allclose(got[4], want[4], atol=1e-2)
    rm_g, rm_w = got[3], want[3]
    assert np.all(np.isfinite(rm_g)) and np.all(rm_g > 0)
    assert np.all(rm_g >= 1e-3) and np.all(rm_g <= 1e3)
    ratio = rm_g / rm_w
    assert np.all(ratio > 0.05) and np.all(ratio < 20.0)
    res = got[5]
    assert res.shape == (b, 2) and np.all(np.isfinite(res))
    assert np.all(res >= 0)
    assert np.all(res < np.maximum(want[5] * 50.0, 1.0))


def test_plain_version_matches_port_pipeline():
    """Like with like inside the port: the kernel's plain version against the
    port's own hessian_from_chain + _solve_qp_impl, x 2e-3 / z,y 1e-2."""
    args = chain_problem(6, 2, 7, 4, seed=21, warm=True)
    s, w, q, c, lb, ub, mask, x, z, y, rm = [torch.from_numpy(a)
                                             for a in args]
    cfg = tqp.QPConfig(iters=CFG["iters"], iters2=0, adaptive_rho=False,
                       deferred_rho=True, ruiz_iters=CFG["ruiz_iters"],
                       polish=False, use_kernel=False)
    x_u, st, diag = tqp.solve_qp_chain(
        s, q, w, CFG["alpha"], c, lb, ub, tqp.QPState(x, z, y, rm), cfg,
        mask=mask, horizon=2)
    got = port(args)
    assert rel_err(got[0], x_u.numpy()) < 2e-3
    assert rel_err(got[1], st.z.numpy()) < 1e-2
    assert rel_err(got[2], st.y.numpy()) < 1e-2
    # and solve_qp_chain with use_kernel=True takes the fused path
    x_k, st_k, diag_k = tqp.solve_qp_chain(
        s, q, w, CFG["alpha"], c, lb, ub, tqp.QPState(x, z, y, rm),
        cfg._replace(use_kernel=True), mask=mask, horizon=2)
    np.testing.assert_array_equal(x_k.numpy(), got[0])
    np.testing.assert_array_equal(st_k.rho_mult.numpy(), got[3])
    np.testing.assert_array_equal(diag_k["dua_res"].numpy(), got[5][:, 1])


def test_full_size_shapes_and_swing_pinning():
    """n=120, m=200, 40 blocks, h=10, state 13 at B=3: shapes, finiteness,
    and masked (swing) variables pinned to zero, 1e-4 absolute."""
    args = chain_problem(3, 10, 13, 40, seed=2)
    out = port(args, iters=24, ruiz_iters=2, alpha=1e-5)
    shapes = [(3, 120), (3, 200), (3, 200), (3,), (3,), (3, 2)]
    assert [o.shape for o in out] == shapes
    assert all(np.isfinite(o).all() for o in out)
    assert np.abs(out[0][args[6] == 0.0]).max() < 1e-4


def test_spd_inverse_and_admm_math_match_jax():
    """The two shared building blocks: K^-1 applied to a vector within 5e-4
    absolute of a float64 solve (the contract of
    tests/test_pallas_kernel.py::test_kinv_solve_accuracy), and the ADMM
    loop against the JAX _admm_math on the same K^-1, 1e-4 relative."""
    rng = np.random.default_rng(0)
    b, n, m, nb = 5, 12, 20, 4
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    k = np.einsum('bij,bkj->bik', a, a) + 0.5 * np.eye(n, dtype=np.float32)
    rhs = rng.normal(size=(b, n)).astype(np.float32)
    k_inv = admm_kernel.spd_inverse(torch.from_numpy(k))
    got = torch.einsum('bij,bj->bi', k_inv, torch.from_numpy(rhs)).numpy()
    want = np.linalg.solve(k.astype(np.float64), rhs.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(got, want, atol=5e-4)

    c = rng.normal(size=(b, nb, 5, 3)).astype(np.float32)
    q = rng.normal(size=(b, n)).astype(np.float32)
    lo = -np.abs(rng.normal(size=(b, m))).astype(np.float32)
    hi = np.abs(rng.normal(size=(b, m))).astype(np.float32)
    rho = rng.uniform(0.05, 0.5, size=(b, m)).astype(np.float32)
    x0 = np.zeros((b, n), np.float32)
    z0 = np.zeros((b, m), np.float32)
    kinv_np = k_inv.numpy()

    tx, tz, ty = admm_kernel._admm_math(
        10, 1e-6, 1.6,
        lambda r: torch.einsum('bij,bj->bi', k_inv, r),
        *[torch.from_numpy(v) for v in (c, q, lo, hi, rho, x0, z0, z0)])

    # the JAX loop is feature-major (robots last)
    def soa(v):
        return jnp.moveaxis(jnp.array(v), 0, -1)
    saved = (jadmm.N, jadmm.M, jadmm.NB)
    jadmm.N, jadmm.M, jadmm.NB = n, m, nb
    try:
        jx, jz, jy = jadmm._admm_math(
            10, 1e-6, 1.6,
            lambda r: jnp.einsum('bij,jb->ib', jnp.array(kinv_np), r),
            soa(c), soa(q), soa(lo), soa(hi), soa(rho), soa(x0), soa(z0),
            soa(z0))
    finally:
        jadmm.N, jadmm.M, jadmm.NB = saved
    for g, w in ((tx, jx), (tz, jz), (ty, jy)):
        assert rel_err(g.numpy(), np.asarray(w).T) < 1e-4


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = [torch.from_numpy(a) for a in chain_problem(2, 2, 7, 4)]
    with pytest.raises(TypeError):
        fused_qp.fused_solve_chain_batch(
            args[0].double(), *args[1:], **CFG)
    with pytest.raises(ValueError):
        fused_qp.fused_solve_chain_batch(
            args[0], args[1], args[2][:, :-1], *args[3:], **CFG)
    with pytest.raises(ValueError):
        fused_qp.fused_solve_chain_batch(
            args[0].transpose(2, 3).contiguous().transpose(2, 3), *args[1:],
            **CFG)
    before = fused_qp.launch_count()
    fused_qp.fused_solve_chain_batch(*args, **CFG)
    assert fused_qp.launch_count() == before   # CPU tensors launch nothing


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Needs an NVIDIA GPU and nvcc: the CUDA kernel against its plain
    version at the small and the full size (x 1e-3, z/y 1e-2 of
    max(1,|ref|)), and at the full size with the gaits mixed in one launch
    (trot: the compact path; all legs and three legs down: the dense one),
    each launch counting on the card the robots with n_s <= 64. Run with
    `python -m pytest tests/test_torch_*.py -m gpu` on a machine with a
    card; chip_smoke.py makes the same comparison."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    full = dict(iters=24, ruiz_iters=2, alpha=1e-5)
    for (b, h, sd, nb, cfg, gaits) in [
            (11, 2, 7, 4, {}, ()), (257, 10, 13, 40, full, ()),
            (257, 10, 13, 40, full, ("trot", "stance", "three", "trot"))]:
        problem = chain_problem(b, h, sd, nb, seed=1, warm=True, gaits=gaits)
        args = [torch.from_numpy(a).cuda() for a in problem]
        before = fused_qp.launch_count()
        fused_qp.reset_compact_count()
        got = fused_qp.fused_solve_chain_batch(*args, **{**CFG, **cfg})
        torch.cuda.synchronize()
        assert fused_qp.launch_count() == before + 1
        assert (fused_qp.compact_count()
                == int((stance_vars(problem[6]) <= 64).sum()))
        want = fused_qp.fused_solve_chain_batch_reference(
            *args, **{**CFG, **cfg})
        for g, w, tol in zip(got[:3], want[:3], (1e-3, 1e-2, 1e-2)):
            assert rel_err(g.cpu().numpy(), w.cpu().numpy()) < tol


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """The CUDA source compiled as C++ for the host (tests/host_emulation):
    threads and a barrier stand in for the block. Needs g++ with C++20."""
    from host_emulation import library
    lib = library.build(tmp_path_factory.mktemp("emu"))
    if lib is None:
        pytest.skip("no g++ to build the host emulation of the kernel")
    return lib


@pytest.mark.parametrize("b,h,sd,nb,warm,cfg", [
    (5, 2, 7, 4, False, {}),
    (5, 2, 7, 4, True, {}),
    (2, 10, 13, 40, True, dict(iters=24, ruiz_iters=2, alpha=1e-5)),
    (1, 10, 13, 40, False, dict(iters=24, ruiz_iters=2, alpha=1e-5)),
    # n = 24 (the tile's second row slot half full), blocks 1 and 6 in
    # swing, bounds a tenth as wide from a cold start: steps that clamp
    (2, 2, 7, 8, False, dict(iters=12, swing=(1, 6), bound_scale=0.1)),
    # n = 21: three panels of the inverse, the last of five pivots
    (2, 3, 7, 7, False, dict(iters=12)),
    # n = 120 with P in shared memory beside the inverse's scratch, swing
    # blocks and narrow bounds from a cold start
    (1, 10, 13, 40, False, dict(iters=24, ruiz_iters=2, alpha=1e-5,
                                swing=(3, 17), bound_scale=0.1)),
    # the gaits at n = 120: a trot (n_s = 60, the compact path), all legs
    # in stance (n_s = 120) and three (n_s = 90), both dense, and a batch
    # that mixes the two paths in one launch
    (2, 10, 13, 40, True, dict(iters=24, ruiz_iters=2, alpha=1e-5,
                               gaits=("trot",))),
    (1, 10, 13, 40, True, dict(iters=24, ruiz_iters=2, alpha=1e-5,
                               gaits=("stance",))),
    (1, 10, 13, 40, False, dict(iters=24, ruiz_iters=2, alpha=1e-5,
                                gaits=("three",))),
    (3, 10, 13, 40, True, dict(iters=24, ruiz_iters=2, alpha=1e-5,
                               gaits=("stance", "trot", "three"))),
])
def test_cuda_source_on_the_host_matches_plain_version(emulated_kernel, b, h,
                                                       sd, nb, warm, cfg):
    """The kernel's own source, run thread for thread on the host, against
    the plain version: the limits chip_smoke.py holds the kernel to on the
    card (x 1e-3, z/y 1e-2 of max(1,|ref|), rho_mult ratio 1 +- 5e-2, viol
    and res 1e-2 absolute). Shared memory starts as NaN, so reading what no
    thread wrote fails the comparison. The robots with n_s <= 64 (every
    robot where n <= 64) take the compact path, and the kernel counts
    them."""
    cfg = dict(cfg)
    edit = {k: cfg.pop(k) for k in ("swing", "bound_scale", "gaits")
            if k in cfg}
    kw = {**CFG, **cfg}
    args = chain_problem(b, h, sd, nb, seed=7, warm=warm, **edit)
    n, m = nb * 3, nb * 5
    outs = [np.full(s, np.nan, np.float32)
            for s in ((b, n), (b, m), (b, m), (b,), (b,), (b, 2))]
    emulated_kernel.rlmpc_emulate_reset_compact_solves()
    rc = emulated_kernel.rlmpc_emulate_fused_solve_chain(
        *[a.ctypes.data for a in args], *[o.ctypes.data for o in outs],
        b, n, m, nb, h, sd, kw["iters"], kw["ruiz_iters"],
        int(kw["deferred_rho"]), kw["alpha"], kw["sigma"], kw["relax"],
        kw["rho_base"], kw["rho_eq_scale"])
    assert rc == 0
    assert (emulated_kernel.rlmpc_emulate_compact_solves()
            == int((stance_vars(args[6]) <= 64).sum()))
    if edit.get("gaits"):
        assert set(stance_vars(args[6])) == {
            3 * sum(map(sum, GAITS[g])) for g in edit["gaits"]}
    want = port(args, fn=fused_qp.fused_solve_chain_batch_reference, **cfg)
    for name, g, w, tol in zip(NAMES[:3], outs, want, (1e-3, 1e-2, 1e-2)):
        assert np.isfinite(g).all(), name
        assert rel_err(g, w) < tol, f"{name}: {rel_err(g, w):.2e}"
    np.testing.assert_allclose(outs[3] / want[3], 1.0, atol=5e-2)
    np.testing.assert_allclose(outs[4], want[4], atol=1e-2)
    np.testing.assert_allclose(outs[5], want[5], atol=1e-2)
    assert_case_covers(edit, args[6], args[4], args[5], want[2])
