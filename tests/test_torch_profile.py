"""The port's QP profiler and its phase timers against the JAX package, on
the CPU: the stages of the solve cut after each phase
(``phase_probe.stripped_solve``, kernel row 4) against compositions of the
JAX package's XLA functions, the batch-major tile load (``bm_dma``, kernel
row 5), every ported subcommand of ``python -m
rl_mpc_locomotion_tpu_torch.profile`` with ``--device cpu``, and
``utils/profiling``.

The wrappers take their plain versions on CPU tensors; the CUDA source of
rows 4 and 5 also runs on the host through tests/host_emulation. Inputs are
numpy arrays made from a seed.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.ops import qp as jqp

from rl_mpc_locomotion_tpu_torch import profile
from rl_mpc_locomotion_tpu_torch.ops.cuda import admm_kernel, fused_qp, phase_probe
from rl_mpc_locomotion_tpu_torch.utils import profiling


def phase_data(b, nb, seed=0):
    """The phase timer's data: SPD P = A A^T + 5 I (A ~ 0.1 N(0,1)),
    q ~ N(0,1), cone blocks 0.3 (numpy)."""
    n = 3 * nb
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)).astype(np.float32) * 0.1
    p = (np.einsum('bij,bkj->bik', a, a)
         + 5.0 * np.eye(n, dtype=np.float32)).astype(np.float32)
    q = rng.normal(size=(b, n)).astype(np.float32)
    c = np.full((b, nb, 5, 3), 0.3, np.float32)
    return p, q, c


@jax.jit
def jax_stages(p, q, c):
    """Every stage's output from the JAX package's XLA functions under
    vmap, with the phase timer's settings (mask all ones, 3 Ruiz passes, rho
    0.1, sigma 1e-6, relax 1.6, bounds +-1 in the scaled problem, cold
    start)."""
    def one(p1, q1, c1):
        n, nb = p1.shape[0], c1.shape[0]
        m = 5 * nb
        contact = jnp.ones((n // 12, 4), jnp.float32)
        pm, qm, _ = jqp.mask_swing_variables(p1, q1, contact,
                                             horizon=n // 12)
        p_s, q_s, c_s, _, _, _ = jqp.ruiz_equilibrate(pm, qm, c1, 3)
        rho = jnp.full((m,), 0.1, jnp.float32)
        k = jqp._add_block_diag(p_s + 1e-6 * jnp.eye(n),
                                jqp._ct_diag_c(c_s, rho))
        k_inv = jqp._spd_inverse(k)
        lo, hi = -jnp.ones(m), jnp.ones(m)
        zn, zm = jnp.zeros(n), jnp.zeros(m)
        x1 = jqp._admm_iters(k_inv, None, q_s, c_s, lo, hi, rho, 1e-6, 1.6,
                             1, zn, zm, zm)[0]
        x50 = jqp._admm_iters(k_inv, None, q_s, c_s, lo, hi, rho, 1e-6, 1.6,
                              50, zn, zm, zm)[0]
        return {"dma": q1 + p1[0], "mask": qm + pm[0],
                "ruiz": q_s + p_s[0], "kgj": q_s + k_inv[0],
                "admm1": x1, "admm50": x50, "kinv_row0": k_inv[0]}
    return jax.vmap(one)(p, q, c)


@pytest.fixture(scope="module")
def stage_refs():
    """(data, JAX stage outputs) at n = 12 (B = 3) and n = 24 (B = 2)."""
    out = {}
    for nb, b in ((4, 3), (8, 2)):
        data = phase_data(b, nb, seed=nb)
        out[nb] = (data, {k: np.asarray(v) for k, v in
                          jax_stages(*map(jnp.array, data)).items()})
    return out


# limits: dma and mask exact; ruiz 1e-5 of the stage's largest entry (rsqrt
# against 1/sqrt); kgj 1e-4 of max |K^-1| (two Cholesky inverses in float32);
# the ADMM stages 1e-4 of max(1, |x|)
@pytest.mark.parametrize("stage", phase_probe.STAGES)
def test_stage_plain_version_matches_jax_composition(stage_refs, stage):
    for nb, ((p, q, c), want) in stage_refs.items():
        got = phase_probe.stripped_solve(
            stage, *map(torch.from_numpy, (p, q, c))).numpy()
        err = np.abs(got - want[stage]).max()
        if stage in ("dma", "mask"):
            assert err == 0.0, (nb, err)
        elif stage == "ruiz":
            assert err <= 1e-5 * np.abs(want[stage]).max(), (nb, err)
        elif stage == "kgj":
            assert err <= 1e-4 * np.abs(want["kinv_row0"]).max(), (nb, err)
        else:
            assert err <= 1e-4 * max(1.0, np.abs(want[stage]).max()), (nb, err)


@pytest.mark.parametrize("transpose", [False, True])
def test_tile_load_plain_version(transpose):
    """q + P[:, :, 0], or with transpose q + P[:, 0, :n], of the padded
    tile: exact."""
    p, q, _ = phase_data(3, 4, seed=1)
    p_pad = np.pad(p, ((0, 0), (0, 0), (0, 4)))
    p_pad[:, :, 12:] = 7.0              # the padding is never read
    got = phase_probe.bm_dma(torch.from_numpy(p_pad), torch.from_numpy(q),
                             transpose).numpy()
    want = q + (p_pad[:, 0, :12] if transpose else p_pad[:, :, 0])
    np.testing.assert_array_equal(got, want)


def test_phase_wrappers_reject_what_the_kernels_do_not_take():
    p, q, c = map(torch.from_numpy, phase_data(2, 4))
    with pytest.raises(ValueError, match="stage"):
        phase_probe.stripped_solve("admm2", p, q, c)
    with pytest.raises(TypeError):
        phase_probe.stripped_solve("dma", p.double(), q, c)
    with pytest.raises(ValueError):
        phase_probe.stripped_solve("dma", p, q[:, :-1], c)
    with pytest.raises(ValueError):
        phase_probe.bm_dma(p[:, :, :-1], q)
    # the kernel takes a tile only as whole 16-byte bulk copies; the plain
    # version takes any (on the card such tiles raise: see the GPU test)
    off = torch.zeros(1 + p.numel())[1:].view(p.shape).copy_(p)
    assert off.data_ptr() % 16 == 4
    for tile in (torch.arange(18.0).view(2, 3, 3), off):
        q_t = q[:, :tile.shape[1]].contiguous()
        torch.testing.assert_close(phase_probe.bm_dma(tile, q_t),
                                   q_t + tile[:, :, 0], rtol=0, atol=0)
    before = phase_probe.launch_count()
    phase_probe.stripped_solve("admm1", p, q, c)
    phase_probe.bm_dma(p, q)
    assert phase_probe.launch_count() == before   # CPU tensors launch nothing


# ---- the profiler's subcommands ---------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["kernel", "--mode", "fresh"], ["kernel", "--mode", "static"],
    ["kernel", "--mode", "chained"], ["kernel", "--mode", "iter0"],
    ["qp-phases"], ["kernel-phases"], ["inverse"]])
def test_subcommand_on_cpu(argv, capsys):
    """Each ported subcommand with --device cpu prints one JSON line whose
    times are host-clock times under cpu_ names, finite, and positive where
    measured (a slope or an intercept of two host timings may come out
    negative); none is named like a device time."""
    profile.main(argv + ["--device", "cpu", "--batch", "2", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["device"] == "cpu" and out["clock"] == "host"
    assert out["batch"] == 2
    times = {k: v for k, v in out.items()
             if k.endswith("_ms") and v is not None}
    assert times and all(k.startswith("cpu_") for k in times)
    assert all(np.isfinite(v) for v in times.values())
    derived = ("cpu_per_iter_ms", "cpu_factor_dma_ms")
    assert all(v > 0 for k, v in times.items() if k not in derived)
    if argv[0] == "kernel-phases":
        assert set(out["split"]) == {
            "cpu_load_ms", "cpu_mask_ms", "cpu_ruiz_3_passes_ms",
            "cpu_assemble_and_invert_ms", "cpu_first_admm_step_ms",
            "cpu_admm_step_ms"}
    if argv[0] == "qp-phases":
        assert out["soa_ms"] is None


def test_subcommand_needs_a_card_by_default():
    """Without --device the profiler runs on the card, and raises without
    one; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.run_inverse(batch=2)


def test_dense_qp_of_the_prep_is_the_mpc_qp():
    """qp-phases' dense prep builds a well-posed MPC QP: P symmetric
    positive definite (120 x 120), swing variables masked in pairs of legs
    (trot-like table), bounds ordered."""
    params, inputs = profile._prep_inputs(2, torch.device("cpu"))
    p, q, lb, ub, mask = profile.dense_qp_batch(params, *inputs)
    assert p.shape == (2, 120, 120) and q.shape == (2, 120)
    torch.testing.assert_close(p, p.transpose(1, 2))
    assert float(torch.linalg.eigvalsh(p).min()) > 0
    assert torch.all(lb <= ub)
    assert float(mask.sum(dim=1)[0]) == 60.0


# ---- utils/profiling -----------------------------------------------------------------

def test_timer_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.Timer("t")


def test_timed_needs_a_card_and_registers_nothing_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    timers = {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.timed(timers, "a"):
            pass
    assert timers == {}


@pytest.mark.gpu
def test_timer_on_the_card():
    """Needs an NVIDIA GPU: device time of a section from CUDA events, an
    EMA over sections, and the registry flavour."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the timer reads CUDA events")
    a = torch.randn(512, 512, device="cuda")
    t = profiling.Timer("section")
    for _ in range(3):
        with t:
            a @ a
    assert t.count == 3 and t.last_ms > 0 and t.mean_ms > 0
    assert set(t.stats()) == {"section_ms", "section_last_ms"}
    timers = {}
    for _ in range(2):
        with profiling.timed(timers, "a"):
            a @ a
    assert timers["a"].count == 2


def test_device_trace_and_annotate(tmp_path):
    with profiling.device_trace(None) as prof:
        assert prof is None
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("labelled_section"):
            torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any(e.key == "labelled_section" for e in prof.key_averages())


# ---- the CUDA source, on the host and on the card ------------------------------------

@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    from host_emulation import library
    lib = library.build(tmp_path_factory.mktemp("emu"))
    if lib is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    return lib


def stripped_admm_z(p, q, c, iters):
    """z after the stripped runner's ADMM stage (bounds +-BOUND in the
    scaled problem), from the plain phases stripped_solve_reference runs."""
    k, q_s = fused_qp._mask_reference(p, q, torch.ones_like(q))
    k, q_s, cs, *_ = fused_qp._ruiz_reference(k, q_s, c, phase_probe.RUIZ_ITERS)
    rho = torch.full((q.shape[0], 5 * c.shape[1]), phase_probe.RHO)
    k_inv = admm_kernel.spd_inverse(
        fused_qp._assemble_k_reference(k, cs, rho, phase_probe.SIGMA))
    bound = torch.full_like(rho, phase_probe.BOUND)
    _, z, _ = admm_kernel._admm_math(
        iters, phase_probe.SIGMA, phase_probe.RELAX,
        lambda rhs: torch.einsum('bij,bj->bi', k_inv, rhs), cs, q_s, -bound,
        bound, rho, torch.zeros_like(q_s), torch.zeros_like(rho),
        torch.zeros_like(rho))
    return z


@pytest.mark.parametrize("kernel,size", [
    ("stripped_solve", (4, 2, phase_probe.STAGES)),
    ("stripped_solve", (40, 1, ("dma", "ruiz", "kgj", "admm50"))),
    ("bm_dma", (12, 16, 2)), ("bm_dma", (12, 16, 7)),
    ("bm_dma", (120, 128, 3)),
    # q ten times as large, so that the ADMM steps clamp at the bounds
    ("stripped_solve", (8, 1, phase_probe.STAGES, 10.0)),
    ("stripped_solve", (40, 1, ("mask", "admm50"), 10.0)),
    # n = 21: three panels, the last of five pivots; n = 120 at two robots
    ("stripped_solve", (7, 2, ("kgj", "admm50"))),
    ("stripped_solve", (40, 2, ("kgj",)))])
def test_phase_probe_source_on_the_host_matches_plain_version(emulation,
                                                              kernel, size):
    """stripped_solve_kernel's source run thread for thread on the host,
    (nb, B, stages[, q scale]): every stage at n = 12 (the inverse's last
    panel is partial) and n = 24 (the tile's second row slot half full),
    kgj and admm50 at n = 21 (an odd panel count, the last panel partial),
    and at n = 120 (15 panels) the stages up to admm50, against the plain
    version at chip_smoke.py's limits (dma, mask exact; ruiz 1e-5 of scale;
    kgj 5e-4 of max |K^-1|; ADMM x 1e-3 of max(1, |x|)); a scaled-up q
    makes the steps clamp at the bounds (checked on the plain version's z);
    and bm_dma_kernel's, (n, np, B), exact: seven robots wrap a block's ring
    of tile slots, and a full-width tile takes three slots in a grid of two
    blocks. Shared memory starts as NaN."""
    if kernel == "bm_dma":
        n, np_, b = size
        p, q, _ = phase_data(b, n // 3, seed=3)
        p_pad = np.ascontiguousarray(
            np.pad(p, ((0, 0), (0, 0), (0, np_ - n)), constant_values=7.0))
        for tr in (0, 1):
            out = np.full((b, n), np.nan, np.float32)
            assert emulation.rlmpc_emulate_bm_dma(
                p_pad.ctypes.data, q.ctypes.data, out.ctypes.data, b, n, np_,
                tr) == 0
            np.testing.assert_array_equal(out, phase_probe.bm_dma_reference(
                torch.from_numpy(p_pad), torch.from_numpy(q), bool(tr)).numpy())
        return
    codes = {"dma": (0, 0), "mask": (1, 0), "ruiz": (2, 0), "kgj": (3, 0),
             "admm1": (4, 1), "admm50": (4, 50)}
    nb, b, stages, q_scale = (*size, 1.0)[:4]
    n, m = 3 * nb, 5 * nb
    p, q, c = phase_data(b, nb, seed=2)
    q = q * np.float32(q_scale)
    kinv = phase_probe.stripped_solve_reference(
        "kgj", *map(torch.from_numpy, (p, np.zeros_like(q), c))).numpy()
    for stage in stages:
        out = np.full((b, n), np.nan, np.float32)
        code, iters = codes[stage]
        rc = emulation.rlmpc_emulate_stripped_solve(
            p.ctypes.data, q.ctypes.data, c.ctypes.data, out.ctypes.data,
            b, n, m, nb, code, 3, iters, 0.1, 1e-6, 1.6, 1.0)
        assert rc == 0
        want = phase_probe.stripped_solve_reference(
            stage, *map(torch.from_numpy, (p, q, c))).numpy()
        err = np.abs(out - want).max()
        limit = {"dma": 0.0, "mask": 0.0,
                 "ruiz": 1e-5 * np.abs(want).max(),
                 "kgj": 5e-4 * np.abs(kinv).max()}.get(
            stage, 1e-3 * max(1.0, np.abs(want).max()))
        assert err <= limit, (n, stage, err)
    if q_scale != 1.0:
        z = stripped_admm_z(*map(torch.from_numpy, (p, q, c)), 50)
        assert (z.abs() == phase_probe.BOUND).any()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["stripped_solve", "bm_dma"])
def test_phase_kernels_match_plain_version_on_the_card(kernel):
    """Needs an NVIDIA GPU and nvcc: rows 4 and 5 against their plain
    versions at n = 12 and n = 120, at chip_smoke.py's limits, one launch a
    call. chip_smoke.py makes the same comparison at batch 4099."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    for nb, b in ((4, 11), (40, 257)):
        p, q, c = (torch.from_numpy(a).cuda()
                   for a in phase_data(b, nb, seed=4))
        if kernel == "bm_dma":
            p_pad = torch.nn.functional.pad(p, (0, 8)).contiguous()
            for tr in (False, True):
                before = phase_probe.launch_count("bm_dma")
                got = phase_probe.bm_dma(p_pad, q, tr)
                torch.cuda.synchronize()
                assert phase_probe.launch_count("bm_dma") == before + 1
                torch.testing.assert_close(
                    got, phase_probe.bm_dma_reference(p_pad, q, tr),
                    rtol=0, atol=0)
            # not whole 16-byte bulk copies: raises, launches nothing
            before = phase_probe.launch_count("bm_dma")
            for tile in (torch.zeros(1 + p_pad.numel(), device="cuda")[1:]
                         .view(p_pad.shape), p_pad[:, :3, :3].contiguous()):
                with pytest.raises(ValueError, match="bulk copy"):
                    phase_probe.bm_dma(tile, q[:, :tile.shape[1]].contiguous())
            assert phase_probe.launch_count("bm_dma") == before
            continue
        kinv = phase_probe.stripped_solve_reference(
            "kgj", p, torch.zeros_like(q), c).abs().max()
        for stage in phase_probe.STAGES:
            before = phase_probe.launch_count("stripped_solve")
            got = phase_probe.stripped_solve(stage, p, q, c)
            torch.cuda.synchronize()
            assert phase_probe.launch_count("stripped_solve") == before + 1
            want = phase_probe.stripped_solve_reference(stage, p, q, c)
            err = float((got - want).abs().max())
            limit = {"dma": 0.0, "mask": 0.0,
                     "ruiz": 1e-5 * float(want.abs().max()),
                     "kgj": 5e-4 * float(kinv)}.get(
                stage, 1e-3 * max(1.0, float(want.abs().max())))
            assert err <= limit, (nb, stage, err)
