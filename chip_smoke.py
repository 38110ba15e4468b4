"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, drives the port's main path
(the batched Min-mode control tick, ``runner.min_step``, Aliengo, production
QP configuration, batch 4096) and checks what comes out. It needs one GPU,
``nvcc`` and no network, imports only the port, and exits non-zero if any
phase fails or if there is no GPU: it never carries on on the CPU.

Output: one JSON object a line (``device``, ``build``, ``kernel_check`` ...,
``factor_phase_library``, ``main_path_check``, ``main_path``), then the
``kernels`` line, then the card's name and power limit as nvidia-smi prints
them, then ``{"ok": true, "device": {...}}`` as the last line.

Tolerances, kernel against its plain version on the same inputs: x within
1e-3 and z, y within 1e-2 of max(1, |ref|); rho_mult ratio within 1 +- 5e-2;
viol within 1e-2 absolute; res within 1e-2 absolute. Both compute the same
arithmetic in float32; they differ in summation order and in how K is
inverted (Gauss-Jordan in the kernel, Cholesky in the plain version), and the
25 ADMM steps carry that difference forward; rho_mult is the square root of a
ratio of small residuals and amplifies it.
"""
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device; this script runs only on "
                     "a GPU\n")
    sys.exit(1)

from rl_mpc_locomotion_tpu_torch import cli  # noqa: E402
from rl_mpc_locomotion_tpu_torch.control import runner  # noqa: E402
from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig  # noqa: E402
from rl_mpc_locomotion_tpu_torch.models import robots  # noqa: E402
from rl_mpc_locomotion_tpu_torch.ops import gait  # noqa: E402
from rl_mpc_locomotion_tpu_torch.ops.cuda import _build, fused_qp  # noqa: E402
from rl_mpc_locomotion_tpu_torch.ops.qp import production_qp_config  # noqa: E402

SEED = 0
BATCH = 4096
BENCH_PERIODS, BENCH_WARMUP, CHECK_TICKS = 60, 5, 100
DEV = torch.device("cuda")

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

LIMITS = {"x": 1e-3, "z": 1e-2, "y": 1e-2, "rho_mult_ratio": 5e-2,
          "viol": 1e-2, "res": 1e-2}
TORQUE_LIMIT = 5e-3   # of max(1, |tau|), kernel run against plain-version run

PROD = production_qp_config()
SOLVE_KW = dict(alpha=1e-5, iters=PROD.iters, sigma=PROD.sigma,
                relax=PROD.relax, rho_base=PROD.rho,
                rho_eq_scale=PROD.rho_eq_scale, ruiz_iters=PROD.ruiz_iters,
                deferred_rho=PROD.deferred_rho)
SMALL_KW = dict(SOLVE_KW, alpha=1e-4, iters=30, ruiz_iters=3)

failures = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        failures.append(what)
    return bool(ok)


def nvidia_smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def chain_problem(b, h, sd, nb, seed, warm):
    """Random GRF-shaped chain QP batch made with numpy from a seed: SPD
    Hessian from a random chain, block-diagonal cone constraints, swing
    blocks masked with zero bounds, optional warm start."""
    n, m, ad = nb * 3, nb * 5, nb * 3 // h
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(b, h, sd, ad)) * 0.4).astype(np.float32)
    w = (np.abs(rng.normal(size=(b, sd))) + 0.2).astype(np.float32)
    c = rng.normal(size=(b, nb, 5, 3)).astype(np.float32)
    active = (rng.random((b, nb)) > 0.3).astype(np.float32)
    active[:, 0] = 1.0
    mask = np.repeat(active, 3, axis=1)
    rows = np.repeat(active, 5, axis=1)
    lb = -np.abs(rng.normal(size=(b, m))).astype(np.float32) * rows
    ub = np.abs(rng.normal(size=(b, m))).astype(np.float32) * rows
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
    return [torch.from_numpy(a).to(DEV)
            for a in (s, w, q, c, lb, ub, mask, x, z, y, rm)]


def compare_outputs(got, want):
    """Errors of kernel outputs against the plain version's, and whether
    they are inside LIMITS."""
    errs, ok = {}, True
    for name, g, w in zip(("x", "z", "y"), got, want):
        scale = max(1.0, float(w.abs().max()))
        errs[name + "_max_abs"] = float((g - w).abs().max())
        errs[name + "_max_rel"] = errs[name + "_max_abs"] / scale
        ok &= errs[name + "_max_rel"] < LIMITS[name]
    ratio = got[3] / want[3]
    errs["rho_mult_max_abs"] = float((got[3] - want[3]).abs().max())
    errs["rho_mult_ratio_dev"] = float((ratio - 1.0).abs().max())
    ok &= errs["rho_mult_ratio_dev"] < LIMITS["rho_mult_ratio"]
    errs["viol_max_abs"] = float((got[4] - want[4]).abs().max())
    ok &= errs["viol_max_abs"] < LIMITS["viol"]
    errs["res_max_abs"] = float((got[5] - want[5]).abs().max())
    ok &= errs["res_max_abs"] < LIMITS["res"]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return errs, bool(ok and finite)


def time_ms(fn, reps):
    """Median CUDA-event time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def kernel_bound_ms(b, n, m, nb, h, sd, iters, ruiz_iters):
    """Least time the card could take for one call: bytes (each input read
    once, each output written once) over the memory rate, and float32
    operations over the CUDA-core peak; the larger of the two.

    The operations are those the function needs, not those the kernel does:
    the factor phase is counted as a Cholesky factor of K (n^3/3), whose two
    triangular solves cost 2 n^2 an application, the same as the product
    with an explicit inverse that the (iters + 1) * 2 n^2 term counts. The
    kernel itself forms the full inverse by Gauss-Jordan (about n^3)."""
    ad = n // h
    in_floats = h * sd * ad + sd + 3 * n + nb * 15 + 4 * m + 1
    out_floats = n + 2 * m + 4
    bytes_moved = 4 * b * (in_floats + out_floats)
    blocks = h * (h + 1) // 2
    flops = (2 * blocks * ad * ad * sd          # P from the chain
             + 3 * n * n                        # masking
             + ruiz_iters * 5 * n * n           # norms, scaling, cost scaling
             + n ** 3 / 3                       # Cholesky factor of K
             + (iters + 1) * (2 * n * n + 4 * nb * 15 + 6 * m + 3 * n)
             + 20 * (n + m))                    # K blocks, residuals, unscale
    t_bytes = bytes_moved / PEAK_HBM_BYTES_PER_S * 1e3
    t_ops = b * flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": bytes_moved, "flops": b * flops,
            "bytes_ms": t_bytes, "operations_ms": t_ops}


def synthetic_stream(n_ticks, batch, seed):
    """A slowly varying robot state stream made with numpy, the same for
    every robot plus a small per-robot offset from the seed: per tick
    (dof_q (B,12), dof_qd (B,12), body_state (B,13)) on the card."""
    rng = np.random.default_rng(seed)
    dq = (rng.normal(size=(batch, 12)) * 0.02).astype(np.float32)
    dv = (rng.normal(size=(batch, 3)) * 0.05).astype(np.float32)
    base_q = np.tile([0.0, 0.8, -1.6], 4)
    out = []
    for t in range(n_ticks):
        dof_q = base_q + 0.1 * np.sin(0.05 * t + np.arange(12))
        dof_qd = 0.1 * np.cos(0.05 * t + np.arange(12))
        r, p, y = 0.03 * np.sin(0.02 * t + np.arange(3))
        cr, sr, cp, sp = (math.cos(r / 2), math.sin(r / 2), math.cos(p / 2),
                          math.sin(p / 2))
        cy, sy = math.cos(y / 2), math.sin(y / 2)
        quat_xyzw = [sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy]
        body = np.concatenate([
            [0.01 * t, 0.0, 0.33 + 0.01 * np.sin(0.1 * t)], quat_xyzw,
            [0.3 + 0.05 * np.sin(0.1 * t), 0.02 * np.cos(0.1 * t), 0.0],
            [0.01, -0.01, 0.05 * np.sin(0.05 * t)]]).astype(np.float32)
        bq = (dof_q[None].astype(np.float32) + dq)
        bqd = np.tile(dof_qd.astype(np.float32), (batch, 1))
        bb = np.tile(body, (batch, 1))
        bb[:, 7:10] += dv
        out.append(tuple(torch.from_numpy(a).to(DEV) for a in (bq, bqd, bb)))
    return out


def run_ticks(stream, qp_cfg, n_ticks, params, commands):
    """n_ticks of runner.min_step over the stream; returns torques and
    metrics per tick (on the card, nothing read back inside the loop)."""
    cfg = ControlConfig(qp=qp_cfg)
    state = runner.init_state(params, cfg, batch=commands.shape[0],
                              device=DEV)
    taus, mets = [], []
    for t in range(n_ticks):
        q, qd, body = stream[t]
        state, tau, met = runner.min_step(params, cfg, state, q, qd, body,
                                          commands, solve_gate=(t % 2 == 1))
        taus.append(tau)
        mets.append(met)
    torch.cuda.synchronize()
    return taus, mets


def torque_rel_diff(a, b):
    """Per tick: max |a - b| over max(1, |b|) per robot."""
    out = []
    for x, y in zip(a, b):
        scale = y.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
        out.append(float(((x - y).abs() / scale).max()))
    return out


def main():
    t_start = time.time()
    torch.manual_seed(SEED)
    smi_line = nvidia_smi("name,power.limit")
    emit({"device": {"nvidia_smi_name_power_limit": smi_line,
                     "clocks_max_sm": nvidia_smi("clocks.max.sm"),
                     "torch": torch.__version__, "cuda": torch.version.cuda,
                     "python": sys.version.split()[0]}})

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    fused_qp._library()
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "nvcc_seconds": _build.build_seconds,
                    "directory": str(_build.build_dir()),
                    "ptxas": [ln.strip() for ln in _build.build_log.splitlines()
                              if "registers" in ln or "spill" in ln]}})

    # ---- kernel against its plain version --------------------------------
    worst = 0.0   # largest absolute error of x, z or y over every comparison
    cases = [("full", 4099, 10, 13, 40, False, SOLVE_KW),
             ("full", 4099, 10, 13, 40, True, SOLVE_KW),
             ("small", 11, 2, 7, 4, False, SMALL_KW),
             ("small", 11, 2, 7, 4, True, SMALL_KW)]
    for size, b, h, sd, nb, warm, kw in cases:
        args = chain_problem(b, h, sd, nb, SEED + 7, warm)
        got = fused_qp.fused_solve_chain_batch(*args, **kw)
        torch.cuda.synchronize()
        want = fused_qp.fused_solve_chain_batch_reference(*args, **kw)
        errs, ok = compare_outputs(got, want)
        worst = max(worst, errs["x_max_abs"], errs["z_max_abs"],
                    errs["y_max_abs"])
        check(ok, f"kernel_check {size} warm={warm}")
        emit({"kernel_check": {"size": size, "batch": b, "n": nb * 3,
                               "m": nb * 5, "warm_start": warm, "ok": ok,
                               "errors": errs, "limits": LIMITS}})

    # timing at the main path's shapes, same inputs for kernel and plain
    args = chain_problem(BATCH, 10, 13, 40, SEED + 11, True)
    got = fused_qp.fused_solve_chain_batch(*args, **SOLVE_KW)
    want = fused_qp.fused_solve_chain_batch_reference(*args, **SOLVE_KW)
    errs, ok = compare_outputs(got, want)
    check(ok, "kernel_check main-path shapes")
    worst = max(worst, errs["x_max_abs"], errs["z_max_abs"],
                    errs["y_max_abs"])
    kernel_ms = time_ms(
        lambda: fused_qp.fused_solve_chain_batch(*args, **SOLVE_KW), 10)
    plain_ms = time_ms(
        lambda: fused_qp.fused_solve_chain_batch_reference(*args, **SOLVE_KW),
        3)
    bound = kernel_bound_ms(BATCH, 120, 200, 40, 10, 13, SOLVE_KW["iters"],
                            SOLVE_KW["ruiz_iters"])
    # where the kernel's time goes, from the run-time counts alone
    no_admm = time_ms(lambda: fused_qp.fused_solve_chain_batch(
        *args, **dict(SOLVE_KW, iters=0)), 10)
    no_admm_no_ruiz = time_ms(lambda: fused_qp.fused_solve_chain_batch(
        *args, **dict(SOLVE_KW, iters=0, ruiz_iters=0)), 10)
    split = {"admm_24_steps_ms": kernel_ms - no_admm,
             "ruiz_2_passes_ms": no_admm - no_admm_no_ruiz,
             "build_mask_assemble_invert_residuals_unscale_ms": no_admm_no_ruiz}
    emit({"kernel_check": {"size": "main path", "batch": BATCH, "n": 120,
                           "m": 200, "warm_start": True, "ok": ok,
                           "errors": errs, "limits": LIMITS,
                           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                           "kernel_split": split, "bound": bound}})
    # no single PyTorch call computes the whole solve; the factor phase
    # alone, as a batched library inverse of a matrix of the same shape
    spd = torch.randn(BATCH, 120, 120, device=DEV)
    spd = spd @ spd.transpose(1, 2) + 120.0 * torch.eye(120, device=DEV)
    emit({"factor_phase_library": {
        "call": "torch.linalg.inv on (4096,120,120) float32",
        "ms": time_ms(lambda: torch.linalg.inv(spd), 3),
        "note": "the factor phase only, not the kernel's function"}})
    del spd

    # ---- main path: kernel run against plain-version runs, 12 ticks --------
    params = robots.aliengo_params(DEV)
    commands = torch.tensor([0.4, 0.1, 0.2], device=DEV).repeat(BATCH, 1)
    stream = synthetic_stream(CHECK_TICKS, BATCH, SEED)
    k_taus, _ = run_ticks(stream, PROD, 12, params, commands)
    # like with like: the same run with the kernel's plain version in the
    # wrapper's place (same definitions of residuals and rho_mult)
    kernel_entry = fused_qp.fused_solve_chain_batch
    fused_qp.fused_solve_chain_batch = fused_qp.fused_solve_chain_batch_reference
    try:
        r_taus, _ = run_ticks(stream, PROD, 12, params, commands)
    finally:
        fused_qp.fused_solve_chain_batch = kernel_entry
    # across definitions: use_kernel=False is the plain pipeline, which takes
    # its residuals at the relaxed x, so its rho_mult parts from the kernel's
    # after the first solve (by design, in the JAX package too); held to the
    # limit up to the first solve (ticks 0-2), reported after
    p_taus, _ = run_ticks(stream, PROD._replace(use_kernel=False), 12, params,
                          commands)
    # nothing on the tick's path may read the device: two more ticks with
    # PyTorch's synchronisation check set to raise
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_state = runner.init_state(params, ControlConfig(qp=PROD),
                                      batch=BATCH, device=DEV)
        for t in range(2):
            run_state, _, _ = runner.min_step(
                params, ControlConfig(qp=PROD), run_state, *stream[t],
                commands, solve_gate=(t == 1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    vs_plain_version = torque_rel_diff(k_taus, r_taus)
    vs_pipeline = torque_rel_diff(k_taus, p_taus)
    ok_cmp = (max(vs_plain_version) < TORQUE_LIMIT
              and max(vs_pipeline[:3]) < TORQUE_LIMIT)
    check(ok_cmp, "main_path_check torque comparison")
    emit({"main_path_check": {
        "ticks": 12, "batch": BATCH, "limit_rel": TORQUE_LIMIT, "ok": ok_cmp,
        "two_ticks_without_host_sync": True,
        "kernel_vs_plain_version_max_rel": max(vs_plain_version),
        "kernel_vs_use_kernel_false_first_solve_max_rel": max(vs_pipeline[:3]),
        "kernel_vs_use_kernel_false_later_ticks_max_rel": max(vs_pipeline[3:]),
        "note": "use_kernel=False defines the residuals that drive rho_mult "
                "differently, so later ticks are reported, not limited"}})

    # ---- main path: the counted run ----------------------------------------
    fused_qp.reset_launch_count()
    timing = cli.bench(batch=BATCH, periods=BENCH_PERIODS,
                       warmup=BENCH_WARMUP)
    bench_launches = fused_qp.launch_count()
    taus, mets = run_ticks(stream, PROD, CHECK_TICKS, params, commands)
    launches = fused_qp.launch_count()

    solve_ticks = BENCH_PERIODS + BENCH_WARMUP + CHECK_TICKS // 2
    finite = all(bool(torch.isfinite(t).all()) for t in taus)
    offsets, durations = gait.gait_params(0, DEV)
    # Legs off the ground in the first horizon step get zero force: exactly
    # zero over the first gait cycle (20 ticks). Later a variable that the
    # receding-horizon shift carried in from a step where its leg stood
    # decays geometrically inside the masked block instead of being cleared,
    # so a force of order 1e-8 N can remain (the plain pipeline and the JAX
    # package do the same: tests/test_torch_control_long.py); held below
    # 1e-6 N over 4096 robots against stance forces of 1e2 N.
    swing_exact_first_cycle, swing_abs_max = True, 0.0
    for t in range(1, CHECK_TICKS, 2):
        it, _ = gait.gait_iteration_phase(
            torch.full((BATCH,), t, device=DEV), 2)
        table = gait.mpc_table(it, offsets.expand(BATCH, 4),
                               durations.expand(BATCH, 4))
        worst_t = float(mets[t]["f_ff"][table[:, 0] == 0.0].abs().max())
        swing_abs_max = max(swing_abs_max, worst_t)
        if t < 20:
            swing_exact_first_cycle &= worst_t == 0.0
    swing_zero = swing_exact_first_cycle and swing_abs_max < 1e-6
    diverged = float(torch.stack(
        [mets[t]["qp_diverged"].float().mean() for t in range(1, CHECK_TICKS, 2)]
    ).mean())
    ok_main = (check(launches == solve_ticks, "launch count != solve ticks")
               & check(bench_launches == BENCH_PERIODS + BENCH_WARMUP,
                       "bench launch count")
               & check(finite and timing["torques_finite"], "torques finite")
               & check(swing_zero, "swing-leg forces zero")
               & check(diverged < 0.05, "qp_diverged fraction < 5%")
               & check(tuple(taus[-1].shape) == (BATCH, 12), "torque shape"))
    emit({"main_path": {
        "robot": "Aliengo", "batch": BATCH, "gait": "trot",
        "qp": PROD._asdict(), "ok": bool(ok_main),
        "timed_periods": timing["periods"],
        "mpc_period_ms": timing["mpc_period_ms"],
        "mpc_period_ms_max": timing["mpc_period_ms_max"],
        "mpc_period_ms_mean": timing["mpc_period_ms_mean"],
        "host_loop_period_ms": timing["host_loop_period_ms"],
        "solves_per_s": timing["value"],
        "kernel_share_of_period": kernel_ms / timing["mpc_period_ms"],
        "checked_ticks": CHECK_TICKS, "kernel_launches": launches,
        "solve_ticks": solve_ticks, "torques_finite": finite,
        "swing_forces_exactly_zero_first_cycle": swing_exact_first_cycle,
        "swing_force_abs_max_newton": swing_abs_max,
        "qp_diverged_frac": diverged,
        "qp_diverged_frac_bench_last_tick": timing["qp_diverged_frac"],
        "torque_abs_max": float(torch.stack(taus).abs().max())}})

    emit({"kernels": [{
        "name": "fused_solve_chain_batch", "route": "cuda",
        "source": "rl_mpc_locomotion_tpu_torch/csrc/fused_qp.cu",
        "replaces": "rl_mpc_locomotion_tpu/ops/pallas/fused_qp.py:340",
        "launches": launches, "max_abs_err": worst, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None}]})
    emit({"seconds": time.time() - t_start, "failures": failures})
    if failures:
        sys.exit(1)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
