"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (afresh, into
build/chip_smoke, so that nvcc's register and spill lines are there to
check), holds each kernel
against its plain PyTorch version on the card, drives the port's paths that
run them and checks what comes out:

- the main path: the batched Min-mode control tick (``runner.min_step``,
  Aliengo, production QP configuration, batch 4096), which runs the MPC
  assembly kernel (``mpc_assembly.assemble_mpc_batch``) and the fused
  chain-QP kernel (``fused_qp.fused_solve_chain_batch``) once a solve tick;
- the MPC assembly kernel alone (``mpc_assembly``): against its plain
  version and timed beside it at 4096 and 262144 robots (a trot, Aliengo's
  shared parameters), with its bound (bytes at 3.35 TB/s) and registers;
- the accurate configuration of the same tick (``QPConfig(use_kernel=True)``:
  50 + 50 ADMM steps, adaptive rho, polish), which runs the scaled-solve
  kernel (``admm_kernel.solve_scaled_batch``) twice a solve and the assembly
  kernel once;
- the prebuilt-Hessian solve (``qp.solve_qp``, ``fused_qp.fused_solve_batch``)
  and the QP profiler (``rl_mpc_locomotion_tpu_torch.profile``), which runs
  the phase timers (``phase_probe``);
- the benchmark harness and the mesh, with row 1 in every solve tick:
  ``bench_paths`` (``bench.sweep`` at 512 and 4096 robots, 40 periods each;
  one ``bench.bench_train`` iteration at 512 envs on rough ground with DR;
  ``profile period --iters-sweep 10 --ruiz-sweep 0`` and ``profile qp-knobs
  norho``) and ``parallel_path`` (a one-rank NCCL group, one
  ``make_train_step(mesh=...)`` iteration at 512 envs against ``mesh=None``);
- the closed loop, each path with the production configuration and so the
  fused chain-QP kernel inside it: ``closed_loop`` (``runner.min_step`` +
  ``physics.step``, one heterogeneous batch of 4096 Aliengo / Go1 / A1, 300
  ticks, then the same with ``use_kernel=False``), ``env_path``
  (``env.reset`` + ``env.step`` at batch 4096 with domain randomisation, 200
  steps), ``fsm_path`` (``runner.fsm_step`` + physics from recovery stand,
  300 ticks) and ``play_cli`` (``cli play`` in Min and Fsm mode);
- PPO training over the env, with the fused chain-QP kernel in every
  rollout: ``train_path`` (``rl/train.make_train_step`` at 4096 Aliengo
  envs on flat ground, the full ``ActorCritic`` and the default
  ``PPOConfig``: one warm-up and three timed iterations), ``train_update``
  (one ``ppo_update`` of a recorded rollout on the card against the same
  update on the CPU), ``train_learning`` (``rl/train.train``,
  tests/test_learning.py's protocol at 512 envs, 60 iterations, then the
  same with the production QP configuration),
  ``train_resume`` (4 iterations against 2 + resume 2 at 64 envs) and
  ``train_cli`` (``cli train``, then ``cli train --resume``);
- the trained weight policy, deployed and evaluated, with the fused
  chain-QP kernel in every solve tick: ``policy_weights`` (the six
  committed weight files on the card against the CPU), ``policy_path``
  (``weight_policy.policy_fsm_step`` + physics, 4096 Aliengo robots, the
  committed ``aliengo_weight_policy``, 300 ticks from recovery stand),
  ``eval_path`` (``rl/evaluate.ab_compare``, the policy against the default
  MPC weights at 64 and at 4096 envs, 500 steps) and ``policy_cli`` (``cli
  play --mode Policy --telemetry`` and ``cli eval``).
- the articulated 18-DoF plant (``sim/articulated``, ``PhysicsConfig(
  articulated=True)``), with the fused chain-QP kernel in every solve tick
  of its closed loop: ``articulated_params`` (``for_robot`` on the card
  against the CPU build, ``mass_matrix`` at 4096 seeded poses),
  ``articulated_invariants`` (4096 Aliengo robots in free fall),
  ``articulated_step`` (one ``physics.step`` on the card against the CPU),
  ``articulated_loop`` (tests/test_articulated.py's closed loop at 4096
  robots, 200 ticks, then ``use_kernel=False``) and ``three_tier``
  (docs/ARCHITECTURE.md's comparison of the three plants: Aliengo, trot,
  vx 0.5, at 4096 robots, 2 s of the table's 4 s).
- the viewer, the demos and the measuring scripts, with the fused chain-QP
  kernel in every demo and script that solves: ``viewer_path``
  (``utils/viewer.record_frame`` on the card against the CPU; ``render``
  where matplotlib is installed, else ``require_matplotlib`` and ``cli play
  --render`` raising before any tick), ``examples_path`` (the three demos'
  ``main``: ``simulator_test`` 1 s, ``mpc_terrain_show`` and
  ``rl_mpc_show`` 1.5 s each) and ``scripts_path``
  (``qp_budget_sweep.measure`` and one ``envelope_sweep`` point at 64 envs
  x 40 steps, ``plot_telemetry.load_frames`` of a ``play --telemetry``
  log, ``multidev_scaling``'s worker at n = 1, one ``run_campaigns``
  iteration at 64 envs).

It needs one GPU, ``nvcc`` and no network, imports only the port, and exits
non-zero if any phase fails or if there is no GPU: it never carries on on
the CPU.

Output: one JSON object a line (``device``, ``build``, ``kernel_check`` ...,
``mpc_assembly``, ``main_path``, ``accurate_path``, ``profile`` ...,
``bench_paths``, ``parallel_path``, ``closed_loop``,
``env_path``, ``fsm_path``, ``play_cli``, ``train_path``,
``train_update``, ``train_learning``, ``train_resume``, ``train_cli``,
``policy_weights``, ``policy_path``, ``eval_path``, ``policy_cli``,
``articulated_params``, ``articulated_invariants``, ``articulated_step``,
``articulated_loop``, ``three_tier``, ``viewer_path``, ``examples_path``,
``scripts_path``), then the ``kernels``
line, then the card's name and power limit as nvidia-smi prints them, then
``{"ok": true, "device": {...}}`` as the last line.

Tolerances, kernel against its plain version on the same inputs (``LIMITS``):
x within 1e-3 and z, y within 1e-2 of max(1, |ref|); rho_mult ratio within
1 +- 5e-2; viol within 1e-2 absolute; res within 1e-2 absolute. Both compute
the same arithmetic in float32; they differ in summation order and in how K
is inverted (Gauss-Jordan in the kernels, Cholesky in the plain versions),
and the ADMM steps carry that difference forward; rho_mult is the square
root of a ratio of small residuals and amplifies it. The phase timer: the
dma and mask stages and the tile load exactly; ruiz within 1e-5 of the
stage's largest entry; kgj within 5e-4 of the largest entry of K^-1's row;
the ADMM stages x within 1e-3 of max(1, |ref|). The kgj stage's row of K^-1
is also held against a float64 ``torch.linalg.inv`` of the same K (formed by
the plain phases), within the kgj limit. Rows 1-4 must build without a
register spill and with two blocks resident an SM. The MPC assembly kernel
against its plain version on the same inputs: s_chain and q within 1e-5 of
the robot's largest |value| (tests/test_torch_mpc_assembly.py's limit: the
closed-form chain and regrouped sums round otherwise than the 13 x 13
products), also against the plain version in float64 at 4096 robots; lb, ub
and mask exactly; built without a spill. The tile load must raise, and
launch nothing, on a tile that is not whole 16-byte bulk copies (misaligned,
or n*np not a multiple of 4). The accurate tick: every
scaled-solve launch on it within LIMITS of its plain version on the same
inputs, torques within TORQUE_LIMIT of the use_kernel=False run for every
robot that took no other discrete branch, and at most FLIP_LIMIT of the
robots on another branch. Each scaled-solve launch there is also run in
float64 by its plain version, and both sides' distances to that are reported
(``vs_float64``), not limited.

The closed loop: every robot of ``closed_loop``'s kernel run within
tests/test_closed_loop.py's limits (base height in (0.65 h, 1.35 h + 0.05),
|roll|, |pitch| < 0.4 rad, x at 3 s >= 1.0 / 0.5 / 0.5 m for Aliengo / Go1 /
A1, |y| < 0.2 m) and finite; its use_kernel=False run reported without
limits. ``env_path``: observations (4096, 48) and rewards finite every
step, every timed-out env reset, two steps (an auto-reset among them) under
``torch.cuda.set_sync_debug_mode("error")``, and envs given a NaN velocity
reset with reward 0 while the others carry on. ``fsm_path``: the whole batch
in locomotion on tick 2 (two-tick protocol), every robot walking at 3 s
(Aliengo's limits above), a +45 deg body roll switching to recovery and a
-45 deg roll not (the reference's fabs-of-bool check). On every path row 1
and the assembly kernel launch once a solve tick (a tick whose gate is
true) and no other kernel launches; a ``use_kernel=False`` run launches
neither.

The harness: every sweep row above its physical floor (``bench`` raises
below it) and none failed, row 1 once a solve tick on every entry (the
sweep's warm-up and timed periods, 12 for the ``bench_train`` iteration, the
solving configurations of ``period``, ``qp-knobs``' periods) and no other
kernel; ``parallel_path``: parameters, lr and metrics of the mesh's
iteration equal to the plain one's, bit for bit.

Training: row 1 launches 12 times a 24-step iteration (every second env
step) and no other kernel launches; one whole iteration (``step_fn``) runs
under ``torch.cuda.set_sync_debug_mode("error")``; the metrics, QP
telemetry included, are finite. ``train_update``: the card's update against
the CPU's on the same rollout, parameters, Adam state and permutations:
the lr within 1e-6 relative, the parameters within 1e-4 of the tensor's
largest |param| and, measured against how far the CPU's update moved them
(the tensor's largest |new - old|), 99.9 % of the entries within 1e-3 of
it and every entry within 0.25 of it (tests/test_torch_ppo.py's tolerance
against the JAX package: Adam divides a gradient by its running RMS, so an
entry whose gradient is at rounding level takes a step whose size follows
the rounding); the Adam moments within 5e-3 of the tensor's largest
|moment| (a gradient is a sum over 24 576 rows, taken in another order on
the card: 3.1e-3 in a sound run on an H100).
``train_learning``: tests/test_learning.py's two assertions (the mean
reward of the last two logged iterations above twice that of the first
two, and above it by 0.002), for its own configuration and for the
production QP configuration. ``train_resume`` reports the largest
difference between the resumed and the straight run on the card (0 on the
CPU, tests/test_torch_train.py) and the ops that torch reports as
non-deterministic in one iteration. ``train_cli``: both runs
exit 0 with finite logged rewards, metrics.jsonl holds finite rows,
model_3 and model_6 exist.

The weight policy: ``policy_weights`` holds the actor's means on the card
against the CPU within 1e-5 of max(1, |ref|) for ``aliengo_weight_policy``
and, for all six, within 1e-6 of max(1, M), M the magnitude of the sums
that form the mean (``SUM_LIMIT``: five of the policies are saturated, with
means of ~1e9 formed by sums that cancel, where no float32 forward comes
within 1e-5 of |ref|). ``policy_path``: the batch in locomotion on tick 2
and to the end, every robot finite and its base above 0.6 x body height
every tick (tests/test_eval_ab.py's limit), the weights inside the action
box's image [1,9]^3 x [30,70]^3 x [0,2]^6 x {0} every tick, row-1 launches
equal to the gate ticks, one tick under the sync check apart from the
gate's read-back. ``eval_path`` at 4096 x 500: both arms' metrics finite,
500 row-1 launches, one host sync an arm (its final read-back), and
``policy_beats_default`` (reward, survival - 0.01, falls x 1.05 + 1). The
64-env A/B is reported beside the JAX package's committed one, without a
limit (the draws differ: a torch.Generator, not PRNGKey(0)).
``policy_cli``: both exit 0, one ``[play]`` summary, a telemetry frame a
tick read back, and an A/B JSON with both arms.

The articulated plant: ``for_robot`` built on the card bitwise equal to the
CPU build for the three robots; H at 4096 poses symmetric to 1e-4,
positive definite, its v-block the total mass times I (rtol 1e-5);
``articulated_invariants``: every robot's energy drift under 1 % over 100
zero-torque substeps, its linear momentum within 2 % of M g, its angular
momentum about the COM drifting under 5 % over 150 pumping substeps
(tests/test_articulated.py's limits); ``articulated_step``: every field
of one step on the card within 1e-4 of max(1, |ref|) of the CPU's
(``ART_STEP_LIMIT``, the CPU tests' tolerance against the JAX package;
TF32 products would exceed it) and no contact flag flipped;
``articulated_loop``: every robot finite, its base above 0.6 body height
and its mean vx in (0.1, 0.8) over the last 100 ticks, row 1 once a solve
tick and nothing else; ``three_tier``: row 1 once a solve tick on each
plant, and the articulated plant's mean vx in (0.1, 0.8); its other
statistics are reported beside the JAX package's table, not limited, with
the index, start joints and lowest base of every robot that fell (at most
16 a plant), for a replay on the CPU.

The viewer, demos and scripts: ``record_frame`` on the card within 1e-5 m
of the CPU (``VIEWER_LIMIT``); each demo meets its own criterion, with row
1 launched in the two that solve and in none of them another kernel; the
scripts' row-1 launches equal their solve ticks (20 for the 40-step
budget run, 40 for the envelope point's two arms, 12 a training
iteration; none in ``play``'s Min mode, which runs the default QPConfig as
the JAX CLI does), their metrics finite, the play log read back as a frame
a tick.
"""
import contextlib
import copy
import ctypes
import glob
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device; this script runs only on "
                     "a GPU\n")
    sys.exit(1)

from rl_mpc_locomotion_tpu_torch import bench as bench_mod  # noqa: E402
from rl_mpc_locomotion_tpu_torch import cli  # noqa: E402
from rl_mpc_locomotion_tpu_torch import profile as qp_profile  # noqa: E402
from rl_mpc_locomotion_tpu_torch.control import fsm, runner  # noqa: E402
from rl_mpc_locomotion_tpu_torch.control import weight_policy  # noqa: E402
from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig  # noqa: E402
from rl_mpc_locomotion_tpu_torch.examples import (  # noqa: E402
    mpc_terrain_show, rl_mpc_show, simulator_test)
from rl_mpc_locomotion_tpu_torch.models import robots  # noqa: E402
from rl_mpc_locomotion_tpu_torch.models.actor_critic import (  # noqa: E402
    ActorCritic)
from rl_mpc_locomotion_tpu_torch.ops import gait  # noqa: E402
from rl_mpc_locomotion_tpu_torch.ops import qp as tqp  # noqa: E402
from rl_mpc_locomotion_tpu_torch.ops import rotations as rot  # noqa: E402
from rl_mpc_locomotion_tpu_torch.ops import srb_dynamics as srb  # noqa: E402
from rl_mpc_locomotion_tpu_torch.ops.cuda import (  # noqa: E402
    _build, admm_kernel, fused_qp, mpc_assembly, phase_probe)
from rl_mpc_locomotion_tpu_torch.ops.leg_kinematics import (  # noqa: E402
    hip_locations)
from rl_mpc_locomotion_tpu_torch.parallel import distributed  # noqa: E402
from rl_mpc_locomotion_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from rl_mpc_locomotion_tpu_torch.rl import evaluate as eval_mod  # noqa: E402
from rl_mpc_locomotion_tpu_torch.rl import ppo  # noqa: E402
from rl_mpc_locomotion_tpu_torch.rl import train as train_mod  # noqa: E402
from rl_mpc_locomotion_tpu_torch.scripts import (  # noqa: E402
    envelope_sweep, multidev_scaling, plot_telemetry, qp_budget_sweep,
    run_campaigns)
from rl_mpc_locomotion_tpu_torch.sim import (  # noqa: E402
    articulated, env, physics, randomize, terrain)
from rl_mpc_locomotion_tpu_torch.utils import checkpoint  # noqa: E402
from rl_mpc_locomotion_tpu_torch.utils import convert  # noqa: E402
from rl_mpc_locomotion_tpu_torch.utils import native_runtime  # noqa: E402
from rl_mpc_locomotion_tpu_torch.utils import seeding  # noqa: E402
from rl_mpc_locomotion_tpu_torch.utils import viewer  # noqa: E402

SEED = 0
BATCH = 4096
BENCH_PERIODS, BENCH_WARMUP, CHECK_TICKS = 60, 5, 100
ACCURATE_TICKS, ACCURATE_PERIODS = 12, 20
DEV = torch.device("cuda")

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W); the
# float32 one is bench.py's, behind its physical floor
PEAK_F32_FLOPS = bench_mod.PEAK_F32_FLOPS
PEAK_HBM_BYTES_PER_S = 3.35e12

LIMITS = {"x": 1e-3, "z": 1e-2, "y": 1e-2, "rho_mult_ratio": 5e-2,
          "viol": 1e-2, "res": 1e-2}
PHASE_LIMITS = {"dma": 0.0, "mask": 0.0, "ruiz": 1e-5, "kgj": 5e-4,
                "admm1": 1e-3, "admm50": 1e-3}
TORQUE_LIMIT = 5e-3   # of max(1, |tau|), kernel run against plain-version run
# accurate tick: share of robots that may take another discrete branch than
# the use_kernel=False run (316 of 4096, 7.7 %, in a sound run on an H100)
FLIP_LIMIT = 0.15

PROD = tqp.production_qp_config()
ACCURATE = tqp.QPConfig(use_kernel=True)
SOLVE_KW = dict(alpha=1e-5, iters=PROD.iters, sigma=PROD.sigma,
                relax=PROD.relax, rho_base=PROD.rho,
                rho_eq_scale=PROD.rho_eq_scale, ruiz_iters=PROD.ruiz_iters,
                deferred_rho=PROD.deferred_rho)
SMALL_KW = dict(SOLVE_KW, alpha=1e-4, iters=30, ruiz_iters=3)
# full width (Aliengo: n = 120, m = 200, 40 cone blocks, horizon 10, state
# 13) at an odd batch, and the CPU tests' small size (n = 12) at batch 11
SIZES = [("full", 4099, 10, 13, 40, SOLVE_KW), ("small", 11, 2, 7, 4, SMALL_KW)]
# the same for the phase timers: (size, batch, cone blocks, padded width)
PHASE_SIZES = [("full", 4099, 40, 128), ("small", 11, 4, 16)]

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


def spill_bytes(ptxas_line):
    """Bytes of spill stores plus spill loads on a ptxas line."""
    total = 0
    for part in ptxas_line.split(","):
        words = part.split()
        if "spill" in words and words[0].isdigit():
            total += int(words[0])
    return total


def ptxas_by_kernel(log):
    """nvcc's -Xptxas -v output grouped by kernel: {name: 'spills; regs'}."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            name = next((k for k in ("fused_solve_chain_kernel",
                                     "fused_solve_kernel",
                                     "scaled_solve_kernel",
                                     "stripped_solve_kernel", "bm_dma_kernel",
                                     "mpc_assembly_kernel")
                         if k in mangled), mangled)
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.strip())
    return {k: "; ".join(v) for k, v in out.items()}


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


def dense_problem(args, alpha):
    """The chain problem with its Hessian built: the prebuilt-P solve's
    arguments (P, q, c, lb, ub, mask, x, z, y, rho_mult)."""
    s, w = args[:2]
    return [srb.hessian_from_chain(s, w, alpha).contiguous()] + args[2:]


def scaled_problem(args, kw):
    """The chain problem carried to the scaled-solve kernel's inputs by the
    plain phases (mask, Ruiz, per-row rho with the equality boost, K):
    (K, q_s, c_s, l_s, u_s, rho, x, z, y), warm start scaled."""
    p, q, c, lb, ub, mask, x, z, y, rm = dense_problem(args, kw["alpha"])
    k, q_s = fused_qp._mask_reference(p, q, mask)
    k, q_s, cs, d, e, c_cost = fused_qp._ruiz_reference(k, q_s, c,
                                                        kw["ruiz_iters"])
    base = kw["rho_base"] * rm[:, None]
    rho = torch.where((ub - lb) < 1e-9, base * kw["rho_eq_scale"],
                      base.expand_as(lb))
    k = fused_qp._assemble_k_reference(k, cs, rho, kw["sigma"])
    return [t.contiguous() for t in (k, q_s, cs, e * lb, e * ub, rho, x / d,
                                     z * e, y * (c_cost / e))]


def phase_problem(b, nb, seed):
    """The phase timer's data: SPD P = A A^T + 5 I, q ~ N(0,1), cone
    blocks 0.3 (the TPU runner's; q is random here so that the ADMM stages
    move)."""
    n = 3 * nb
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32)
                         ).to(DEV) * 0.1
    p = a @ a.transpose(1, 2) + 5.0 * torch.eye(n, device=DEV)
    q = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(DEV)
    return p, q, torch.full((b, nb, 5, 3), 0.3, device=DEV)


def rel_errs(got, want, names):
    errs, rel = {}, {}
    for name, g, w in zip(names, got, want):
        scale = max(1.0, float(w.abs().max()))
        errs[name + "_max_abs"] = float((g - w).abs().max())
        rel[name] = errs[name + "_max_abs"] / scale
        errs[name + "_max_rel"] = rel[name]
    return errs, rel


def compare_outputs(got, want):
    """Errors of solve outputs (x, z, y, rho_mult, viol, res) against the
    plain version's, and whether they are inside LIMITS."""
    errs, rel = rel_errs(got[:3], want[:3], ("x", "z", "y"))
    ok = all(rel[k] < LIMITS[k] for k in rel)
    ratio = got[3] / want[3]
    errs["rho_mult_ratio_dev"] = float((ratio - 1.0).abs().max())
    ok &= errs["rho_mult_ratio_dev"] < LIMITS["rho_mult_ratio"]
    errs["viol_max_abs"] = float((got[4] - want[4]).abs().max())
    ok &= errs["viol_max_abs"] < LIMITS["viol"]
    errs["res_max_abs"] = float((got[5] - want[5]).abs().max())
    ok &= errs["res_max_abs"] < LIMITS["res"]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return errs, bool(ok and finite)


def worst_abs(errs, names=("x", "z", "y")):
    return max(errs[k + "_max_abs"] for k in names)


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


def bound(b, in_floats, out_floats, flops):
    """Least time the card could take for one call: bytes (each input read
    once, each output written once) over the memory rate, and float32
    operations over the CUDA-core peak; the larger of the two. ``flops`` is
    a robot's."""
    bytes_moved = 4 * b * (in_floats + out_floats)
    t_bytes = bytes_moved / PEAK_HBM_BYTES_PER_S * 1e3
    t_ops = b * flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": bytes_moved, "flops": b * flops,
            "bytes_ms": t_bytes, "operations_ms": t_ops}


def admm_flops(n, m, nb, iters):
    return iters * (2 * n * n + 4 * nb * 15 + 6 * m + 3 * n)


def solve_flops(n, m, nb, iters, ruiz_iters):
    """A robot's operations for the solve from P: masking, Ruiz passes (norms,
    scaling, cost scaling), the factor phase counted as a Cholesky factor of
    K (n^3/3, whose two triangular solves cost 2 n^2 an application, the same
    as the product with an explicit inverse that the ADMM term counts; the
    kernels form the full inverse by Gauss-Jordan, about n^3), iters + 1
    applications, K blocks, residuals and unscaling."""
    return (3 * n * n + ruiz_iters * 5 * n * n + n ** 3 / 3
            + admm_flops(n, m, nb, iters + 1) + 20 * (n + m))


def chain_bound(b, n, m, nb, h, sd, iters, ruiz_iters):
    """Row 1: the solve from the chain, P built on chip (2 ad^2 sd FMAs a
    block of the lower triangle)."""
    ad = n // h
    blocks = h * (h + 1) // 2
    return bound(b, h * sd * ad + sd + 3 * n + nb * 15 + 4 * m + 1,
                 n + 2 * m + 4,
                 2 * blocks * ad * ad * sd + solve_flops(n, m, nb, iters,
                                                         ruiz_iters))


def p_bound(b, n, m, nb, iters, ruiz_iters):
    """Row 2: the solve from a prebuilt P (n^2 floats a robot in)."""
    return bound(b, n * n + 3 * n + nb * 15 + 4 * m + 1, n + 2 * m + 4,
                 solve_flops(n, m, nb, iters, ruiz_iters))


def scaled_bound(b, n, m, nb, iters):
    """Row 3: factor of K and iters ADMM steps."""
    return bound(b, n * n + 2 * n + nb * 15 + 5 * m, n + 2 * m,
                 n ** 3 / 3 + admm_flops(n, m, nb, iters))


def stripped_bound(b, n, m, nb):
    """Row 4 at its last stage (admm50): mask, 3 Ruiz passes, K, factor, 50
    ADMM steps; reads P, q, C, writes x."""
    return bound(b, n * n + n + nb * 15, n,
                 3 * n * n + 3 * 5 * n * n + n ** 3 / 3
                 + admm_flops(n, m, nb, 50) + 20 * (n + m))


def tile_bound(b, n, transpose=False):
    """Row 5: its output is q + column 0 of P (row 0 with ``transpose``), so
    the function needs n entries of P a robot: one 32-byte sector (8 floats)
    a row for the strided column, n contiguous floats for the row; plus q in
    and the result out. The kernel loads the whole padded tile by design (it
    times that load); its rate is reported beside the bound, not as it."""
    return bound(b, (n if transpose else 8 * n) + n, n, n)


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


def row_rel(x, y):
    """Per robot (row): max |x - y| over max(1, |y|)."""
    scale = y.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
    return ((x - y).abs() / scale).amax(dim=1)


def torque_rel_diff(a, b):
    """Per tick: the largest per-robot relative torque difference."""
    return [float(row_rel(x, y).max()) for x, y in zip(a, b)]


BRANCHES = ("rho_clip", "polish_active", "polish_kept")


class BranchRecorder:
    """Records, per robot, the discrete branches each plain-pipeline solve
    (``qp._solve_qp_impl``) reports in its diagnostics: the rho rescale's
    clip end, the polish's active set and whether the polished x was kept.
    Installed by wrapping ``qp._solve_qp_impl``, which ``solve_qp_chain``
    looks up at each call."""

    def __init__(self):
        self.solves = []
        self._orig = tqp._solve_qp_impl

    def __enter__(self):
        impl = self._orig

        def record(*args, **kwargs):
            out = impl(*args, **kwargs)
            self.solves.append({k: out[2][k] for k in BRANCHES})
            return out

        tqp._solve_qp_impl = record
        return self

    def __exit__(self, *exc):
        tqp._solve_qp_impl = self._orig


class ScaledSolveCheck:
    """Holds every launch of the scaled-solve kernel on a path against its
    plain version on the same inputs (x, z, y within LIMITS): the first
    solve's rho (even calls) and the restart's per-row rho, clipped to
    [1e-6, 1e6] (odd calls). The plain version launches nothing, so the
    launch count is the path's own.

    Beside it, the plain version on the same inputs cast to float64 (the same
    fixed count of steps, not the QP's optimum, which neither side reaches
    in 50 steps): each side's distance to it in x, z and y of max(1, |ref|),
    and where the y differences lie, on the equality rows (l = u, rho scaled
    by rho_eq_scale) or on the cone rows. Reported, not limited."""

    def __init__(self):
        self.errs = {"first": [], "restart": []}
        self.f64 = {"first": [], "restart": []}
        self.ok, self.max_abs = True, 0.0
        self._orig = admm_kernel.solve_scaled_batch

    def __enter__(self):
        kernel = self._orig
        calls = [0]

        def checked(*args, **kwargs):
            got = kernel(*args, **kwargs)
            want = admm_kernel.solve_scaled_batch_reference(*args, **kwargs)
            exact = admm_kernel.solve_scaled_batch_reference(
                *(a.double() for a in args), **kwargs)
            errs, rel = rel_errs(got, want, ("x", "z", "y"))
            self.max_abs = max(self.max_abs, worst_abs(errs))
            self.ok &= (all(rel[k] < LIMITS[k] for k in rel)
                        and all(bool(torch.isfinite(g).all()) for g in got))
            which = "restart" if calls[0] % 2 else "first"
            self.errs[which].append(
                {k: errs[k + "_max_rel"] for k in ("x", "z", "y")})
            eq_row = (args[4] - args[3]) < 1e-9
            self.f64[which].append({
                "kernel": vs_exact(got, exact, eq_row),
                "plain": vs_exact(want, exact, eq_row),
                "kernel_vs_plain_y": y_by_rows(got[2], want[2], eq_row)})
            calls[0] += 1
            return got

        admm_kernel.solve_scaled_batch = checked
        return self

    def __exit__(self, *exc):
        admm_kernel.solve_scaled_batch = self._orig

    def worst(self, which):
        return {k: max((e[k] for e in self.errs[which]), default=None)
                for k in ("x", "z", "y")}

    def vs_float64(self, which):
        """The worst of each distance over this kind's calls, and the
        kernel's distance over the plain version's."""
        calls = self.f64[which]
        out = {side: {k: max(c[side][k] for c in calls)
                      for k in calls[0][side]}
               for side in ("kernel", "plain", "kernel_vs_plain_y")}
        out["kernel_over_plain"] = {
            k: out["kernel"][k] / max(out["plain"][k], 1e-30)
            for k in ("x", "z", "y")}
        return out


def y_by_rows(y, ref, eq_row):
    """max |y - ref| on the equality rows and on the cone rows, each over
    max(1, |ref|) of the whole y."""
    diff = (y - ref).abs()
    scale = max(1.0, float(ref.abs().max()))
    return {"y_eq_rows": float(torch.where(eq_row, diff, 0.0).max()) / scale,
            "y_cone_rows": float(torch.where(eq_row, 0.0, diff).max()) / scale}


def vs_exact(got, exact, eq_row):
    """x, z, y of a float32 solve against the float64 one, of max(1, |ref|),
    and y split by rows."""
    out = rel_errs(got, exact, ("x", "z", "y"))[1]
    out.update(y_by_rows(got[2], exact[2], eq_row))
    return out


def first_flip(rec_a, rec_b, batch):
    """Per robot, the index of the first solve at which the two runs took a
    different branch (clip, active set or kept), or a large number."""
    never = len(rec_a.solves) + 1
    first = torch.full((batch,), never, device=DEV)
    for j, (a, b) in enumerate(zip(rec_a.solves, rec_b.solves)):
        flip = ((a["rho_clip"] != b["rho_clip"])
                | (a["polish_active"] != b["polish_active"]).any(1)
                | (a["polish_kept"] != b["polish_kept"]))
        first = torch.where(flip & (first == never),
                            torch.full_like(first, j), first)
    return first


def check_solve_kernels(results):
    """Rows 1-3 against their plain versions at full width and small size,
    cold and warm, and row 2 against row 1 on the same problem."""
    for size, b, h, sd, nb, kw in SIZES:
        for warm in (False, True):
            args = chain_problem(b, h, sd, nb, SEED + 7, warm)
            solve_kw = {k: v for k, v in kw.items() if k != "alpha"}
            cases = {
                "fused_solve_chain": (fused_qp.fused_solve_chain_batch,
                                      fused_qp.fused_solve_chain_batch_reference,
                                      args, kw),
                "fused_solve": (fused_qp.fused_solve_batch,
                                fused_qp.fused_solve_batch_reference,
                                dense_problem(args, kw["alpha"]), solve_kw),
                "scaled_solve": (admm_kernel.solve_scaled_batch,
                                 admm_kernel.solve_scaled_batch_reference,
                                 scaled_problem(args, kw),
                                 dict(iters=ACCURATE.iters,
                                      sigma=ACCURATE.sigma,
                                      relax=ACCURATE.relax))}
            outs = {}
            for name, (kernel, plain, inputs, ckw) in cases.items():
                got = kernel(*inputs, **ckw)
                torch.cuda.synchronize()
                want = plain(*inputs, **ckw)
                outs[name] = got
                if name == "scaled_solve":
                    errs, rel = rel_errs(got, want, ("x", "z", "y"))
                    ok = (all(rel[k] < LIMITS[k] for k in rel)
                          and all(bool(torch.isfinite(g).all()) for g in got))
                else:
                    errs, ok = compare_outputs(got, want)
                results[name]["max_abs_err"] = max(
                    results[name]["max_abs_err"], worst_abs(errs))
                check(ok, f"kernel_check {name} {size} warm={warm}")
                emit({"kernel_check": {"kernel": name, "size": size,
                                       "batch": b, "n": nb * 3, "m": nb * 5,
                                       "warm_start": warm, "ok": ok,
                                       "errors": errs}})
            # row 2 on P = hessian_from_chain(s) against row 1 on s: the
            # same solve, so a wrong P layout shows here
            errs, ok = compare_outputs(outs["fused_solve"],
                                       outs["fused_solve_chain"])
            check(ok, f"kernel_check fused_solve vs chain {size} warm={warm}")
            emit({"kernel_check": {"kernel": "fused_solve vs fused_solve_chain",
                                   "size": size, "batch": b, "warm_start": warm,
                                   "ok": ok, "errors": errs}})
    emit({"limits": LIMITS})


def check_inverse_accuracy():
    """Row 4's kgj stage at full width with q = 0, so that it returns row 0
    of the kernel's K^-1, against row 0 of a float64 torch.linalg.inv of the
    same K formed by the plain phases (mask, 3 Ruiz passes, K assembly);
    error over max |K^-1|, within PHASE_LIMITS["kgj"]."""
    _, b, nb, _ = PHASE_SIZES[0]
    p, q, c = phase_problem(b, nb, SEED + 3)
    zero = torch.zeros_like(q)
    got = phase_probe.stripped_solve("kgj", p, zero, c)
    torch.cuda.synchronize()
    k, q_s = fused_qp._mask_reference(p, zero, torch.ones_like(q))
    k, q_s, cs, _, _, _ = fused_qp._ruiz_reference(k, q_s, c,
                                                   phase_probe.RUIZ_ITERS)
    rho = torch.full((b, 5 * nb), phase_probe.RHO, device=DEV)
    k = fused_qp._assemble_k_reference(k, cs, rho, phase_probe.SIGMA)
    inv = torch.linalg.inv(k.double())
    err = float((got.double() - inv[:, 0, :]).abs().max())
    rel = err / float(inv.abs().max())
    ok = check(rel <= PHASE_LIMITS["kgj"] and bool(torch.isfinite(got).all()),
               "kgj K^-1 against float64 inverse")
    emit({"inverse_accuracy": {
        "stage": "kgj", "batch": b, "n": 3 * nb, "max_abs": err,
        "rel_to_max_kinv": rel, "limit": PHASE_LIMITS["kgj"], "ok": ok,
        "reference": "row 0 of torch.linalg.inv(K.double())"}})


# (row key, kernel in the ptxas log, its blocks-an-SM entry, full-width sizes)
SOLVE_BUILDS = [
    ("fused_solve_chain", "fused_solve_chain_kernel",
     "rlmpc_fused_chain_blocks_per_sm", (120, 200, 40, 10, 13)),
    ("fused_solve", "fused_solve_kernel", "rlmpc_fused_solve_blocks_per_sm",
     (120, 200, 40)),
    ("scaled_solve", "scaled_solve_kernel", "rlmpc_scaled_solve_blocks_per_sm",
     (120, 200, 40)),
    ("stripped_solve", "stripped_solve_kernel",
     "rlmpc_stripped_solve_blocks_per_sm", (120, 200, 40)),
]


def c_entry(lib, name, nargs):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int] * nargs
    fn.restype = ctypes.c_int
    return fn


def check_solve_builds(ptxas):
    """Rows 1-4: the ptxas line shows no spill, and two blocks fit an SM;
    and every entry's dynamic shared memory a block at full width."""
    lib = _build.load_library()
    qp_bytes = c_entry(lib, "rlmpc_qp_shared_bytes", 3)(120, 200, 40)
    shared = {
        "fused_solve_chain": c_entry(lib, "rlmpc_fused_chain_shared_bytes", 5)(
            120, 200, 40, 10, 13),
        "fused_solve": qp_bytes, "scaled_solve": qp_bytes,
        "stripped_solve": qp_bytes,
        "bm_dma": c_entry(lib, "rlmpc_bm_dma_shared_bytes", 2)(120, 128)}
    for key, kernel, entry, sizes in SOLVE_BUILDS:
        line = ptxas.get(kernel, "")
        blocks = c_entry(lib, entry, len(sizes))(*sizes)
        ok = (check("registers" in line, f"{key} ptxas line missing")
              & check("registers" in line and spill_bytes(line) == 0,
                      f"{key} spills registers")
              & check(blocks >= 2, f"{key}: fewer than 2 blocks an SM"))
        emit({"solve_build": {"kernel": key, "ptxas": line,
                              "spill_bytes": spill_bytes(line),
                              "blocks_per_sm": blocks,
                              "shared_bytes_per_block": shared[key],
                              "ok": bool(ok)}})
    emit({"shared_bytes_per_block": shared})


def check_phase_kernels(results):
    """Rows 4 and 5 against their plain versions at full width and small
    size."""
    for size, b, nb, np_ in PHASE_SIZES:
        p, q, c = phase_problem(b, nb, SEED + 3)
        kinv_scale = float(phase_probe.stripped_solve_reference(
            "kgj", p, torch.zeros_like(q), c).abs().max())
        errs, ok_all = {}, True
        for stage in phase_probe.STAGES:
            got = phase_probe.stripped_solve(stage, p, q, c)
            torch.cuda.synchronize()
            want = phase_probe.stripped_solve_reference(stage, p, q, c)
            err = float((got - want).abs().max())
            if stage in ("dma", "mask"):
                rel = err
            elif stage == "ruiz":
                rel = err / float(want.abs().max())
            elif stage == "kgj":
                rel = err / kinv_scale
            else:
                rel = err / max(1.0, float(want.abs().max()))
            ok = (rel <= PHASE_LIMITS[stage]
                  and bool(torch.isfinite(got).all()))
            errs[stage] = {"max_abs": err, "rel": rel, "ok": ok}
            ok_all &= check(ok, f"phase_check {stage} {size}")
            results["stripped_solve"]["max_abs_err"] = max(
                results["stripped_solve"]["max_abs_err"], err)
        n = 3 * nb
        p_pad = torch.nn.functional.pad(p, (0, np_ - n)).contiguous()
        for tr in (False, True):
            got = phase_probe.bm_dma(p_pad, q, tr)
            torch.cuda.synchronize()
            err = float((got - phase_probe.bm_dma_reference(p_pad, q, tr)
                         ).abs().max())
            ok = err == 0.0
            errs[f"bm_dma_transpose={tr}"] = {"max_abs": err, "ok": ok}
            ok_all &= check(ok, f"phase_check bm_dma transpose={tr} {size}")
            results["bm_dma"]["max_abs_err"] = max(
                results["bm_dma"]["max_abs_err"], err)
        emit({"phase_check": {"size": size, "batch": b, "n": n,
                              "ok": bool(ok_all), "errors": errs,
                              "limits": PHASE_LIMITS}})
    # tiles that are not whole 16-byte bulk copies raise and launch nothing
    p_pad = torch.zeros(2, 12, 16, device=DEV)
    tiles = {"misaligned": torch.zeros(1 + p_pad.numel(), device=DEV)[1:]
             .view(p_pad.shape),
             "n*np odd": torch.zeros(2, 3, 3, device=DEV)}
    refused = {}
    for what, tile in tiles.items():
        before = phase_probe.launch_count("bm_dma")
        try:
            phase_probe.bm_dma(tile, torch.zeros(tile.shape[:2], device=DEV))
            refused[what] = False
        except ValueError:
            refused[what] = phase_probe.launch_count("bm_dma") == before
        check(refused[what], f"bm_dma takes a {what} tile")
    emit({"bm_dma_refuses": refused})


def time_kernels(results):
    """Each kernel and its plain version (and a library call where one
    computes the same function) at the main path's shapes, batch 4096, on
    the same inputs; the bound from the same shapes."""
    n, m, nb = 120, 200, 40
    args = chain_problem(BATCH, 10, 13, 40, SEED + 11, True)
    solve_kw = {k: v for k, v in SOLVE_KW.items() if k != "alpha"}
    dense = dense_problem(args, SOLVE_KW["alpha"])
    scaled = scaled_problem(args, dict(SOLVE_KW, ruiz_iters=ACCURATE.ruiz_iters))
    scaled_kw = dict(iters=ACCURATE.iters, sigma=ACCURATE.sigma,
                     relax=ACCURATE.relax)
    p, q, c = phase_problem(BATCH, nb, SEED + 5)
    p_pad = torch.nn.functional.pad(p, (0, 128 - n)).contiguous()
    q_pad = q.contiguous()
    cases = {
        "fused_solve_chain": (
            lambda: fused_qp.fused_solve_chain_batch(*args, **SOLVE_KW),
            lambda: fused_qp.fused_solve_chain_batch_reference(*args,
                                                               **SOLVE_KW),
            None, chain_bound(BATCH, n, m, nb, 10, 13, PROD.iters,
                              PROD.ruiz_iters)),
        "fused_solve": (
            lambda: fused_qp.fused_solve_batch(*dense, **solve_kw),
            lambda: fused_qp.fused_solve_batch_reference(*dense, **solve_kw),
            None, p_bound(BATCH, n, m, nb, PROD.iters, PROD.ruiz_iters)),
        "scaled_solve": (
            lambda: admm_kernel.solve_scaled_batch(*scaled, **scaled_kw),
            lambda: admm_kernel.solve_scaled_batch_reference(*scaled,
                                                             **scaled_kw),
            None, scaled_bound(BATCH, n, m, nb, ACCURATE.iters)),
        "stripped_solve": (
            lambda: phase_probe.stripped_solve("admm50", p, q, c),
            lambda: phase_probe.stripped_solve_reference("admm50", p, q, c),
            None, stripped_bound(BATCH, n, m, nb)),
        "bm_dma": (
            lambda: phase_probe.bm_dma(p_pad, q_pad),
            lambda: phase_probe.bm_dma_reference(p_pad, q_pad),
            lambda: torch.add(q_pad, p_pad[:, :, 0]),
            tile_bound(BATCH, n)),
    }
    for name, (kernel, plain, library, bnd) in cases.items():
        r = results[name]
        r["ms"] = time_ms(kernel, 10)
        r["plain_ms"] = time_ms(plain, 3)
        r["library_ms"] = time_ms(library, 10) if library else None
        r["bound_ms"], r["bound_by"] = bnd["bound_ms"], bnd["bound_by"]
        line = {"kernel": name, "batch": BATCH, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "bound": bnd, "share_of_bound": bnd["bound_ms"] / r["ms"]}
        if name == "bm_dma":
            # what the kernel does beyond its function: the whole padded
            # tile (and q, the result) through, as a share of the memory rate
            tile_bytes = 4 * BATCH * (n * 128 + 2 * n)
            line["tile_load"] = {
                "bytes": tile_bytes,
                "bytes_per_s": tile_bytes / (r["ms"] * 1e-3),
                "share_of_memory_rate": tile_bytes / (r["ms"] * 1e-3)
                / PEAK_HBM_BYTES_PER_S}
        emit({"kernel_time": line})
    # where row 1's time goes, from run-time counts alone
    no_admm = time_ms(lambda: fused_qp.fused_solve_chain_batch(
        *args, **dict(SOLVE_KW, iters=0)), 10)
    no_admm_no_ruiz = time_ms(lambda: fused_qp.fused_solve_chain_batch(
        *args, **dict(SOLVE_KW, iters=0, ruiz_iters=0)), 10)
    emit({"kernel_split": {
        "kernel": "fused_solve_chain",
        "admm_24_steps_ms": results["fused_solve_chain"]["ms"] - no_admm,
        "ruiz_2_passes_ms": no_admm - no_admm_no_ruiz,
        "build_mask_assemble_invert_residuals_unscale_ms": no_admm_no_ruiz}})
    kernel_masks(args)
    # no single PyTorch call computes a whole solve; the factor phase
    # alone, as a batched library inverse of a matrix of the same shape
    emit({"factor_phase_library": {
        "call": "torch.linalg.inv on (4096,120,120) float32",
        "ms": time_ms(lambda: torch.linalg.inv(dense[0]), 3),
        "note": "the factor phase only, not a kernel's function"}})


# legs in stance at each of the 10 horizon steps: a trot (two legs, n_s = 60
# of 120 variables) and all four legs down (n_s = 120)
GAIT_TABLES = {"trot": ((1, 0, 0, 1),) * 5 + ((0, 1, 1, 0),) * 5,
               "stance": ((1, 1, 1, 1),) * 10}


def kernel_masks(args):
    """Row 1 at batch 4096 under a gait's contact table (swing foot-steps
    masked, their bounds 0): the trot takes the compact path in every robot,
    all legs down the dense one; each launch's count of compact solves from
    the card."""
    out = {}
    for name, table in GAIT_TABLES.items():
        active = torch.tensor(table, dtype=torch.float32, device=DEV
                              ).reshape(1, -1).expand(BATCH, -1)
        gait = list(args)
        gait[4] = args[4] * active.repeat_interleave(5, dim=1)
        gait[5] = args[5] * active.repeat_interleave(5, dim=1)
        gait[6] = active.repeat_interleave(3, dim=1).contiguous()
        fused_qp.reset_compact_count()
        fused_qp.fused_solve_chain_batch(*gait, **SOLVE_KW)
        count = fused_qp.compact_count()
        check(count == (BATCH if name == "trot" else 0),
              f"row 1 {name}: {count} compact solves of {BATCH}")
        out[name] = {"ms": time_ms(lambda: fused_qp.fused_solve_chain_batch(
            *gait, **SOLVE_KW), 10), "compact_solves": count}
    emit({"kernel_masks": {"kernel": "fused_solve_chain", "batch": BATCH,
                           **out}})


ASSEMBLY_BATCHES = (BATCH, 262144)   # the chip_smoke size, the fleet cell's
ASSEMBLY_LIMIT = 1e-5   # s_chain, q: of the robot's largest |value|


def assembly_inputs(b, seed):
    """The MPC assembly's 13 inputs for b robots on the card, from a seeded
    generator: roll / pitch +-0.3, any yaw, rates +-1, CoM 0.28-0.40 m, feet
    about Aliengo's hips, commands over the env's ranges, a trot's contact
    table at each robot's phase, flat ground, Aliengo's shared parameters."""
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=DEV)

    params = robots.aliengo_params(DEV)
    rpy = torch.stack([u(-0.3, 0.3, b), u(-0.3, 0.3, b),
                       u(-math.pi, math.pi, b)], dim=-1)
    feet = (hip_locations(params.abad_location) + u(-0.05, 0.05, b, 4, 3)
            + torch.tensor([0.0, 0.0, -0.33], device=DEV))
    commands = torch.stack([u(-2.5, 2.5, b), u(-1.0, 1.0, b),
                            u(-2.5, 2.5, b)], dim=-1)
    offsets, durations = gait.gait_params(0, DEV)
    phase = torch.randint(0, 10, (b,), generator=gen, device=DEV).float()
    table = gait.mpc_table(phase, offsets, durations)
    normal = torch.tensor([0.0, 0.0, 1.0], device=DEV)
    return [rpy, u(0.28, 0.40, b), u(-1, 1, b, 3), u(-1, 1, b, 3),
            feet.contiguous(), table, params.mpc_weights, commands, normal,
            params.body_mass, params.body_inertia, params.body_height,
            params.friction_coeff]


def robot_rel(got, want):
    """Largest |got - want| a robot over the robot's largest |want|."""
    b = want.shape[0]
    err = (got.double() - want.double()).abs().reshape(b, -1).amax(1)
    scale = want.double().abs().reshape(b, -1).amax(1).clamp_min(1e-30)
    return float((err / scale).max())


def mpc_assembly_path(results, ptxas):
    """The MPC assembly kernel against its plain version and timed beside
    it, at 4096 and 262144 robots; its ptxas line must show no spill."""
    line = ptxas.get("mpc_assembly_kernel", "")
    ok = check("registers" in line and spill_bytes(line) == 0,
               "mpc_assembly ptxas line missing or spills")
    kw = dict(dt_mpc=ControlConfig().dt_mpc, horizon=10)
    names = ("s_chain", "q", "lb", "ub", "mask")
    out = {}
    for b in ASSEMBLY_BATCHES:
        args = assembly_inputs(b, SEED + 17)
        got = mpc_assembly.assemble_mpc_batch(*args, **kw)
        want = mpc_assembly.assemble_mpc_batch_reference(*args, **kw)
        errs = {n: robot_rel(g, w) for n, g, w in zip(names, got, want)}
        results["mpc_assembly"]["max_abs_err"] = max(
            results["mpc_assembly"]["max_abs_err"],
            *[float((g - w).abs().max()) for g, w in zip(got, want)])
        exact = {n: bool(torch.equal(g, w))
                 for n, g, w in zip(names[2:], got[2:], want[2:])}
        case_ok = (errs["s_chain"] < ASSEMBLY_LIMIT
                   and errs["q"] < ASSEMBLY_LIMIT and all(exact.values())
                   and all(bool(torch.isfinite(g).all()) for g in got))
        if b == BATCH:
            want64 = mpc_assembly.assemble_mpc_batch_reference(
                *[a.double() for a in args], **kw)
            errs["s_chain_vs_float64"] = robot_rel(got[0], want64[0])
            errs["q_vs_float64"] = robot_rel(got[1], want64[1])
            errs["plain_s_chain_vs_float64"] = robot_rel(want[0], want64[0])
            errs["plain_q_vs_float64"] = robot_rel(want[1], want64[1])
            case_ok &= (errs["s_chain_vs_float64"] < ASSEMBLY_LIMIT
                        and errs["q_vs_float64"] < ASSEMBLY_LIMIT)
        ok &= check(case_ok, f"mpc_assembly at {b} robots against its plain "
                             f"version")
        ms = time_ms(lambda: mpc_assembly.assemble_mpc_batch(*args, **kw), 20)
        plain_ms = time_ms(
            lambda: mpc_assembly.assemble_mpc_batch_reference(*args, **kw), 3)
        # a robot reads its state, feet, commands and contact table and
        # writes s_chain, q, lb, ub and mask; ~8000 operations (the closed
        # forms, the running sums, s[k] = S0 + k S1)
        bnd = bound(b, 3 + 1 + 3 + 3 + 12 + 3 + 4 * 10,
                    (156 + 12 + 20 + 20 + 12) * 10, 8000)
        out[str(b)] = {"ms": ms, "plain_ms": plain_ms, "bound": bnd,
                       "share_of_bound": bnd["bound_ms"] / ms,
                       "errors": errs, "exact": exact, "ok": bool(case_ok)}
        del args, got, want
        torch.cuda.empty_cache()
    r = results["mpc_assembly"]
    big = out[str(ASSEMBLY_BATCHES[-1])]
    r["ms"], r["plain_ms"], r["library_ms"] = big["ms"], big["plain_ms"], None
    r["bound_ms"] = big["bound"]["bound_ms"]
    r["bound_by"] = big["bound"]["bound_by"]
    emit({"mpc_assembly": {"ptxas": line, "spill_bytes": spill_bytes(line),
                           "batches": out, "ok": bool(ok)}})
    mpc_assembly.reset_launch_count()


def main_path(results, params, commands, stream):
    """The production tick: kernel against plain version and against the
    plain pipeline over 12 ticks, then the counted run (bench + 100
    ticks)."""
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
    assembled = mpc_assembly.launch_count()
    p_taus, _ = run_ticks(stream, PROD._replace(use_kernel=False), 12, params,
                          commands)
    check(mpc_assembly.launch_count() == assembled,
          "use_kernel=False launched the assembly kernel")
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

    # the counted run
    reset_counts()
    timing = bench_mod.bench(batch=BATCH, iters=BENCH_PERIODS,
                             warmup=BENCH_WARMUP)
    bench_d = timing["detail"]
    bench_launches = fused_qp.launch_count("fused_solve_chain")
    taus, mets = run_ticks(stream, PROD, CHECK_TICKS, params, commands)
    launches = fused_qp.launch_count("fused_solve_chain")
    assembly = mpc_assembly.launch_count()
    others = (fused_qp.launch_count("fused_solve") + admm_kernel.launch_count()
              + phase_probe.launch_count())
    results["fused_solve_chain"]["launches"] = launches

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
               & check(assembly == solve_ticks,
                       "assembly launch count != solve ticks")
               & check(bench_launches == BENCH_PERIODS + BENCH_WARMUP,
                       "bench launch count")
               & check(others == 0, "main path launched another kernel")
               & check(finite and bench_d["torques_finite"], "torques finite")
               & check(swing_zero, "swing-leg forces zero")
               & check(diverged < 0.05, "qp_diverged fraction < 5%")
               & check(tuple(taus[-1].shape) == (BATCH, 12), "torque shape"))
    emit({"main_path": {
        "robot": "Aliengo", "batch": BATCH, "gait": "trot",
        "qp": PROD._asdict(), "ok": bool(ok_main),
        "timed_periods": bench_d["periods"],
        "mpc_period_ms": bench_d["mpc_period_ms"],
        "mpc_period_ms_max": bench_d["period_max_ms"],
        "mpc_period_ms_mean": bench_d["period_mean_ms"],
        "period_p99_ms": bench_d["period_p99_ms"],
        "stall_periods": bench_d["stall_periods"],
        "physical_floor_ms": bench_d["physical_floor_ms"],
        "host_loop_period_ms": bench_d["host_loop_period_ms"],
        "solves_per_s": timing["value"],
        "window_solves_per_s": bench_d["window_solves_per_s"],
        "kernel_share_of_period": (results["fused_solve_chain"]["ms"]
                                   / bench_d["mpc_period_ms"]),
        "checked_ticks": CHECK_TICKS, "kernel_launches": launches,
        "assembly_launches": assembly, "solve_ticks": solve_ticks, "torques_finite": finite,
        "swing_forces_exactly_zero_first_cycle": swing_exact_first_cycle,
        "swing_force_abs_max_newton": swing_abs_max,
        "qp_diverged_frac": diverged,
        "qp_diverged_frac_bench_last_tick": bench_d["qp_diverged_frac"],
        "torque_abs_max": float(torch.stack(taus).abs().max())}})


def accurate_path(results, params, commands, stream):
    """The accurate configuration of the tick (use_kernel=True: adaptive rho
    restart, polish): the scaled-solve kernel twice a solve, against the
    same run with use_kernel=False (Cholesky in place of the kernel). Every
    kernel launch is held against its plain version on the same inputs. A
    robot whose torques part beyond the limit must have taken another
    discrete branch (rho clip, polish active set or polish kept) at or
    before that tick; it is counted, and any other fails the check, as do
    more than FLIP_LIMIT of the robots taking another branch."""
    solve_ticks = ACCURATE_TICKS // 2
    reset_counts()
    with BranchRecorder() as rec_k, ScaledSolveCheck() as kernel_check:
        k_taus, k_mets = run_ticks(stream, ACCURATE, ACCURATE_TICKS, params,
                                   commands)
    launches = admm_kernel.launch_count()
    assembly = mpc_assembly.launch_count()
    others = fused_qp.launch_count() + phase_probe.launch_count()
    results["scaled_solve"]["launches"] = launches
    results["scaled_solve"]["max_abs_err"] = max(
        results["scaled_solve"]["max_abs_err"], kernel_check.max_abs)
    with BranchRecorder() as rec_p:
        p_taus, _ = run_ticks(stream, ACCURATE._replace(use_kernel=False),
                              ACCURATE_TICKS, params, commands)
    check(admm_kernel.launch_count() == launches
          and mpc_assembly.launch_count() == assembly,
          "use_kernel=False launched the scaled-solve or assembly kernel")
    first = first_flip(rec_k, rec_p, BATCH)      # index of the solve
    outside = torch.zeros(BATCH, dtype=torch.bool, device=DEV)
    unexplained = torch.zeros_like(outside)
    per_tick = []
    for t, (a, b) in enumerate(zip(k_taus, p_taus)):
        rel = row_rel(a, b)
        bad = rel >= TORQUE_LIMIT
        solves_so_far = (t + 1) // 2     # solve ticks are 1, 3, 5, ...
        outside |= bad
        unexplained |= bad & (first >= solves_so_far)
        per_tick.append(float(rel.max()))
    finite = all(bool(torch.isfinite(t).all()) for t in k_taus)
    n_out, n_unexp = int(outside.sum()), int(unexplained.sum())
    flipped = int((first < solve_ticks).sum())
    ok = (check(launches == 2 * solve_ticks,
                "accurate path: scaled-solve launches != 2 x solve ticks")
          & check(assembly == solve_ticks,
                  "accurate path: assembly launches != solve ticks")
          & check(others == 0, "accurate path launched another kernel")
          & check(finite, "accurate path torques finite")
          & check(n_unexp == 0, "accurate path: unexplained torque difference")
          & check(kernel_check.ok, "accurate path: scaled-solve kernel against "
                  "its plain version on the path's inputs")
          & check(flipped <= FLIP_LIMIT * BATCH,
                  "accurate path: too many robots took another branch"))
    within = torch.stack([row_rel(a, b) for a, b in zip(k_taus, p_taus)]
                         ).amax(dim=0)
    emit({"accurate_path": {
        "qp": ACCURATE._asdict(), "batch": BATCH, "ticks": ACCURATE_TICKS,
        "solve_ticks": solve_ticks, "kernel_launches": launches,
        "assembly_launches": assembly,
        "ok": bool(ok), "limit_rel": TORQUE_LIMIT,
        "robots_outside_limit": n_out,
        "robots_outside_limit_unexplained": n_unexp,
        "robots_with_a_flipped_branch": flipped,
        "flipped_limit": FLIP_LIMIT * BATCH,
        "kernel_vs_plain_version_on_path_inputs": {
            "calls": len(kernel_check.errs["first"])
            + len(kernel_check.errs["restart"]),
            "first_solve_max_rel": kernel_check.worst("first"),
            "restart_max_rel": kernel_check.worst("restart"),
            "limits": {k: LIMITS[k] for k in ("x", "z", "y")}},
        "vs_float64": {
            "reference": "solve_scaled_batch_reference on the same inputs "
                         "in float64, the same step count",
            "first": kernel_check.vs_float64("first"),
            "restart": kernel_check.vs_float64("restart")},
        "reason": "a robot outside the limit took another discrete branch "
                  "than the use_kernel=False run at or before that tick: "
                  "rho rescale clip, polish active set (|y| > active_tol) or "
                  "polish kept; the two runs differ otherwise only in how "
                  "K^-1 is formed (Gauss-Jordan in the kernel, Cholesky)",
        "max_rel_per_tick": per_tick,
        "max_rel_robots_without_flip": float(
            within[first >= solve_ticks].max()) if flipped < BATCH else None,
        "qp_diverged_frac_last_solve": float(
            k_mets[ACCURATE_TICKS - 1]["qp_diverged"].float().mean())}})
    # the period of the accurate tick
    reset_counts()
    timing = bench_mod.bench(batch=BATCH, iters=ACCURATE_PERIODS, warmup=2,
                             qp_cfg=ACCURATE)
    d = timing["detail"]
    ok_b = check(d["kernel_launches"] == 2 * ACCURATE_PERIODS
                 and d["torques_finite"], "accurate bench")
    emit({"accurate_bench": {
        "ok": ok_b, "periods": d["periods"],
        "kernel_launches": d["kernel_launches"],
        "mpc_period_ms": d["mpc_period_ms"],
        "mpc_period_ms_mean": d["period_mean_ms"],
        "solves_per_s": timing["value"],
        "qp_diverged_frac": d["qp_diverged_frac"]}})


def prebuilt_p_path(results, params):
    """Row 2's path: qp.solve_qp (fused-eligible production config) on the
    dense MPC QP of the profiler's prep at batch 4096, checked against the
    plain pipeline, then ``profile qp-phases``."""
    reset_counts()
    _, inputs = qp_profile._prep_inputs(BATCH, DEV)
    p, q, lb, ub, mask = qp_profile.dense_qp_batch(params, *inputs)
    c = srb.friction_cone_block(params.friction_coeff).to(DEV).reshape(
        1, 1, 5, 3).repeat(BATCH, 40, 1, 1)
    st = tqp.init_qp_state(120, 200, BATCH, DEV)
    x_k, st_k, diag = tqp.solve_qp(p, q, c, lb, ub, st, PROD, mask=mask)
    x_p, _, _ = tqp.solve_qp(p, q, c, lb, ub, st, PROD._replace(
        use_kernel=False), mask=mask)
    torch.cuda.synchronize()
    # a cold first solve: the two residual definitions part only in the
    # rho_mult handed on, so x is comparable; 2e-3 of max(1, |x|), the CPU
    # tests' limit between the kernel's plain version and the pipeline
    rel = float(row_rel(x_k, x_p).max())
    ok = check(rel < 2e-3 and bool(torch.isfinite(x_k).all()),
               "solve_qp fused vs use_kernel=False")
    prof = qp_profile.run_qp_phases(batch=BATCH)
    launches = fused_qp.launch_count("fused_solve")
    others = (fused_qp.launch_count("fused_solve_chain")
              + admm_kernel.launch_count() + phase_probe.launch_count())
    results["fused_solve"]["launches"] = launches
    check(launches >= 1 and others == 0, "prebuilt-P path launches")
    emit({"prebuilt_p_path": {"ok": ok, "batch": BATCH,
                              "x_vs_use_kernel_false_max_rel": rel,
                              "primal_violation_max": float(
                                  diag["primal_violation"].max()),
                              "kernel_launches": launches}})
    emit({"profile": {"cmd": "qp-phases", **prof}})


def profiler_paths(results):
    """The profiler's other subcommands at batch 4096, one line each; rows 4
    and 5 are counted over ``kernel-phases``."""
    reset_counts()
    prof = qp_profile.run_kernel(mode="fresh", batch=BATCH)
    emit({"profile": {"cmd": "kernel", **prof,
                      "scaled_solve_launches": admm_kernel.launch_count()}})
    reset_counts()
    prof = qp_profile.run_kernel(mode="iter0", batch=BATCH)
    emit({"profile": {"cmd": "kernel", **prof}})
    reset_counts()
    prof = qp_profile.run_kernel_phases(batch=BATCH)
    results["stripped_solve"]["launches"] = phase_probe.launch_count(
        "stripped_solve")
    results["bm_dma"]["launches"] = phase_probe.launch_count("bm_dma")
    others = fused_qp.launch_count() + admm_kernel.launch_count()
    check(results["stripped_solve"]["launches"] > 0
          and results["bm_dma"]["launches"] > 0 and others == 0,
          "kernel-phases launches")
    emit({"profile": {"cmd": "kernel-phases", **prof}})
    emit({"profile": {"cmd": "inverse",
                      **qp_profile.run_inverse(batch=BATCH)}})


# ---- the benchmark harness and the mesh ----------------------------------------

SWEEP_BATCHES, SWEEP_PERIODS, SWEEP_WARMUP = (512, 4096), 40, 3
KNOB_REPS, PERIOD_REPS = 10, 10
# the warm-up periods of bench.median_period_ms and bench.bench (defaults)
PERIOD_WARMUP, BENCH_DEFAULT_WARMUP = 3, 5
SMOKE_ENVS = 512


def bench_paths(results):
    """bench.py's other entries on the card, each counted: a two-batch
    ``sweep`` (every row above its physical floor, none failed), one
    ``bench_train`` iteration at 512 envs on rough ground with DR (row 1
    once a solve tick), ``profile period --iters-sweep 10 --ruiz-sweep 0``
    and ``profile qp-knobs norho``."""
    t0 = time.perf_counter()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke", "SWEEP_smoke.json")
    counts, ok = {}, True

    def counted(name, fn):
        reset_counts()
        value = fn()
        counts[name], others = row1_launches()
        results["fused_solve_chain"]["launches"] += counts[name]
        check(others == 0, f"bench_paths {name} launched another kernel")
        return value

    with contextlib.redirect_stdout(io.StringIO()):   # its rows: below
        sw = counted("sweep", lambda: bench_mod.sweep(
            batches=SWEEP_BATCHES, iters=SWEEP_PERIODS, warmup=SWEEP_WARMUP,
            out=out))
    per_batch = SWEEP_PERIODS + SWEEP_WARMUP
    ok &= check(not sw["failed"] and len(sw["rows"]) == len(SWEEP_BATCHES)
                and all(r["period_ms"] > r["physical_floor_ms"]
                        and r["p99_ms"] >= r["p50_ms"] and r["torques_finite"]
                        and r["kernel_launches"] == SWEEP_PERIODS
                        for r in sw["rows"])
                and counts["sweep"] == per_batch * len(SWEEP_BATCHES),
                "bench_paths: sweep rows")
    tr = counted("bench_train", lambda: bench_mod.bench_train(
        num_envs=SMOKE_ENVS, warmup=0, iters=1))
    td = tr["detail"]
    ok &= check(counts["bench_train"] == td["solve_ticks_per_iteration"]
                == td["row1_launches_per_iteration"] == 12
                and td["metrics_finite"] and tr["value"] > 0,
                "bench_paths: bench_train launches != solve ticks")
    period = counted("period", lambda: qp_profile.run_period(
        batch=BATCH, reps=PERIOD_REPS, iters_sweep=(10,), ruiz_sweep=(0,)))
    ok &= check(counts["period"] == 3 * (PERIOD_REPS + PERIOD_WARMUP)
                and 0 < period["no_solve_x2"] and period["iters10"] > 0,
                "bench_paths: profile period")
    knobs = counted("qp_knobs", lambda: qp_profile.run_qp_knobs(
        batch=BATCH, reps=KNOB_REPS, variants=["norho"]))
    ok &= check(counts["qp_knobs"] == KNOB_REPS + BENCH_DEFAULT_WARMUP
                and knobs["norho"] > 0,
                "bench_paths: profile qp-knobs")
    emit({"bench_paths": {
        "ok": bool(ok), "row1_launches": counts,
        "sweep": {k: sw[k] for k in ("largest_realtime_batch", "rows",
                                     "failed", "periods_per_row")},
        "bench_train": {"env_steps_per_s": tr["value"], **{
            k: td[k] for k in ("num_envs", "ppo_iteration_ms", "terrain",
                               "dr", "row1_launches_per_iteration")}},
        "profile_period": period, "profile_qp_knobs": knobs,
        "seconds": time.perf_counter() - t0}})


def parallel_path(results):
    """A one-rank NCCL group and the env mesh over it: one
    ``make_train_step(mesh=...)`` iteration at 512 Aliengo envs (flat
    ground, production QP) against the same iteration with ``mesh=None``
    from the same seeds; the parameters, lr and metrics must be equal."""
    t0 = time.perf_counter()
    cfg = train_config(SMOKE_ENVS)
    ter = terrain.flat(device=DEV)

    def one_iteration(mesh):
        model = ActorCritic(env.NUM_ACTIONS).to(DEV)
        ts = ppo.init_train_state(seeding.key(SEED, DEV), model, env.NUM_OBS,
                                  cfg.ppo)
        gen = seeding.key(SEED, DEV, stream=1)
        step_fn, reset_fn = train_mod.make_train_step(
            robots.aliengo_params(DEV), cfg, ter, model, mesh)
        es, obs = reset_fn(gen)
        ts, es, obs, _, metrics = step_fn(ts, es, obs, 0, gen)
        return model.state_dict(), ts.lr, metrics

    reset_counts()
    want = one_iteration(None)
    mesh = mesh_mod.make_mesh()
    try:
        backend = torch.distributed.get_backend()
        got = one_iteration(mesh)
        torch.cuda.synchronize()
    finally:
        distributed.shutdown()
    launches, others = row1_launches()
    results["fused_solve_chain"]["launches"] += launches
    diff = max(float((got[0][k] - want[0][k]).abs().max()) for k in want[0])
    equal = (all(torch.equal(got[0][k], want[0][k]) for k in want[0])
             and torch.equal(got[1], want[1])
             and all(torch.equal(got[2][k], want[2][k]) for k in want[2]))
    ok = (check(equal, "parallel_path: mesh of one rank != no mesh")
          & check(launches == 24 and others == 0,
                  "parallel_path: row-1 launches != 2 x 12")
          & check(backend == "nccl" and mesh.size() == 1,
                  "parallel_path: not a one-rank NCCL mesh"))
    emit({"parallel_path": {
        "ok": bool(ok), "backend": backend, "world_size": mesh.size(),
        "num_envs": SMOKE_ENVS, "parameters_equal": equal,
        "parameter_max_abs_diff": diff, "row1_launches": launches,
        "seconds": time.perf_counter() - t0}})


# ---- the closed loop ---------------------------------------------------------

# tests/test_closed_loop.py's cases: (robot id, vx, least x at 3 s)
WALK_CASES = [(robots.ALIENGO, 0.5, 1.0), (robots.GO1, 0.4, 0.5),
              (robots.A1, 0.4, 0.5)]
LOOP_TICKS, ENV_STEPS, FSM_TICKS = 300, 200, 300
Q0 = (0.0, 0.8, -1.6)


class TickClock:
    """CUDA events around each step of a loop: the median step and the
    window from the first event to the last, read after the loop."""

    def __init__(self):
        self.events = []

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def read(self):
        torch.cuda.synchronize()
        per = [a.elapsed_time(b)
               for a, b in zip(self.events[:-1], self.events[1:])]
        return statistics.median(per), self.events[0].elapsed_time(
            self.events[-1])


def row1_launches():
    """(row 1 launches, launches of every other kernel) since the last
    reset_counts(). Each row 1 solve is assembled by the assembly kernel,
    so its launches count as others as far as they differ from row 1's: a
    plain pipeline that launched it, or a row 1 solve that did not, shows
    as others != 0."""
    chain = fused_qp.launch_count("fused_solve_chain")
    return chain, (fused_qp.launch_count() - chain
                   + admm_kernel.launch_count() + phase_probe.launch_count()
                   + mpc_assembly.launch_count() - chain)


def walk(params, cfg, commands, ticks):
    """Min-mode ticks against the physics on flat ground from the standing
    start; per robot the lowest and highest base and the largest tilt, on
    the card. Returns (final PhysState, stats, ms a tick, window ms)."""
    b = commands.shape[0]
    pcfg, ter = physics.PhysicsConfig(), terrain.flat(device=DEV)
    q0 = torch.tensor(Q0, device=DEV).repeat(4)
    ps = physics.init_state(params, q0, params.body_height + 0.03, b, DEV)
    cs = runner.init_state(params, cfg, batch=b, device=DEV)
    z_min = torch.full((b,), float("inf"), device=DEV)
    z_max = torch.full((b,), -float("inf"), device=DEV)
    tilt = torch.zeros(b, device=DEV)
    clock = TickClock()
    for t in range(ticks):
        clock.mark()
        body = physics.root_state_vector(ps)
        cs, tau, _ = runner.min_step(params, cfg, cs, ps.q, ps.qd, body,
                                     commands, solve_gate=t % 2 == 1)
        ps, _, _ = physics.step(params, pcfg, ter, ps, tau)
        z_min = torch.minimum(z_min, ps.pos[:, 2])
        z_max = torch.maximum(z_max, ps.pos[:, 2])
        tilt = torch.maximum(tilt, robot_tilt(ps))
    clock.mark()
    ms, window = clock.read()
    return ps, dict(z_min=z_min, z_max=z_max, tilt=tilt), ms, window


def robot_tilt(ps):
    """Per robot max(|roll|, |pitch|)."""
    return rot.quat_to_rpy(ps.quat)[:, :2].abs().amax(dim=-1)


def walk_limits(ps, stats, ids, body_height):
    """Per robot: within tests/test_closed_loop.py's limits the whole run."""
    h = body_height
    min_x = torch.tensor([c[2] for c in WALK_CASES], device=DEV)[ids.long()]
    finite = torch.isfinite(torch.cat([ps.pos, ps.quat, ps.v, ps.omega,
                                       ps.q, ps.qd], dim=-1)).all(dim=-1)
    return (finite & (stats["z_min"] > 0.65 * h)
            & (stats["z_max"] < 1.35 * h + 0.05) & (stats["tilt"] < 0.4)
            & (ps.pos[:, 0] >= min_x) & (ps.pos[:, 1].abs() < 0.2))


def per_robot(ps, stats, ok, ids):
    """Per robot kind: share within the limits, mean x at the end, mean
    |y|, lowest base and largest tilt."""
    out = {}
    for rid, vx, min_x in WALK_CASES:
        sel = ids == rid
        name = [k for k, v in robots.ROBOT_NAMES.items() if v == rid][0]
        out[name] = {"robots": int(sel.sum()), "vx": vx, "least_x": min_x,
                     "share_within_limits": float(ok[sel].float().mean()),
                     "mean_x_m": float(ps.pos[sel, 0].mean()),
                     "mean_abs_y_m": float(ps.pos[sel, 1].abs().mean()),
                     "min_z_m": float(stats["z_min"][sel].min()),
                     "max_tilt_rad": float(stats["tilt"][sel].max())}
    return out


def closed_loop(results):
    """runner.min_step + physics.step, flat ground, trot, production QP
    config, one heterogeneous batch of 4096 (a third each of Aliengo, Go1,
    A1): every robot within tests/test_closed_loop.py's limits, row 1
    launched once a solve tick and nothing else launched. Then the same
    with use_kernel=False, reported without limits."""
    ids = torch.arange(BATCH, device=DEV) % 3
    params = robots.select_robot(robots.robot_registry(DEV), ids)
    vx = torch.tensor([c[1] for c in WALK_CASES], device=DEV)[ids]
    commands = torch.stack([vx, torch.zeros_like(vx), torch.zeros_like(vx)],
                           dim=-1)
    out = {}
    for name, qp_cfg in (("kernel", PROD),
                         ("use_kernel_false", PROD._replace(use_kernel=False))):
        reset_counts()
        ps, stats, ms, window = walk(params, ControlConfig(qp=qp_cfg),
                                     commands, LOOP_TICKS)
        launches, others = row1_launches()
        ok = walk_limits(ps, stats, ids, params.body_height)
        kinds = per_robot(ps, stats, ok, ids)
        out[name] = {"kernel_launches": launches, "other_launches": others,
                     "ms_per_tick": ms, "window_ms": window,
                     "robot_ticks_per_s": BATCH * LOOP_TICKS / (window * 1e-3),
                     "robots_within_limits": int(ok.sum()), "per_robot": kinds}
        if name == "kernel":
            results["fused_solve_chain"]["launches"] += launches
            passed = (check(bool(ok.all()), "closed_loop: a robot outside "
                            "tests/test_closed_loop.py's limits")
                      & check(launches == LOOP_TICKS // 2,
                              "closed_loop: launches != solve ticks")
                      & check(others == 0, "closed_loop launched another "
                              "kernel"))
        else:
            check(launches == 0 and others == 0,
                  "closed_loop use_kernel=False launched a kernel")
    emit({"closed_loop": {
        "ok": bool(passed), "batch": BATCH, "ticks": LOOP_TICKS,
        "solve_ticks": LOOP_TICKS // 2, "gait": "trot", "terrain": "flat",
        "qp": PROD._asdict(), **out,
        "limits": "z in (0.65 h, 1.35 h + 0.05), |roll|, |pitch| < 0.4, "
                  "x >= 1.0 / 0.5 / 0.5 m, |y| < 0.2 m (kernel run only)"}})


def launches_traced(fn):
    """Device kernels launched by fn() and the device's busy time, from
    torch.profiler (None when the trace holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    rows = [(device_us(ev), ev.count, ev.key) for ev in prof.key_averages()
            if device_us(ev) > 0 and ev.device_type == DeviceType.CUDA]
    if not rows:
        return None
    busy_ms = sum(r[0] for r in rows) / 1e3
    kinds = {}
    for us, count, name in rows:
        kind = kernel_kind(name)
        launches, ms = kinds.get(kind, (0, 0.0))
        kinds[kind] = (launches + count, ms + us / 1e3)
    return {"launches": sum(r[1] for r in rows), "device_busy_ms": busy_ms,
            "traced_wall_ms": wall_ms, "device_busy_share": busy_ms / wall_ms,
            "by_kind": {k: {"launches": n, "device_ms": ms}
                        for k, (n, ms) in sorted(kinds.items())}}


def kernel_kind(name):
    """A coarse class of a device kernel, from its name."""
    low = name.lower()
    if "fused_solve" in low or "scaled_solve" in low:
        return "qp_kernel"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90_", "gemv")):
        return "gemm"
    if "reduce" in low:
        return "reduce"
    if "elementwise" in low or "unrolled" in low:
        return "elementwise"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


ENV_NOISE = randomize.RandomizationSpec(distribution="gaussian",
                                        operation="additive",
                                        range_=(0.0, 0.02),
                                        range_correlated=(0.0, 0.01))


def env_path(results):
    """env.reset + env.step, Aliengo, batch 4096, production QP config,
    episodes of 50 steps, domain randomisation (the default specs, obs and
    action noise, re-drawn every 40 global steps), seeded random actions,
    the solve gate from the step count: 200 steps."""
    params = robots.aliengo_params(DEV)
    dr = randomize.DomainRandomization(
        specs=randomize.DEFAULT_SPECS + (("obs.noise", ENV_NOISE),
                                         ("action.noise", ENV_NOISE)),
        frequency=40)
    cfg = env.EnvConfig(control=ControlConfig(qp=PROD), episode_length=50,
                        dr=dr)
    ter = terrain.flat(device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    act_gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    ipm = cfg.control.iterations_between_mpc

    def actions():
        return 2.0 * torch.rand((BATCH, 12), generator=act_gen,
                                device=DEV) - 1.0

    reset_counts()
    state = env.reset(params, cfg, gen, 0, batch=BATCH, device=DEV)
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    timeout_reset = torch.ones((), dtype=torch.bool, device=DEV)
    n_timeout = torch.zeros((), dtype=torch.int64, device=DEV)
    n_fall = torch.zeros((), dtype=torch.int64, device=DEV)
    clock = TickClock()
    for t in range(ENV_STEPS):
        clock.mark()
        state, obs, rew, done, info = env.step(
            params, cfg, ter, state, actions(), gen,
            solve_gate=(t + 1) % ipm == 0)
        finite &= torch.isfinite(obs).all() & torch.isfinite(rew).all()
        timeout_reset &= ~(info["timeout"] & (state.progress != 0)).any()
        n_timeout += info["timeout"].sum()
        n_fall += info["fall"].sum()
    clock.mark()
    ms, window = clock.read()
    launches, others = row1_launches()
    results["fused_solve_chain"]["launches"] += launches
    obs_shape = tuple(obs.shape)

    # no host synchronisation on the step: two steps with PyTorch's check
    # set to raise, eight envs timing out in the first (an auto-reset)
    state = state._replace(progress=torch.where(
        torch.arange(BATCH, device=DEV) < 8, cfg.episode_length,
        state.progress))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(ENV_STEPS, ENV_STEPS + 2):
            state, obs, rew, done, info = env.step(
                params, cfg, ter, state, actions(), gen,
                solve_gate=(t + 1) % ipm == 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync_reset = bool(state.progress[:8].eq(1).all())

    # NaN containment: a blown-up env resets with reward 0, the rest go on
    v = state.phys.v.clone()
    v[:4, 0] = float("nan")
    bad = torch.arange(BATCH, device=DEV) < 4
    progress = state.progress.clone()
    state, obs, rew, done, info = env.step(
        params, cfg, ter, state._replace(phys=state.phys._replace(v=v)),
        actions(), gen, solve_gate=(ENV_STEPS + 3) % ipm == 0)
    fresh_finite = bool(torch.isfinite(torch.cat(
        [state.phys.pos, state.phys.v, state.phys.q, state.phys.qd],
        dim=-1)).all())
    nan_ok = (bool(done[bad].all()) and float(rew[bad].abs().max()) == 0.0
              and bool((state.progress[bad] == 0).all()) and fresh_finite
              and bool(torch.isfinite(obs).all())
              and bool((state.progress[~bad & ~done]
                        == progress[~bad & ~done] + 1).all()))

    # launches of one env.step (a solve step and a step without) and of one
    # physics.step, from a torch.profiler trace
    traced = {}
    for name, gate in (("env_step_solve", True), ("env_step_no_solve", False)):
        def one(gate=gate):
            nonlocal state
            state, *_ = env.step(params, cfg, ter, state, actions(), gen,
                                 solve_gate=gate)
        traced[name] = launches_traced(one)
    tau = torch.zeros((BATCH, 12), device=DEV)
    traced["physics_step"] = launches_traced(
        lambda: physics.step(params, cfg.physics, ter, state.phys, tau))

    ok = (check(launches == ENV_STEPS // ipm, "env_path: launches != solve "
                "steps")
          & check(others == 0, "env_path launched another kernel")
          & check(obs_shape == (BATCH, env.NUM_OBS), "env_path obs shape")
          & check(bool(finite), "env_path: obs or rewards not finite")
          & check(bool(timeout_reset), "env_path: a timeout did not reset")
          & check(int(n_timeout) > 0, "env_path: no env timed out")
          & check(sync_reset, "env_path: sync-checked steps did not reset")
          & check(nan_ok, "env_path: NaN containment"))
    emit({"env_path": {
        "ok": bool(ok), "robot": "Aliengo", "batch": BATCH,
        "steps": ENV_STEPS, "episode_length": cfg.episode_length,
        "dr": {"specs": [t for t, _ in dr.specs], "frequency": dr.frequency},
        "qp": PROD._asdict(), "kernel_launches": launches,
        "solve_steps": ENV_STEPS // ipm, "ms_per_step": ms,
        "window_ms": window,
        "env_steps_per_s": BATCH * ENV_STEPS / (window * 1e-3),
        "fall_share_per_step": float(n_fall) / (BATCH * ENV_STEPS),
        "timeouts": int(n_timeout),
        "two_steps_without_host_sync_with_reset": sync_reset,
        "nan_containment": nan_ok, "traced": traced}})


def fsm_path(results):
    """runner.fsm_step + physics, Aliengo, batch 4096, starting in recovery
    stand and commanded to locomotion, 300 ticks; the gate read back once a
    tick (fsm.solve_gate). Then two ticks in which a few robots report a
    body roll of +45 deg and a few of -45 deg."""
    params = robots.aliengo_params(DEV)
    cfg = ControlConfig(qp=PROD)
    pcfg, ter = physics.PhysicsConfig(), terrain.flat(device=DEV)
    q0 = torch.tensor(Q0, device=DEV).repeat(4)
    ps = physics.init_state(params, q0, params.body_height + 0.03, BATCH, DEV)
    cs = runner.init_state(params, cfg, fsm_initial=fsm.RECOVERY_STAND,
                           batch=BATCH, device=DEV)
    passive = torch.zeros(BATCH, dtype=torch.int32, device=DEV)
    commands = torch.tensor([0.5, 0.0, 0.0], device=DEV).repeat(BATCH, 1)
    reset_counts()
    gate_ticks, first_loco = 0, None
    z_min = torch.full((BATCH,), float("inf"), device=DEV)
    tilt = torch.zeros(BATCH, device=DEV)
    clock = TickClock()
    for t in range(FSM_TICKS):
        clock.mark()
        gate = bool(fsm.solve_gate(cfg, cs))
        gate_ticks += gate
        body = physics.root_state_vector(ps)
        cs, tau, passive, met = runner.fsm_step(
            params, cfg, cs, passive, ps.q, ps.qd, body, commands,
            control_mode=fsm.LOCOMOTION, solve_gate=gate)
        ps, _, _ = physics.step(params, pcfg, ter, ps, tau)
        if t < 4:
            all_loco = bool((met["fsm_state"] == fsm.LOCOMOTION).all())
            if all_loco and first_loco is None:
                first_loco = t
        if t >= 3:
            z_min = torch.minimum(z_min, ps.pos[:, 2])
            tilt = torch.maximum(tilt, robot_tilt(ps))
    clock.mark()
    ms, window = clock.read()
    launches, others = row1_launches()
    results["fused_solve_chain"]["launches"] += launches
    h = float(params.body_height)
    walking = ((cs.fsm.state == fsm.LOCOMOTION) & (z_min > 0.65 * h)
               & (tilt < 0.4) & (ps.pos[:, 0] >= 1.0)
               & (ps.pos[:, 1].abs() < 0.2))

    # the unsafe roll (positive only: the reference's fabs-of-bool check)
    body = physics.root_state_vector(ps)
    roll = torch.zeros(BATCH, device=DEV)
    roll[:64] = math.radians(45.0)
    roll[64:128] = -math.radians(45.0)
    rolled = body.clone()
    rolled[:, 3:7] = torch.stack([torch.sin(roll / 2), torch.zeros_like(roll),
                                  torch.zeros_like(roll), torch.cos(roll / 2)],
                                 dim=-1)
    states = []
    for _ in range(2):
        cs, tau, passive, met = runner.fsm_step(
            params, cfg, cs, passive, ps.q, ps.qd, rolled, commands,
            control_mode=fsm.LOCOMOTION,
            solve_gate=bool(fsm.solve_gate(cfg, cs)))
        states.append(met["fsm_state"])
    pos_to_rec = bool((states[1][:64] == fsm.RECOVERY_STAND).all()
                      and cs.fsm.locomotion_unsafe[:64].all())
    neg_stays = bool((states[1][64:] == fsm.LOCOMOTION).all()
                     and not cs.fsm.locomotion_unsafe[64:].any())
    ok = (check(first_loco == 2, "fsm_path: the batch did not enter "
                "locomotion on tick 2 (two-tick protocol)")
          & check(bool(walking.all()), "fsm_path: a robot is not walking")
          & check(launches == gate_ticks, "fsm_path: launches != gate ticks")
          & check(others == 0, "fsm_path launched another kernel")
          & check(pos_to_rec, "fsm_path: roll > 40 deg did not switch to "
                  "recovery")
          & check(neg_stays, "fsm_path: roll < -40 deg left locomotion"))
    emit({"fsm_path": {
        "ok": bool(ok), "robot": "Aliengo", "batch": BATCH,
        "ticks": FSM_TICKS, "kernel_launches": launches,
        "gate_ticks": gate_ticks, "first_tick_all_in_locomotion": first_loco,
        "robots_walking": int(walking.sum()),
        "mean_x_m": float(ps.pos[:, 0].mean()),
        "min_z_m": float(z_min.min()), "max_tilt_rad": float(tilt.max()),
        "ms_per_tick": ms, "robot_ticks_per_s": BATCH * FSM_TICKS
        / (window * 1e-3),
        "roll_plus_45_deg_to_recovery": pos_to_rec,
        "roll_minus_45_deg_stays": neg_stays,
        "gate_read": "bool(fsm.solve_gate(cfg, state)) once a tick"}})


def play_cli():
    """`cli play` in Min and Fsm mode, as a user runs it, both at once."""
    cmds = {mode: [sys.executable, "-m", "rl_mpc_locomotion_tpu_torch.cli",
                   "play", "--robot", "Aliengo", "--mode", mode,
                   "--num-envs", "64", "--seconds", "1"]
            for mode in ("Min", "Fsm")}
    procs = {mode: subprocess.Popen(c, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for mode, c in cmds.items()}
    out = {}
    for mode, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        summary = [ln for ln in stdout.splitlines()
                   if ln.startswith("[play]") and "robot-ticks/s" in ln]
        ok = check(proc.returncode == 0 and len(summary) == 1,
                   f"play_cli --mode {mode}")
        out[mode] = {"ok": ok, "returncode": proc.returncode,
                     "summary": summary[-1] if summary else None,
                     "stderr_tail": stderr[-400:] if not ok else ""}
    emit({"play_cli": {"ok": all(v["ok"] for v in out.values()), **out}})


# ---- PPO training --------------------------------------------------------------

TRAIN_WARMUP, TRAIN_TIMED = 1, 3
LEARN_ENVS, LEARN_ITERS = 512, 60       # cfg/aliengo.yaml's num_envs
RESUME_ENVS = 64
TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke", "train")


def train_config(num_envs, **kw):
    """Aliengo training as ``cli train --terrain flat`` sets it up: flat
    ground, the production QP configuration, default PPOConfig."""
    return train_mod.TrainConfig(
        num_envs=num_envs, ppo=ppo.PPOConfig(),
        env=env.EnvConfig(control=ControlConfig(qp=PROD)), **kw)


class UpdateMarks:
    """CUDA events recorded just before and after every ``ppo.ppo_update``
    that ``rl/train`` makes while active: they split an iteration into its
    rollout (and the last value) and its update (and the QP telemetry)."""

    def __enter__(self):
        self.marks, self._orig = [], ppo.ppo_update

        def marked(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._orig(*args, **kw)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.marks.append((start, end))
            return out

        ppo.ppo_update = marked
        return self

    def __exit__(self, *exc):
        ppo.ppo_update = self._orig


def metrics_finite(metrics):
    return bool(torch.isfinite(torch.stack(
        [v.float() for v in metrics.values()])).all())


def train_path(results):
    """make_train_step at 4096 envs: one warm-up and TRAIN_TIMED timed
    iterations (CUDA events: iteration start, update start and end), the
    launches of one rollout and one update (torch.profiler), then one
    iteration under set_sync_debug_mode("error"). Returns what
    train_update compares: a recorded rollout and the state before it."""
    params = robots.aliengo_params(DEV)
    cfg = train_config(BATCH)
    ter = terrain.flat(device=DEV)
    model = ActorCritic(env.NUM_ACTIONS).to(DEV)
    ts = ppo.init_train_state(seeding.key(SEED, DEV), model, env.NUM_OBS,
                              cfg.ppo)
    env_gen = seeding.key(SEED, DEV, stream=1)
    step_fn, reset_fn = train_mod.make_train_step(params, cfg, ter, model)
    es, obs = reset_fn(env_gen)
    tick, iters = 0, TRAIN_WARMUP + TRAIN_TIMED
    reset_counts()
    with UpdateMarks() as marks:
        starts, ends = [], []
        for i in range(iters):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            t0 = time.perf_counter()
            ts, es, obs, tick, metrics = step_fn(ts, es, obs, tick, env_gen)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
        torch.cuda.synchronize()
        host_last_ms = (time.perf_counter() - t0) * 1e3
    launches, others = row1_launches()
    results["fused_solve_chain"]["launches"] += launches
    timed = range(TRAIN_WARMUP, iters)
    rollout = [starts[i].elapsed_time(marks.marks[i][0]) for i in timed]
    update = [marks.marks[i][0].elapsed_time(marks.marks[i][1])
              for i in timed]
    whole = [starts[i].elapsed_time(ends[i]) for i in timed]
    iter_ms = statistics.median(whole)
    finite = metrics_finite(metrics)
    qp_keys = sorted(k for k in metrics if k.startswith("qp_"))
    logged = {k: float(v) for k, v in metrics.items()}

    # launches and device-busy time of one rollout and one update
    reset_batch, step_batch = train_mod.make_env_fns(cfg, ter)
    rec = {}

    def one_rollout():
        def env_step(s, a, t):
            return step_batch(params, s, a, tick + t, env_gen)
        rec["before"] = (copy.deepcopy(model.state_dict()),
                         copy.deepcopy(ts.opt_state), ts.lr.clone())
        rec["es"], rec["obs"], rec["traj"], _ = ppo.rollout(
            model, env_step, es, obs, ts.generator, cfg.ppo.num_steps)
        with torch.no_grad():
            rec["last_value"] = model(rec["obs"])[2]

    reset_counts()
    traced_rollout = launches_traced(one_rollout)
    rollout_row1, _ = row1_launches()
    results["fused_solve_chain"]["launches"] += rollout_row1
    n = BATCH * cfg.ppo.num_steps
    perms = torch.stack([torch.randperm(
        n, generator=torch.Generator().manual_seed(SEED + e))
        for e in range(cfg.ppo.num_epochs)])
    rec["perms"] = perms
    card = {}

    def one_update():
        card["ts"], card["metrics"] = ppo.ppo_update(
            model, cfg.ppo, ts, rec["traj"], rec["last_value"],
            perms=perms.to(DEV))

    traced_update = launches_traced(one_update)
    rec["after"] = ({k: v.clone() for k, v in model.state_dict().items()},
                    card["ts"].opt_state, card["ts"].lr, card["metrics"])
    ts = card["ts"]
    es, obs, tick = rec["es"], rec["obs"], tick + cfg.ppo.num_steps

    # no host synchronisation inside an iteration
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts, es, obs, tick, sync_metrics = step_fn(ts, es, obs, tick, env_gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync_row1, sync_others = row1_launches()
    results["fused_solve_chain"]["launches"] += sync_row1
    per_iter = cfg.ppo.num_steps // cfg.env.control.iterations_between_mpc
    ok = (check(launches == per_iter * iters and sync_row1 == per_iter
                and rollout_row1 == per_iter,
                "train_path: row-1 launches != 12 an iteration")
          & check(others == 0 and sync_others == 0,
                  "train_path launched another kernel")
          & check(finite and metrics_finite(sync_metrics),
                  "train_path: metrics not finite")
          & check(len(qp_keys) == 5 and logged["qp_pri_res_p50"] > 0.0,
                  "train_path: no QP telemetry")
          & check(traced_rollout is not None and traced_update is not None,
                  "train_path: the trace holds no device time"))
    emit({"train_path": {
        "ok": bool(ok), "robot": "Aliengo", "terrain": "flat",
        "num_envs": BATCH, "num_steps": cfg.ppo.num_steps,
        "epochs_x_minibatches": [cfg.ppo.num_epochs,
                                 cfg.ppo.num_minibatches],
        "minibatch_rows": n // cfg.ppo.num_minibatches,
        "model": {"hidden": [512, 256, 128],
                  "parameters": sum(p.numel() for p in model.parameters())},
        "qp": PROD._asdict(), "iterations_timed": TRAIN_TIMED,
        "rollout_ms": statistics.median(rollout),
        "update_ms": statistics.median(update), "iter_ms": iter_ms,
        "rollout_ms_each": rollout, "update_ms_each": update,
        "iter_ms_each": whole, "host_last_iter_ms": host_last_ms,
        "rollout_share": statistics.median(rollout) / iter_ms,
        "env_steps_per_s": n / (iter_ms * 1e-3),
        "row1_launches": launches, "row1_launches_per_iteration":
        launches / iters, "traced_rollout": traced_rollout,
        "traced_update": traced_update,
        "one_iteration_without_host_sync": True, "metrics": logged}})
    return cfg, rec


def ratio_to_movement(got, want, old):
    """|got - want| over want's largest movement from old, per tensor: the
    99.9th percentile and the largest, over every entry."""
    ratios = []
    for k in want:
        moved = (want[k] - old[k]).abs().max()
        ratios.append(((got[k] - want[k]).abs() / moved).reshape(-1))
    ratios = torch.cat(ratios).numpy()
    return float(np.quantile(ratios, 0.999)), float(ratios.max())


def train_update(cfg, rec):
    """The recorded update on the card against the same update on the CPU
    (same rollout, parameters, Adam state, lr and permutations)."""
    state_dict, adam, lr = rec["before"]
    cpu = ActorCritic(env.NUM_ACTIONS)
    cpu.load_state_dict({k: v.cpu() for k, v in state_dict.items()})
    cpu_adam = ppo.AdamState(
        count=adam.count.cpu(), mu={k: v.cpu() for k, v in adam.mu.items()},
        nu={k: v.cpu() for k, v in adam.nu.items()})
    traj = ppo.Transition(*(x.cpu() for x in rec["traj"]))
    t0 = time.perf_counter()
    cpu_ts, cpu_metrics = ppo.ppo_update(
        cpu, cfg.ppo, ppo.TrainState(cpu, cpu_adam, lr.cpu(),
                                     torch.Generator()),
        traj, rec["last_value"].cpu(), perms=rec["perms"])
    cpu_s = time.perf_counter() - t0
    card_params, card_adam, card_lr, card_metrics = rec["after"]
    old = {k: v.cpu() for k, v in state_dict.items()}
    want = cpu.state_dict()
    got = {k: v.cpu() for k, v in card_params.items()}
    q999, worst = ratio_to_movement(got, want, old)
    rel_to_param, param_at = max((float((got[k] - want[k]).abs().max()
                                        / want[k].abs().max()), k)
                                 for k in want)
    moment, moment_at = max(
        (float((getattr(card_adam, m)[k].cpu()
                - getattr(cpu_ts.opt_state, m)[k]).abs().max()
               / getattr(cpu_ts.opt_state, m)[k].abs().max()), f"{m} {k}")
        for m in ("mu", "nu") for k in want)
    lr_rel = abs(float(card_lr) / float(cpu_ts.lr) - 1.0)
    metric_rel = {k: abs(float(card_metrics[k]) - float(v))
                  / max(1.0, abs(float(v))) for k, v in cpu_metrics.items()}
    ok = (check(q999 < 1e-3 and worst < 0.25 and rel_to_param < 1e-4,
                "train_update: parameters, card against CPU")
          & check(moment < 5e-3, "train_update: Adam moments, card "
                  "against CPU")
          & check(lr_rel < 1e-6 and int(card_adam.count)
                  == int(cpu_ts.opt_state.count),
                  "train_update: lr or step count, card against CPU")
          & check(max(metric_rel.values()) < 1e-4,
                  "train_update: metrics, card against CPU"))
    emit({"train_update": {
        "ok": bool(ok), "rows": traj.reward.numel(),
        "param_diff_over_movement_q999": q999,
        "param_diff_over_movement_max": worst,
        "param_diff_over_param_max": rel_to_param, "param_worst": param_at,
        "moment_diff_over_moment_max": moment, "moment_worst": moment_at,
        "lr_rel_diff": lr_rel,
        "lr": float(card_lr), "metrics_rel_diff": metric_rel,
        "cpu_update_s": cpu_s,
        "limits": "q999 < 1e-3, max < 0.25 (of the movement), 1e-4 of "
                  "the tensor's largest |param|; moments 5e-3 of the "
                  "tensor's largest; lr 1e-6; metrics 1e-4 of max(1, |ref|)"
        }})


def train_learning(results):
    """tests/test_learning.py's protocol (TrainConfig(seed=0), default
    PPOConfig and EnvConfig, 60 iterations, the history logged every 10
    iterations and at the end) through rl/train.train at cfg/aliengo.yaml's
    512 envs; then the same with the production QP configuration, as cli
    train sets it, so that row 1 runs in it."""
    runs = {}
    for name, env_cfg, per_iter in (
            ("protocol", env.EnvConfig(), 0),
            ("production_qp", env.EnvConfig(control=ControlConfig(qp=PROD)),
             12)):
        cfg = train_mod.TrainConfig(num_envs=LEARN_ENVS, seed=0,
                                    max_iterations=LEARN_ITERS,
                                    ppo=ppo.PPOConfig(), env=env_cfg)
        reset_counts()
        t0 = time.perf_counter()
        _, hist = train_mod.train(robots.aliengo_params(DEV), cfg,
                                  log_fn=lambda s: None, device=DEV)
        wall = time.perf_counter() - t0
        launches, others = row1_launches()
        results["fused_solve_chain"]["launches"] += launches
        rs = [h["mean_reward"] for h in hist]
        first, last = float(np.mean(rs[:2])), float(np.mean(rs[-2:]))
        ok = (check(all(np.isfinite(rs)),
                    f"train_learning {name}: reward not finite")
              & check(last > 2.0 * first, f"train_learning {name}: last two "
                      "logged rewards not above twice the first two")
              & check(last - first > 0.002,
                      f"train_learning {name}: gain <= 0.002")
              & check(launches == per_iter * LEARN_ITERS and others == 0,
                      f"train_learning {name}: row-1 launches != "
                      f"{per_iter} an iteration"))
        runs[name] = {
            "ok": bool(ok), "qp": cfg.env.control.qp._asdict(),
            "reward_per_step": rs, "iters": [h["iter"] for h in hist],
            "kl": [h["kl"] for h in hist], "lr": [h["lr"] for h in hist],
            "first_two_mean": first, "last_two_mean": last,
            "row1_launches": launches, "seconds": wall,
            "iter_ms": wall * 1e3 / LEARN_ITERS}
    emit({"train_learning": {
        "ok": all(r["ok"] for r in runs.values()), "num_envs": LEARN_ENVS,
        "iterations": LEARN_ITERS, "seed": 0, **runs,
        "assertions": "last > 2 * first and last - first > 0.002"}})


def nondeterministic_ops(fn):
    """The ops torch reports as non-deterministic while fn() runs (warnings
    under use_deterministic_algorithms(True, warn_only=True))."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(". ")[0][:120] for w in caught})


def train_resume(results):
    """4 iterations straight (a checkpoint after 2) against 2 + resume 2 at
    64 envs on the card: the largest difference in parameters and Adam
    state. Then the ops torch calls non-deterministic, on one env step and
    one update."""
    cfg = train_config(RESUME_ENVS, seed=3, save_interval=2,
                       max_iterations=4)
    params = robots.aliengo_params(DEV)
    run_dir = os.path.join(TRAIN_DIR, "resume")
    shutil.rmtree(run_dir, ignore_errors=True)
    reset_counts()
    straight, _ = train_mod.train(params, cfg, log_fn=lambda s: None,
                                  checkpoint_dir=run_dir, device=DEV)
    resumed, _ = train_mod.train(
        params, cfg, log_fn=lambda s: None, max_iterations=2,
        resume_from=os.path.join(run_dir, "model_2"), device=DEV)
    launches, others = row1_launches()
    results["fused_solve_chain"]["launches"] += launches
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    param_diff = max(float((a[k] - b[k]).abs().max()) for k in a)
    moment_diff = max(float((getattr(straight.opt_state, m)[k]
                             - getattr(resumed.opt_state, m)[k]).abs().max())
                      for m in ("mu", "nu") for k in a)

    ter = terrain.flat(device=DEV)
    gen = seeding.key(SEED, DEV)
    model = ActorCritic(env.NUM_ACTIONS).to(DEV)
    ts = ppo.init_train_state(gen, model, env.NUM_OBS, cfg.ppo)
    step_fn, reset_fn = train_mod.make_train_step(params, cfg, ter, model)
    es, obs = reset_fn(gen)
    reset_counts()
    ops = nondeterministic_ops(lambda: step_fn(ts, es, obs, 0, gen))
    results["fused_solve_chain"]["launches"] += row1_launches()[0]
    ok = (check(launches == 12 * 6 and others == 0,
                "train_resume: row-1 launches != 12 an iteration")
          & check(math.isfinite(param_diff), "train_resume: not finite"))
    emit({"train_resume": {
        "ok": bool(ok), "num_envs": RESUME_ENVS,
        "straight_vs_resumed_param_max_abs_diff": param_diff,
        "straight_vs_resumed_adam_max_abs_diff": moment_diff,
        "bit_identical": param_diff == 0.0 and moment_diff == 0.0,
        "nondeterministic_ops_one_iteration": ops}})


def train_cli():
    """`cli train` as a user runs it, then `--resume` from its checkpoint
    directory for three more iterations."""
    ck, logs = os.path.join(TRAIN_DIR, "cli_ck"), os.path.join(TRAIN_DIR,
                                                                "cli_log")
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(logs, ignore_errors=True)
    base = [sys.executable, "-m", "rl_mpc_locomotion_tpu_torch.cli", "train",
            "--task", "Aliengo", "--num-envs", "64", "--max-iterations", "3",
            "--terrain", "flat", "--checkpoint", ck, "--log-dir", logs]
    out = {}
    # logged: iterations 0 and 2, then 5 (every 10th and the last)
    for name, argv, n_log in (("train", base, 2),
                              ("resume", base + ["--resume"], 1)):
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=600)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[train] it=")]
        rewards = [float(ln.split("reward/step=")[1].split()[0])
                   for ln in lines]
        ok = check(proc.returncode == 0 and len(lines) == n_log
                   and all(math.isfinite(r) for r in rewards),
                   f"train_cli {name}")
        out[name] = {"ok": ok, "returncode": proc.returncode,
                     "log": lines,
                     "stderr_tail": proc.stderr[-400:] if not ok else ""}
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    rows_ok = check(len(rows) == 3 and all(
        math.isfinite(v) for r in rows for k, v in r.items()
        if k.startswith("train/")), "train_cli: metrics.jsonl")
    found = sorted(os.listdir(ck))
    ckpt_ok = check({"model_3", "model_6"} <= set(found)
                    and checkpoint.latest_checkpoint(ck).endswith("model_6"),
                    "train_cli: model_3 / model_6 missing")
    emit({"train_cli": {"ok": all(v["ok"] for v in out.values()) and rows_ok
                        and ckpt_ok, **out, "metrics_rows": len(rows),
                        "last_row": rows[-1] if rows else None,
                        "checkpoints": found}})


# ---- the weight policy: deployment and A/B evaluation ---------------------------

POLICY_RUN = "aliengo_weight_policy"
POLICY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "artifacts", POLICY_RUN)
POLICY_TICKS, EVAL_STEPS, EVAL_SMALL_ENVS = 300, 500, 64
# the actor's means, card against CPU: within MEAN_LIMIT of max(1, |ref|)
# for the main path's policy (the mean is what the MPC weights are made of)
# and for every policy within SUM_LIMIT of max(1, M), M the magnitude of the
# sums that form the mean (the float64 forward with every weight, bias and
# input taken by its absolute value): the five saturated policies give means
# of ~1e9 out of sums that cancel, and no float32 forward comes within
# MEAN_LIMIT of |ref| there (the CPU's against float64: 2e-3 to 1.4e-2 in a
# sound run), while both sides' rounding stays under 1e-7 of M
MEAN_LIMIT, SUM_LIMIT = 1e-5, 1e-6
# the action box's image in MPC weights: [1,9]^3 x [30,70]^3 x [0,2]^6 x {0}
WEIGHTS_LO = (1.0,) * 3 + (30.0,) * 3 + (0.0,) * 7
WEIGHTS_HI = (9.0,) * 3 + (70.0,) * 3 + (2.0,) * 6 + (0.0,)


def policy_observations(b, gen):
    """(b, 48) training-layout observations of robots near the stand pose
    with random velocities, commands and previous actions, on the CPU."""
    def rn(*shape, s=1.0):
        return s * torch.randn(shape, generator=gen)
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0]) + rn(b, 4, s=0.05)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    body = torch.cat([rn(b, 2, s=0.5), 0.33 + rn(b, 1, s=0.01), quat,
                      rn(b, 6, s=0.3)], dim=-1)
    q = torch.tensor(Q0).repeat(4) + rn(b, 12, s=0.05)
    cmd = 2.0 * torch.rand((b, 3), generator=gen) - 1.0
    prev = 2.0 * torch.rand((b, 12), generator=gen) - 1.0
    return weight_policy.compute_observations_train_parity(
        body, q, rn(b, 12, s=0.5), cmd, prev)


def sum_magnitude(actor, obs):
    """Per mean, the magnitude of the sums that form it, in float64."""
    h = obs.double().abs()
    for layer in actor.dense:
        h = h @ layer.weight.double().abs().T + layer.bias.double().abs()
    return h


def policy_weights():
    """Each committed weight file loaded on the card and on the CPU; the
    actor's forward on 4096 observations, card against CPU (MEAN_LIMIT,
    SUM_LIMIT); each side's distance to a float64 forward reported."""
    gen = torch.Generator().manual_seed(SEED)
    obs48 = policy_observations(BATCH, gen)
    out, ok = {}, True
    for path in sorted(glob.glob(os.path.join(weight_policy.WEIGHTS_DIR,
                                              "*", "model_*.npz"))):
        run = os.path.basename(os.path.dirname(path))
        flax = convert.flax_params_from_npz(path)
        cpu = convert.actor_critic_from_flax(flax, "cpu")
        card = convert.actor_critic_from_flax(flax, DEV)
        obs = obs48
        if cpu.num_obs == env.NUM_OBS + env.NUM_ROBOT_TYPES:
            onehot = torch.eye(env.NUM_ROBOT_TYPES)[
                torch.arange(BATCH) % env.NUM_ROBOT_TYPES]
            obs = torch.cat([obs48, onehot], dim=-1)
        want = weight_policy.policy_mean(cpu, dict(cpu.named_parameters()),
                                         obs).double()
        got = weight_policy.policy_mean(card, dict(card.named_parameters()),
                                        obs.to(DEV)).cpu().double()
        with torch.no_grad():
            mag = sum_magnitude(cpu.actor, obs).clamp_min(1.0)
            exact = cpu.double().actor(obs.double())
        diff = (got - want).abs()
        ref_err = float((diff / want.abs().clamp_min(1.0)).max())
        sum_err = float((diff / mag).max())
        run_ok = (check(cpu.num_obs == obs.shape[1], f"policy_weights {run}: "
                        "width")
                  & check(sum_err <= SUM_LIMIT, f"policy_weights {run}: "
                          "means, card against CPU, of the sums' magnitude")
                  & check(run != POLICY_RUN or ref_err <= MEAN_LIMIT,
                          f"policy_weights {run}: means, card against CPU"))
        ok &= run_ok
        out[run] = {
            "ok": bool(run_ok), "file": os.path.relpath(path),
            "inputs": cpu.num_obs,
            "parameters": sum(p.numel() for p in cpu.parameters()),
            "mean_max_rel_err": ref_err, "mean_max_err_of_sums": sum_err,
            "deployed_action_max_abs_err": float(
                (got.clamp(-1, 1) - want.clamp(-1, 1)).abs().max()),
            "card_vs_float64_of_sums": float(
                ((got - exact).abs() / mag).max()),
            "cpu_vs_float64_of_sums": float(
                ((want - exact).abs() / mag).max()),
            "cpu_vs_float64_rel": float(((want - exact).abs()
                                         / exact.abs().clamp_min(1.0)).max()),
            "largest_abs_mean": float(exact.abs().max()),
            "saturated_share": float((exact.abs() > 1).double().mean())}
    ok &= check(len(out) == 6, "policy_weights: not six weight files")
    emit({"policy_weights": {"ok": bool(ok), "observations": BATCH,
                             "limits": {"mean_rel": MEAN_LIMIT,
                                        "of_sums": SUM_LIMIT},
                             "runs": out}})


def policy_path(results):
    """policy_fsm_step + physics.step, 4096 Aliengo robots, the committed
    aliengo_weight_policy, production QP config, flat ground, trot, vx 0.5,
    from recovery stand commanded to locomotion, POLICY_TICKS ticks with the
    gate read back once a tick; then one tick under the sync check and the
    launches of one traced tick."""
    params = robots.aliengo_params(DEV)
    cfg = ControlConfig(qp=PROD)
    pcfg, ter = physics.PhysicsConfig(), terrain.flat(device=DEV)
    pol = weight_policy.WeightPolicy(POLICY_DIR, device=DEV)
    q0 = torch.tensor(Q0, device=DEV).repeat(4)
    ps = physics.init_state(params, q0, params.body_height + 0.03, BATCH, DEV)
    cs = runner.init_state(params, cfg, fsm_initial=fsm.RECOVERY_STAND,
                           batch=BATCH, device=DEV)
    passive = torch.zeros(BATCH, dtype=torch.int32, device=DEV)
    prev = torch.zeros((BATCH, 12), device=DEV)
    commands = torch.tensor([0.5, 0.0, 0.0], device=DEV).repeat(BATCH, 1)
    lo = torch.tensor(WEIGHTS_LO, device=DEV)
    hi = torch.tensor(WEIGHTS_HI, device=DEV)
    h = float(params.body_height)

    def tick(ps, cs, passive, prev, gate):
        body = physics.root_state_vector(ps)
        cs, tau, prev, passive, met = weight_policy.policy_fsm_step(
            params, cfg, pol.model, pol.params, cs, prev, ps.q, ps.qd, body,
            commands, 0, fsm.LOCOMOTION, passive, solve_gate=gate)
        ps, _, _ = physics.step(params, pcfg, ter, ps, tau)
        return ps, cs, passive, prev, met

    reset_counts()
    gate_ticks, first_loco = 0, None
    z_min = torch.full((BATCH,), float("inf"), device=DEV)
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    in_box = torch.ones((), dtype=torch.bool, device=DEV)
    clock = TickClock()
    for t in range(POLICY_TICKS):
        clock.mark()
        gate = bool(fsm.solve_gate(cfg, cs))
        gate_ticks += gate
        ps, cs, passive, prev, met = tick(ps, cs, passive, prev, gate)
        w = weight_policy.actions_to_weights(prev)
        in_box &= ((w >= lo) & (w <= hi)).all()
        finite &= torch.isfinite(torch.cat([ps.pos, ps.quat, ps.v, ps.q,
                                            prev], dim=-1)).all()
        z_min = torch.minimum(z_min, ps.pos[:, 2])
        if t < 4 and first_loco is None and bool(
                (met["fsm_state"] == fsm.LOCOMOTION).all()):
            first_loco = t
    clock.mark()
    ms, window = clock.read()
    launches, others = row1_launches()
    results["fused_solve_chain"]["launches"] += launches
    in_loco = int((cs.fsm.state == fsm.LOCOMOTION).sum())

    # no host synchronisation in a tick apart from the gate's read-back
    gate = bool(fsm.solve_gate(cfg, cs))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ps, cs, passive, prev, _ = tick(ps, cs, passive, prev, gate)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    # launches of one traced tick (a solve tick) and of the policy alone
    body = physics.root_state_vector(ps)
    traced = {
        "tick_with_solve": launches_traced(
            lambda: tick(ps, cs, passive, prev, True)),
        "policy_step": launches_traced(
            lambda: weight_policy.policy_step(
                pol.model, pol.params, body, ps.q, ps.qd, commands, prev))}
    share = None
    if traced["tick_with_solve"] and traced["policy_step"]:
        whole, mlp = traced["tick_with_solve"], traced["policy_step"]
        share = {"launches": mlp["launches"] / whole["launches"],
                 "device_ms": mlp["device_busy_ms"] / whole["device_busy_ms"]}
    ok = (check(first_loco == 2, "policy_path: the batch did not enter "
                "locomotion on tick 2 (two-tick protocol)")
          & check(in_loco == BATCH, "policy_path: a robot left locomotion")
          & check(bool(finite), "policy_path: a state is not finite")
          & check(float(z_min.min()) > 0.6 * h, "policy_path: a base fell "
                  "below 0.6 x body height")
          & check(bool(in_box), "policy_path: weights outside the action "
                  "box's image")
          & check(launches == gate_ticks, "policy_path: launches != gate "
                  "ticks")
          & check(others == 0, "policy_path launched another kernel"))
    emit({"policy_path": {
        "ok": bool(ok), "robot": "Aliengo", "policy": POLICY_RUN,
        "batch": BATCH, "ticks": POLICY_TICKS, "kernel_launches": launches,
        "gate_ticks": gate_ticks, "first_tick_all_in_locomotion": first_loco,
        "robots_in_locomotion": in_loco, "min_z_m": float(z_min.min()),
        "min_z_limit_m": 0.6 * h, "mean_x_m": float(ps.pos[:, 0].mean()),
        "ms_per_tick": ms, "robot_ticks_per_s": BATCH * POLICY_TICKS
        / (window * 1e-3), "one_tick_without_host_sync": True,
        "traced": traced, "mlp_share_of_a_solve_tick": share}})


class TimedArms:
    """Wraps rl/evaluate.evaluate for the duration of a block: the host
    seconds and row-1 launches of each arm's run, in call order."""

    def __enter__(self):
        self.arms = []
        self._orig = eval_mod.evaluate

        def timed(*args, **kw):
            reset_counts()
            t0 = time.perf_counter()
            out = self._orig(*args, **kw)    # ends in its one read-back
            self.arms.append({
                "arm": "default" if args[3] is None else "policy",
                "seconds": time.perf_counter() - t0,
                "row1_launches": row1_launches()[0],
                "other_launches": row1_launches()[1]})
            return out

        eval_mod.evaluate = timed
        return self

    def __exit__(self, *exc):
        eval_mod.evaluate = self._orig


def eval_path(results):
    """ab_compare at 4096 envs x 500 steps (5 s), seed 0, flat ground,
    production QP config, default EnvConfig otherwise, the committed
    aliengo_weight_policy, every host sync of the run recorded; before it
    the same A/B at 64 envs, reported beside the JAX package's committed
    numbers without a limit."""
    params = robots.aliengo_params(DEV)
    cfg = env.EnvConfig(control=ControlConfig(qp=PROD))
    ter = terrain.flat(device=DEV)
    pol = weight_policy.WeightPolicy(POLICY_DIR, device=DEV)
    # the 64-env A/B first: it also copies the env's constants to the card
    with TimedArms() as small:
        res_small = eval_mod.ab_compare(params, cfg, ter, pol.params,
                                        pol.model, num_envs=EVAL_SMALL_ENVS,
                                        num_steps=EVAL_STEPS, seed=SEED)
    results["fused_solve_chain"]["launches"] += sum(
        a["row1_launches"] for a in small.arms)
    torch.cuda.synchronize()
    with TimedArms() as timed, warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = eval_mod.ab_compare(params, cfg, ter, pol.params,
                                      pol.model, num_envs=BATCH,
                                      num_steps=EVAL_STEPS, seed=SEED)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in syncs if "synchroniz" in str(w.message)]
    n_sync = len(syncs)
    sync_sites = sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                         for w in syncs})
    arms = timed.arms
    launches = sum(a["row1_launches"] for a in arms)
    others = sum(a["other_launches"] for a in arms + small.arms)
    results["fused_solve_chain"]["launches"] += launches
    finite = all(math.isfinite(res[arm][k]) for arm in ("policy", "default")
                 for k in ("reward_per_step", "survival_rate", "falls",
                           "lin_vel_err"))
    ok = (check(finite, "eval_path: a metric is not finite")
          & check(launches == 2 * (EVAL_STEPS // 2), "eval_path: launches "
                  "!= 2 x solve steps")
          & check(others == 0, "eval_path launched another kernel")
          & check(n_sync == len(arms), "eval_path: a host sync inside the "
                  "loop (one read-back an arm expected)")
          & check(res["policy_beats_default"], "eval_path: the policy does "
                  "not beat the default weights at 4096 x 500"))
    for a in arms:
        a["env_steps_per_s"] = BATCH * EVAL_STEPS / a["seconds"]
    with open(os.path.join(POLICY_DIR, "eval_ab.json")) as f:
        committed = json.load(f)

    def brief(r):
        return {k: r[k] for k in ("reward_per_step", "survival_rate", "falls",
                                  "lin_vel_err")}
    emit({"eval_path": {
        "ok": bool(ok), "policy": POLICY_RUN, "num_envs": BATCH,
        "num_steps": EVAL_STEPS, "seed": SEED, "qp": "production",
        "policy_arm": brief(res["policy"]),
        "default_arm": brief(res["default"]),
        "win_criteria": res["win_criteria"],
        "policy_beats_default": res["policy_beats_default"],
        "kernel_launches": launches, "host_syncs": n_sync,
        "host_sync_sites": sync_sites, "arms": arms,
        "small": {"num_envs": EVAL_SMALL_ENVS,
                  "policy_arm": brief(res_small["policy"]),
                  "default_arm": brief(res_small["default"]),
                  "policy_beats_default": res_small["policy_beats_default"],
                  "arms": [dict(a, env_steps_per_s=EVAL_SMALL_ENVS
                                * EVAL_STEPS / a["seconds"])
                           for a in small.arms],
                  "jax_committed": {"policy_arm": brief(committed["policy"]),
                                    "default_arm": brief(committed["default"]),
                                    "file": "artifacts/" + POLICY_RUN
                                    + "/eval_ab.json"}}}})


def policy_cli():
    """`cli play --mode Policy` with telemetry and `cli eval`, as a user
    runs them, both at once."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    tele, ab = (os.path.join(out_dir, "tele.bin"),
                os.path.join(out_dir, "eval.json"))
    for f in (tele, ab):
        if os.path.exists(f):
            os.remove(f)
    base = [sys.executable, "-m", "rl_mpc_locomotion_tpu_torch.cli"]
    common = ["--checkpoint", POLICY_DIR, "--num-envs", "64", "--seconds", "1"]
    cmds = {"play": base + ["play", "--mode", "Policy", "--telemetry", tele]
            + common,
            "eval": base + ["eval", "--out", ab] + common}
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    outs = {}
    for k, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        outs[k] = (proc.returncode, stdout, stderr)
    code, stdout, stderr = outs["play"]
    summary = [ln for ln in stdout.splitlines()
               if ln.startswith("[play]") and "robot-ticks/s" in ln]
    native = any("(native logger)" in ln for ln in stdout.splitlines())
    frames = (native_runtime.TelemetryLogger.read(tele)
              if os.path.exists(tele) else np.zeros((0, 0)))
    ticks = int(1.0 / ControlConfig().dt)
    play_ok = check(code == 0 and len(summary) == 1
                    and frames.shape == (ticks, len(cli.TELEMETRY_FIELDS))
                    and bool(np.isfinite(frames).all()),
                    "policy_cli play --mode Policy --telemetry")
    play = {"ok": play_ok, "returncode": code,
            "summary": summary[-1] if summary else None,
            "telemetry_frames": list(frames.shape), "native_logger": native,
            "stderr_tail": stderr[-400:] if not play_ok else ""}
    code, stdout, stderr = outs["eval"]
    res = None
    if os.path.exists(ab):
        with open(ab) as f:
            res = json.load(f)
    eval_ok = check(code == 0 and res is not None
                    and all(arm in res for arm in ("policy", "default")),
                    "policy_cli eval")
    ev = {"ok": eval_ok, "returncode": code,
          "policy_beats_default": res and res["policy_beats_default"],
          "stderr_tail": stderr[-400:] if not eval_ok else ""}
    emit({"policy_cli": {"ok": bool(play_ok and eval_ok), "play": play,
                         "eval": ev}})


# ---- the articulated 18-DoF plant --------------------------------------------

# three_tier runs 2 s of the JAX table's 4 s: with 4 s the whole script
# took 628 s (every check passing; NVIDIA H100 80GB HBM3, 700.00 W), past
# half the time limit
ART_TICKS, TIER_TICKS, TIER_SETTLE = 200, 200, 50
TIER_CUT = ("2 s of docs/ARCHITECTURE.md's 4 s, to keep the whole run near "
            "600 s")
ART_STEP_STATES = 64
ART_KINDS = ("aliengo", "go1", "a1")
# one articulated physics.step, card against CPU, of max(1, |ref|) (the CPU
# tests' tolerance against the JAX package; TF32 products would exceed it)
ART_STEP_LIMIT = 1e-4
# (name, PhysicsConfig overrides, attach the articulated model)
TIERS = (("srb", {}, False), ("coupled", {"leg_coupling": True}, False),
         ("articulated", {"articulated": True}, True))
# docs/ARCHITECTURE.md's three-tier table (the JAX package; one robot, 4 s)
JAX_TIERS = {
    "srb": {"roll_rms": 0.019, "pitch_rms": 0.037, "vx_mean": 0.534,
            "fz_peak": 399, "stance_fz_mean": 195, "ride_height": 0.365},
    "coupled": {"roll_rms": 0.015, "pitch_rms": 0.023, "vx_mean": 0.542,
                "fz_peak": 275, "stance_fz_mean": 148, "ride_height": 0.374},
    "articulated": {"roll_rms": 0.002, "pitch_rms": 0.032, "vx_mean": 0.506,
                    "fz_peak": 434, "stance_fz_mean": 192,
                    "ride_height": 0.358}}


def art_rel(got, want):
    """Largest |got - want| / max(1, |want|), in float64 on the host."""
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def articulated_params():
    """for_robot built on the card against the CPU build (bitwise), and H at
    4096 seeded poses in [-1.2, 1.2]: symmetric (1e-4 absolute), positive
    definite, its v-block the total mass times I (rtol 1e-5, off-diagonals
    exactly 0), as tests/test_articulated.py checks."""
    t0 = time.perf_counter()
    bitwise = {}
    for name in ART_KINDS:
        gpu, cpu = articulated.for_robot(name, device=DEV), \
            articulated.for_robot(name)
        bitwise[name] = all(g.is_cuda and torch.equal(g.cpu(), c)
                            for g, c in zip(gpu, cpu))
    art = articulated.for_robot("aliengo", device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    q = 2.4 * torch.rand((BATCH, 12), generator=gen, device=DEV) - 1.2
    h = articulated.mass_matrix(art, q)
    asym = float((h - h.mT).abs().max())
    eig_min = torch.linalg.eigvalsh(h.double()).min(dim=-1).values
    m_tot = art.trunk_mass + art.link_mass.sum()
    eye = torch.eye(3, device=DEV)
    vblock_ok = bool(((h[:, :3, :3] - m_tot * eye).abs()
                      <= 1e-5 * m_tot * eye).all())
    vs_cpu = art_rel(h, articulated.mass_matrix(
        articulated.for_robot("aliengo"), q.cpu()))
    ok = (check(all(bitwise.values()), "articulated_params: for_robot on the "
                "card differs from the CPU build")
          & check(h.shape == (BATCH, 18, 18) and asym <= 1e-4,
                  "articulated_params: H not symmetric")
          & check(bool(eig_min.min() > 0), "articulated_params: H not "
                  "positive definite")
          & check(vblock_ok, "articulated_params: H's v-block is not "
                  "the total mass times I"))
    emit({"articulated_params": {
        "ok": bool(ok), "for_robot_bitwise_card_vs_cpu": bitwise,
        "poses": BATCH, "h_max_asymmetry": asym,
        "h_min_eigenvalue": float(eig_min.min()),
        "total_mass_kg": float(m_tot), "vblock_rtol_1e-5": vblock_ok,
        "h_card_vs_cpu_rel": vs_cpu,
        "seconds": time.perf_counter() - t0}})


def energy_momentum(art, st):
    """Per robot, in float64: energy, world linear momentum and angular
    momentum about the world COM (tests/test_articulated.py's sums)."""
    f = {k: getattr(st, k).double() for k in ("pos", "quat", "v", "omega",
                                              "q", "qd")}
    art64 = articulated.ArticulatedParams(*[x.double() for x in art])
    b = f["pos"].shape[0]
    r_wb = rot.quat_to_rot(f["quat"]).mT
    u = torch.cat([(r_wb.mT @ f["v"][..., None])[..., 0],
                   (r_wb.mT @ f["omega"][..., None])[..., 0], f["qd"]], -1)
    hu = (articulated.mass_matrix(art64, f["q"]) @ u[..., None])[..., 0]
    kin = articulated.leg_kinematics(art64, f["q"])
    coms_b = torch.cat([kin["com"].reshape(b, 12, 3),
                        art64.trunk_com.expand(b, 1, 3)], dim=1)
    masses = torch.cat([art64.link_mass.reshape(12), art64.trunk_mass[None]])
    coms_w = f["pos"][:, None] + coms_b @ r_wb.mT
    energy = (0.5 * (u * hu).sum(-1)
              + physics.GRAVITY * (masses * coms_w[..., 2]).sum(-1))
    p_w = (r_wb @ hu[:, :3, None])[..., 0]
    com_w = (masses[:, None] * coms_w).sum(1) / masses.sum()
    l_w = ((r_wb @ hu[:, 3:6, None])[..., 0]
           + torch.linalg.cross(f["pos"] - com_w, p_w, dim=-1))
    return energy, p_w, l_w


def freefall(params, torques_fn, steps, gen):
    """BATCH robots far above flat ground, start velocities drawn per robot;
    (first-substep and last-substep energy / momenta, the largest |L| of
    any substep) after ``steps`` substeps at 1 ms."""
    cfg = physics.PhysicsConfig(dt=0.001, articulated=True,
                                joint_damping=0.0, joint_friction=0.0)
    ter = terrain.flat(extent=10.0, cell=0.5, device=DEV)

    def draw(base, *shape):
        return base * (0.5 + torch.rand(shape, generator=gen, device=DEV))

    st = physics.init_state(params, torch.tensor(Q0, device=DEV).repeat(4),
                            50.0, BATCH, DEV)
    st = st._replace(
        v=draw(torch.tensor([0.3, -0.2, 0.5], device=DEV), BATCH, 3),
        omega=draw(torch.tensor([0.4, 0.3, -0.2], device=DEV), BATCH, 3),
        qd=draw(0.5, BATCH, 12))
    first, l_max = None, torch.zeros(BATCH, dtype=torch.float64, device=DEV)
    for t in range(steps):
        st, _, _ = articulated.substep(params, cfg, ter, st, torques_fn(t))
        em = energy_momentum(params.art, st)
        l_max = torch.maximum(l_max, em[2].abs().amax(dim=-1))
        first = em if first is None else first
    return cfg, first, em, l_max


def articulated_invariants():
    """tests/test_articulated.py's free-fall invariants for 4096 Aliengo
    robots, each with its own start velocities: every robot within the
    test's limits."""
    t0 = time.perf_counter()
    params = robots.aliengo_params(DEV)._replace(
        art=articulated.for_robot("aliengo", device=DEV))
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    zero = torch.zeros((BATCH, 12), device=DEV)
    cfg, (e0, p0, _), (e1, p1, _), _ = freefall(params, lambda t: zero, 100,
                                                gen)
    drift_e = (e1 - e0).abs() / e0.abs().clamp_min(1.0)
    m_tot = float(params.art.trunk_mass + params.art.link_mass.sum())
    expect = p0.clone()
    expect[:, 2] -= physics.GRAVITY * m_tot * cfg.dt * 99
    drift_p = ((p1 - expect).abs().amax(-1)
               / (0.02 * expect[:, 2].abs()))       # within 2 % when <= 1
    phase = torch.arange(12, dtype=torch.float32, device=DEV)
    _, (_, _, l0), (_, _, l1), l_max = freefall(
        params, lambda t: (8.0 * torch.sin(0.05 * t + phase)).expand(
            BATCH, 12), 150, gen)
    drift_l = (l1 - l0).abs().amax(-1) / l_max.clamp_min(1.0)
    ok = (check(bool((drift_e < 0.01).all()), "articulated_invariants: "
                "energy drift over 1 %")
          & check(bool((drift_p <= 1.0).all()), "articulated_invariants: "
                  "momentum off M g by over 2 %")
          & check(bool((drift_l < 0.05).all()), "articulated_invariants: "
                  "angular momentum drift over 5 %"))
    emit({"articulated_invariants": {
        "ok": bool(ok), "robots": BATCH,
        "energy_drift_max": float(drift_e.max()),
        "momentum_off_mg_max_of_2pct": float(drift_p.max()),
        "angular_momentum_drift_max": float(drift_l.max()),
        "limits": "energy 1 % over 100 substeps at zero torque, momentum "
                  "M g to 2 %, L about the COM 5 % over 150 pumping substeps",
        "seconds": time.perf_counter() - t0}})


def art_states(b, seed):
    """b robots around the stand pose (tests/test_torch_articulated.py's
    draw): feet below, near and above the ground, random velocities."""
    rng = np.random.default_rng(seed)
    quat = np.concatenate([np.ones((b, 1)), 0.05 * rng.normal(size=(b, 3))],
                          axis=1)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = np.stack([rng.uniform(-0.5, 0.5, b), rng.uniform(-0.5, 0.5, b),
                    np.linspace(0.24, 0.45, b)], axis=1)
    state = dict(
        pos=pos, quat=quat,
        v=0.3 * rng.normal(size=(b, 3)), omega=0.3 * rng.normal(size=(b, 3)),
        q=np.tile(Q0, (b, 4)) + 0.1 * rng.normal(size=(b, 12)),
        qd=rng.normal(size=(b, 12)),
        anchor=pos[:, None, :2] + 0.02 * rng.normal(size=(b, 4, 2)),
        contact=rng.random((b, 4)) > 0.3,
        f_leg=rng.normal(size=(b, 4, 3)))
    state = {k: (v if v.dtype == bool else v.astype(np.float32))
             for k, v in state.items()}
    return state, (20.0 * rng.normal(size=(b, 12))).astype(np.float32)


def articulated_step():
    """One articulated physics.step on the card against the same step on
    the CPU, 64 seeded states, some feet in contact."""
    t0 = time.perf_counter()
    state, tau = art_states(ART_STEP_STATES, SEED + 7)
    ter_cpu = terrain.random_uniform(seed=2, extent=6.0, cell=0.1,
                                     amplitude=0.02, device="cpu")
    cfg = physics.PhysicsConfig(articulated=True)

    def step_on(dev):
        params = articulated.with_articulated(robots.aliengo_params(dev),
                                              "aliengo")
        ter = terrain.Terrain(*[t.to(dev) for t in ter_cpu])
        return physics.step(
            params, cfg, ter, convert.phys_state_from_numpy(
                state, ART_STEP_STATES, dev), torch.from_numpy(tau).to(dev))

    (g_state, g_fc, g_ic), (c_state, c_fc, c_ic) = step_on(DEV), \
        step_on("cpu")
    errs = {name: (float((g.cpu() != c).sum()) if c.dtype == torch.bool
                   else art_rel(g, c))
            for name, g, c in zip(physics.PhysState._fields, g_state,
                                  c_state)}
    flips = int((g_ic.cpu() != c_ic).sum())
    worst = max(v for k, v in errs.items() if k != "contact")
    # the contact force against the largest force of the batch: the 15 kN/m
    # spring turns a position's float32 rounding (~3e-8 m at 0.3 m) into
    # ~5e-4 N, more than 1e-4 of a small force entry
    fc_abs = float((g_fc.cpu() - c_fc).abs().max())
    fc_scale = float(c_fc.abs().max())
    errs["f_contact_entrywise"] = art_rel(g_fc, c_fc)
    errs["f_contact_of_largest"] = fc_abs / fc_scale
    ok = (check(flips == 0 and errs["contact"] == 0, "articulated_step: "
                "contact flags differ between card and CPU")
          & check(worst <= ART_STEP_LIMIT, "articulated_step: card and CPU "
                  "state differ by more than the limit")
          & check(fc_abs <= ART_STEP_LIMIT * fc_scale, "articulated_step: "
                  "contact forces differ by more than the limit")
          & check(bool(c_ic.any()) and not bool(c_ic.all()),
                  "articulated_step: not a mix of contacts"))
    emit({"articulated_step": {
        "ok": bool(ok), "states": ART_STEP_STATES,
        "feet_in_contact": int(c_ic.sum()),
        "worst_rel_err_by_field": errs, "f_contact_max_abs_n": fc_abs,
        "f_contact_largest_n": fc_scale, "limit": ART_STEP_LIMIT,
        "limits": "state fields entry by entry of max(1, |ref|), contact "
                  "forces of the batch's largest force",
        "seconds": time.perf_counter() - t0}})


def perturbed_q0(gen):
    """The stand pose, each robot's joints moved by a seeded +-0.05 rad."""
    return (torch.tensor(Q0, device=DEV).repeat(4)
            + 0.1 * torch.rand((BATCH, 12), generator=gen, device=DEV) - 0.05)


def plant_walk(params, pcfg, qp_cfg, vx, q0, ticks, settle):
    """Min-mode ticks on flat ground from q0; per robot over the ticks after
    ``settle``: lowest base, mean vx, roll / pitch RMS, peak and mean stance
    contact fz (last substep of each tick), mean base height. Returns
    (final PhysState, stats, ms a tick, window ms)."""
    ter = terrain.flat(device=DEV)
    cmd = torch.tensor([vx, 0.0, 0.0], device=DEV).expand(BATCH, 3)
    cs = runner.init_state(params, ControlConfig(qp=qp_cfg), batch=BATCH,
                           device=DEV)
    cfg = ControlConfig(qp=qp_cfg)
    ps = physics.init_state(params, q0, params.body_height + 0.03, BATCH,
                            DEV)
    zeros = lambda: torch.zeros(BATCH, device=DEV)  # noqa: E731
    s = {k: zeros() for k in ("vx", "roll2", "pitch2", "fz_peak", "fz_sum",
                              "stance", "fz_loaded_sum", "loaded", "z")}
    s["z_min"] = torch.full((BATCH,), float("inf"), device=DEV)
    finite = torch.ones(BATCH, dtype=torch.bool, device=DEV)
    clock = TickClock()
    for t in range(ticks):
        clock.mark()
        body = physics.root_state_vector(ps)
        cs, tau, _ = runner.min_step(params, cfg, cs, ps.q, ps.qd, body, cmd,
                                     solve_gate=t % 2 == 1)
        ps, fc, ic = physics.step(params, pcfg, ter, ps, tau)
        finite &= torch.isfinite(torch.cat(
            [ps.pos, ps.quat, ps.v, ps.omega, ps.q, ps.qd], -1)).all(-1)
        if t >= settle:
            rpy = rot.quat_to_rpy(ps.quat)
            fz = fc[..., 2]
            s["z_min"] = torch.minimum(s["z_min"], ps.pos[:, 2])
            s["vx"] += ps.v[:, 0]
            s["roll2"] += rpy[:, 0] ** 2
            s["pitch2"] += rpy[:, 1] ** 2
            s["fz_peak"] = torch.maximum(s["fz_peak"], fz.amax(-1))
            s["fz_sum"] += (fz * ic).sum(-1)
            s["stance"] += ic.sum(-1)
            s["fz_loaded_sum"] += (fz * (fz > 0)).sum(-1)
            s["loaded"] += (fz > 0).sum(-1)
            s["z"] += ps.pos[:, 2]
    clock.mark()
    ms, window = clock.read()
    n = ticks - settle
    stats = {"z_min": s["z_min"], "vx_mean": s["vx"] / n,
             "roll_rms": (s["roll2"] / n).sqrt(),
             "pitch_rms": (s["pitch2"] / n).sqrt(), "fz_peak": s["fz_peak"],
             "stance_fz_mean": s["fz_sum"] / s["stance"].clamp_min(1.0),
             "loaded_fz_mean": s["fz_loaded_sum"] / s["loaded"].clamp_min(1.0),
             "ride_height": s["z"] / n, "finite": finite}
    return ps, stats, ms, window


def spread(x):
    """Batch mean, standard deviation, median, lowest and highest of a
    per-robot statistic."""
    x = x.double()
    return {"mean": float(x.mean()), "std": float(x.std()),
            "median": float(x.median()), "min": float(x.min()),
            "max": float(x.max())}


def articulated_loop(results):
    """tests/test_articulated.py's closed loop at 4096 Aliengo robots on the
    articulated plant (the model attached, the controller's tuned SRB
    constants kept), cmd vx 0.4, 200 ticks, production QP config, start
    joints perturbed per robot by a seeded +-0.05 rad: every robot finite,
    its base over the last 100 ticks above 0.6 body height and its mean vx
    there in (0.1, 0.8); row 1 once a solve tick and nothing else. Then
    use_kernel=False, reported only; and one traced articulated and one
    SRB physics.step."""
    t0 = time.perf_counter()
    params = robots.aliengo_params(DEV)._replace(
        art=articulated.for_robot("aliengo", device=DEV))
    pcfg = physics.PhysicsConfig(articulated=True)
    q0 = perturbed_q0(torch.Generator(device=DEV).manual_seed(SEED + 3))
    h = float(params.body_height)
    out, passed = {}, False
    for name, qp_cfg in (("kernel", PROD),
                         ("use_kernel_false", PROD._replace(use_kernel=False))):
        reset_counts()
        ps, st, ms, window = plant_walk(params, pcfg, qp_cfg, 0.4, q0,
                                        ART_TICKS, ART_TICKS // 2)
        launches, others = row1_launches()
        within = (st["finite"] & (st["z_min"] > 0.6 * h)
                  & (st["vx_mean"] > 0.1) & (st["vx_mean"] < 0.8))
        out[name] = {"kernel_launches": launches, "other_launches": others,
                     "ms_per_tick": ms, "window_ms": window,
                     "robot_ticks_per_s": BATCH * ART_TICKS / (window * 1e-3),
                     "robots_within_limits": int(within.sum()),
                     "z_min_m": float(st["z_min"].min()),
                     "vx_mean": spread(st["vx_mean"])}
        if name == "kernel":
            results["fused_solve_chain"]["launches"] += launches
            passed = (check(bool(within.all()), "articulated_loop: a robot "
                            "outside tests/test_articulated.py's limits")
                      & check(launches == ART_TICKS // 2,
                              "articulated_loop: launches != solve ticks")
                      & check(others == 0, "articulated_loop launched "
                              "another kernel"))
        else:
            check(launches == 0 and others == 0,
                  "articulated_loop use_kernel=False launched a kernel")
    tau = torch.zeros((BATCH, 12), device=DEV)
    ter = terrain.flat(device=DEV)
    traced = {"articulated_physics_step": launches_traced(
        lambda: physics.step(params, pcfg, ter, ps, tau)),
        "srb_physics_step": launches_traced(
        lambda: physics.step(params, physics.PhysicsConfig(), ter, ps, tau))}
    emit({"articulated_loop": {
        "ok": bool(passed), "robot": "Aliengo", "batch": BATCH,
        "ticks": ART_TICKS, "solve_ticks": ART_TICKS // 2, "cmd_vx": 0.4,
        "qp": PROD._asdict(), **out, "traced": traced,
        "limits": "finite, z over the last 100 ticks > 0.6 h, their mean vx "
                  "in (0.1, 0.8) (kernel run only)",
        "seconds": time.perf_counter() - t0}})


FALLEN_SHOWN = 16


def three_tier(results):
    """docs/ARCHITECTURE.md's three-tier comparison on the port: Aliengo,
    trot, cmd vx 0.5, flat ground, 2 s (TIER_CUT), production QP config
    (row 1), 4096 robots with their start joints perturbed by a seeded
    +-0.05 rad; tier 1 the SRB plant, tier 2 leg_coupling=True, tier 3 the
    articulated plant (with_articulated, srb_match=True). Statistics over
    the last 1.5 s, beside the JAX package's table; only tier 3's mean vx is
    limited, to (0.1, 0.8)."""
    t0 = time.perf_counter()
    q0 = perturbed_q0(torch.Generator(device=DEV).manual_seed(SEED + 4))
    tiers, ok = {}, True
    for name, overrides, art in TIERS:
        params = robots.aliengo_params(DEV)
        if art:
            params = articulated.with_articulated(params, "aliengo")
        reset_counts()
        _, st, ms, window = plant_walk(
            params, physics.PhysicsConfig(**overrides), PROD, 0.5, q0,
            TIER_TICKS, TIER_SETTLE)
        launches, others = row1_launches()
        results["fused_solve_chain"]["launches"] += launches
        ok &= (check(launches == TIER_TICKS // 2 and others == 0,
                     f"three_tier {name}: launches != solve ticks")
               & check(bool(st["finite"].all()), f"three_tier {name}: a "
                       "robot not finite"))
        fallen = ~st["finite"] | (st["z_min"] < 0.6 * params.body_height)
        # which robots fell, and from which start, so that a CPU run of
        # either package can replay them
        idx = torch.nonzero(fallen).flatten()[:FALLEN_SHOWN]
        tiers[name] = {"port": {k: spread(st[k]) for k in JAX_TIERS[name]},
                       "jax_table": JAX_TIERS[name],
                       "port_loaded_fz_mean": spread(st["loaded_fz_mean"]),
                       "robots_below_0.6h_or_not_finite": int(fallen.sum()),
                       "fallen": [{"index": int(i), "q0": q0[i].tolist(),
                                   "z_min_m": float(st["z_min"][i])}
                                  for i in idx],
                       "controller_body_mass_kg": float(params.body_mass),
                       "ms_per_tick": ms, "kernel_launches": launches}
    vx = tiers["articulated"]["port"]["vx_mean"]
    ok &= check(0.1 < vx["mean"] < 0.8 and 0.1 < vx["min"]
                and vx["max"] < 0.8, "three_tier: articulated vx outside "
                "(0.1, 0.8)")
    emit({"three_tier": {
        "ok": bool(ok), "robot": "Aliengo", "batch": BATCH, "cmd_vx": 0.5,
        "seconds_simulated": TIER_TICKS / 100, "cut": TIER_CUT, "window_s":
        (TIER_TICKS - TIER_SETTLE) / 100, "qp": PROD._asdict(),
        "statistics": "per robot over the window: roll / pitch RMS (rad), "
                      "mean vx, peak and mean stance contact fz (N, last "
                      "substep of each tick, over the feet flagged in "
                      "contact; port_loaded_fz_mean over the feet pressing, "
                      "fz > 0), mean base z (m); then batch mean, std, min, "
                      "max",
        "tiers": tiers, "seconds": time.perf_counter() - t0}})


# ---- the viewer, the demos and the measuring scripts ------------------------------

# scripts_path's sizes: qp_budget_sweep and the envelope point at 64 envs x
# 40 steps (20 solve ticks), play --telemetry for 0.2 s, multidev_scaling's
# worker at n = 1 for one timed iteration at 512 envs, one campaign
# iteration at 64 envs with one eval seed of 64 envs x 40 steps
SCRIPT_ENVS, SCRIPT_STEPS, SCRIPT_QP_ITERS = 64, 40, 28
VIEWER_LIMIT = 1e-5   # record_frame on the card against the CPU, metres


def counted(fn):
    """(fn(), row-1 launches, other kernels' launches) of one call."""
    reset_counts()
    value = fn()
    launches, others = row1_launches()
    return value, launches, others


def viewer_path(results):
    """utils/viewer on the card: record_frame of a seeded perturbed stand
    (a batch of one) on the card against the same state on the CPU, within
    VIEWER_LIMIT; then render of a few frames where matplotlib is
    installed, and otherwise require_matplotlib and cli play --render
    raising, naming matplotlib, before any tick."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 5)
    params = robots.go1_params(DEV)
    frames, err = [], 0.0
    for _ in range(8):
        ps = physics.init_state(params, torch.tensor(Q0).repeat(4), 0.33)
        quat = torch.tensor([1.0, 0.0, 0.0, 0.0]) + 0.2 * torch.randn(
            4, generator=gen)
        ps = ps._replace(pos=ps.pos + 0.3 * torch.randn(1, 3, generator=gen),
                         quat=(quat / quat.norm())[None],
                         q=ps.q + 0.3 * torch.randn(1, 12, generator=gen))
        got = viewer.record_frame(
            params, type(ps)(*(x.to(DEV) for x in ps)))
        want = viewer.record_frame(robots.go1_params("cpu"), ps)
        err = max(err, max(float(np.abs(got[k] - want[k]).max())
                           for k in want))
        frames.append(got)
    ok = check(err <= VIEWER_LIMIT, "viewer_path: record_frame on the card "
               "differs from the CPU")
    try:
        viewer.require_matplotlib()
        raised = None
    except ImportError as exc:
        raised = str(exc)
    out = {"record_frame_max_abs_err_m": err, "limit": VIEWER_LIMIT,
           "matplotlib": raised is None}
    gif = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke", "viewer.gif")
    if raised is None:
        viewer.render(frames, terrain.flat(device=DEV), gif, stride=1)
        ok &= check(os.path.getsize(gif) > 0, "viewer_path: render")
        out["rendered"] = gif
    else:
        if os.path.exists(gif):
            os.remove(gif)
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                cli.main(["play", "--num-envs", "2", "--seconds", "0.1",
                          "--render", gif])
            play_raised = None
        except ImportError as exc:
            play_raised = str(exc)
        ticked = any(ln.startswith("t=")
                     for ln in log.getvalue().splitlines())
        ok &= check("matplotlib" in raised and play_raised is not None
                    and "matplotlib" in play_raised and not ticked
                    and not os.path.exists(gif),
                    "viewer_path: without matplotlib, rendering must raise "
                    "naming it before any tick")
        out.update(require_matplotlib_raised=raised,
                   play_render_raised=play_raised, ticked_first=ticked)
    emit({"viewer_path": {"ok": bool(ok), **out,
                          "seconds": time.perf_counter() - t0}})


def examples_path(results):
    """The three demos' main() on the card, each meeting its own criterion
    (the stand holds; six robots of three kinds upright on mixed terrain;
    both A/B lanes upright): simulator_test for 1 s (no solve, no kernel),
    mpc_terrain_show and rl_mpc_show for 1.5 s each, row 1 launched and no
    other kernel."""
    runs = (("simulator_test", lambda: simulator_test.main(seconds=1.0)),
            ("mpc_terrain_show", lambda: mpc_terrain_show.main(seconds=1.5)),
            ("rl_mpc_show", lambda: rl_mpc_show.main(
                rl_mpc_show.DEFAULT_CHECKPOINT, seconds=1.5)))
    out, ok = {}, True
    for name, fn in runs:
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            passed, launches, others = counted(fn)
        results["fused_solve_chain"]["launches"] += launches
        want_row1 = name != "simulator_test"
        ok &= (check(passed, f"examples_path: {name} failed its criterion")
               & check((launches > 0) == want_row1 and others == 0,
                       f"examples_path: {name} kernel launches"))
        out[name] = {"passed": passed, "row1_launches": launches,
                     "other_launches": others,
                     "last_line": log.getvalue().strip().splitlines()[-1],
                     "seconds": time.perf_counter() - t0}
    emit({"examples_path": {"ok": bool(ok), **out}})


def scripts_path(results):
    """The measuring and campaign scripts on the card, each counted:
    qp_budget_sweep.measure (A1, rough, DR, the trained policy, 28 ADMM
    iterations) and one envelope_sweep point (both arms), row 1 once a solve
    tick; plot_telemetry.load_frames of a 0.2 s play --telemetry log (a
    frame a tick, finite); multidev_scaling's worker at n = 1 (a one-rank
    group) for one timed iteration; one run_campaigns iteration with its
    one-seed eval."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke")
    solves = SCRIPT_STEPS // 2
    out, ok = {}, True

    t0 = time.perf_counter()
    row, launches, others = counted(lambda: qp_budget_sweep.measure(
        "a1", SCRIPT_QP_ITERS, SCRIPT_ENVS, SCRIPT_STEPS,
        qp_budget_sweep.DEFAULT_CKPT))
    ok &= check(launches == solves and others == 0
                and all(math.isfinite(row[k]) for k in (
                    "diverged_frac", "pri_p99", "dua_p99"))
                and row["policy"] == "trained", "scripts_path: qp_budget")
    out["qp_budget_sweep"] = {**row, "row1_launches": launches,
                              "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        env_res, launches, others = counted(lambda: envelope_sweep.run(
            envelope_sweep.DEFAULT_CKPT, "aliengo", SCRIPT_ENVS, SCRIPT_STEPS,
            os.path.join(build, "envelope"), vx_grid=[0.5],
            yaw_grid=[0.0]))
    point = env_res["rows"][0]
    ok &= check(launches == 2 * solves and others == 0
                and all(math.isfinite(point[a][k])
                        for a in ("policy", "default")
                        for k in ("reward_per_step", "survival_rate",
                                  "lin_vel_err")),
                "scripts_path: envelope point")
    out["envelope_point"] = {
        "command": point["command"],
        **{a: {k: point[a][k] for k in ("survival_rate", "lin_vel_err",
                                        "reward_per_step")}
           for a in ("policy", "default")},
        "row1_launches": launches, "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    tele = os.path.join(build, "scripts_tele.bin")
    for f in (tele, tele + ".meta"):
        if os.path.exists(f):
            os.remove(f)
    with contextlib.redirect_stdout(io.StringIO()):
        _, launches, others = counted(lambda: cli.main([
            "play", "--num-envs", str(SCRIPT_ENVS), "--seconds", "0.2",
            "--telemetry", tele]))
    frames = plot_telemetry.load_frames(tele)["_generic"]
    ticks = int(0.2 / ControlConfig().dt)
    # play's Min mode runs the default QPConfig (the plain accurate
    # pipeline, as the JAX CLI's play does): no kernel
    ok &= check(list(frames) == list(cli.TELEMETRY_FIELDS)
                and all(len(v) == ticks and np.isfinite(v).all()
                        for v in frames.values())
                and launches == others == 0,
                "scripts_path: plot_telemetry.load_frames of a play log")
    out["plot_telemetry"] = {"fields": len(frames),
                             "frames": len(frames["tick"]),
                             "row1_launches": launches,
                             "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        md, launches, others = counted(lambda: multidev_scaling._worker(
            1, envs_per_device=SMOKE_ENVS, timed_iters=1))
    ok &= check(md["metrics_finite"] and md["iter_ms"] > 0
                and md["row1_launches_per_iteration"] == 12
                and launches == 24 and others == 0
                and not torch.distributed.is_initialized(),
                "scripts_path: multidev_scaling worker")
    out["multidev_scaling"] = {k: md[k] for k in (
        "n_devices", "envs_per_device", "iter_ms", "env_steps_per_s",
        "row1_launches_per_iteration")}
    out["multidev_scaling"].update(row1_launches=launches,
                                   seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    runs = os.path.join(build, "runs_torch")
    with contextlib.redirect_stdout(io.StringIO()):
        run_dir, launches, others = counted(lambda: run_campaigns.run(
            "a1_rough", runs_dir=runs, iterations=1, num_envs=SCRIPT_ENVS,
            eval_envs=SCRIPT_ENVS, eval_steps=SCRIPT_STEPS,
            eval_seeds=(0,)))
    with open(os.path.join(run_dir, "eval_ab.json")) as f:
        ab = json.load(f)
    ok &= check(launches == 12 + 2 * solves and others == 0
                and os.path.exists(os.path.join(run_dir, "model_1"))
                and all(math.isfinite(ab[a]["reward_per_step"])
                        for a in ("policy", "default")),
                "scripts_path: run_campaigns a1_rough, one iteration")
    out["run_campaigns"] = {"campaign": "a1_rough", "iterations": 1,
                            "num_envs": SCRIPT_ENVS,
                            "files": sorted(os.listdir(run_dir)),
                            "row1_launches": launches,
                            "seconds": time.perf_counter() - t0}
    results["fused_solve_chain"]["launches"] += sum(
        v["row1_launches"] for v in out.values())
    emit({"scripts_path": {"ok": bool(ok), **out}})


# the assembly kernel's launches on every path from the main path on, added
# up by reset_counts() before it zeroes the counter
assembly_launches = 0


def reset_counts():
    global assembly_launches
    assembly_launches += mpc_assembly.launch_count()
    fused_qp.reset_launch_count()
    admm_kernel.reset_launch_count()
    phase_probe.reset_launch_count()
    mpc_assembly.reset_launch_count()


# (key, name, source, TPU kernel, the PR that redesigned it)
KERNEL_ROWS = [
    ("fused_solve_chain", "fused_solve_chain_batch", "csrc/fused_qp.cu",
     "rl_mpc_locomotion_tpu/ops/pallas/fused_qp.py:340", "PR 3"),
    ("fused_solve", "fused_solve_batch", "csrc/fused_qp.cu",
     "rl_mpc_locomotion_tpu/ops/pallas/fused_qp.py:425", "PR 4"),
    ("scaled_solve", "solve_scaled_batch", "csrc/scaled_solve.cu",
     "rl_mpc_locomotion_tpu/ops/pallas/admm_kernel.py:341", "PR 6"),
    ("stripped_solve", "_stripped_kernel_runner", "csrc/phase_probe.cu",
     "scripts/profile.py:431", "PR 4"),
    ("bm_dma", "make_bm_dma", "csrc/phase_probe.cu", "scripts/profile.py:502",
     "PR 3"),
    # replaces no TPU kernel: the JAX package leaves the assembly to XLA
    ("mpc_assembly", "assemble_mpc_batch", "csrc/mpc_assembly.cu", None,
     None),
]


def main():
    t_start = time.time()
    torch.manual_seed(SEED)
    # a build of its own, so that nvcc's ptxas lines come with it
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke")
    shutil.rmtree(build, ignore_errors=True)
    os.environ["RLMPC_TORCH_BUILD_DIR"] = build
    smi_line = nvidia_smi("name,power.limit")
    emit({"device": {"nvidia_smi_name_power_limit": smi_line,
                     "clocks_max_sm": nvidia_smi("clocks.max.sm"),
                     "torch": torch.__version__, "cuda": torch.version.cuda,
                     "python": sys.version.split()[0]}})

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    ptxas = ptxas_by_kernel(_build.build_log)
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "nvcc_seconds": _build.build_seconds,
                    "directory": str(_build.build_dir()),
                    "ptxas": ptxas}})
    check_solve_builds(ptxas)

    results = {key: {"launches": 0, "max_abs_err": 0.0}
               for key, *_ in KERNEL_ROWS}
    check_solve_kernels(results)
    check_phase_kernels(results)
    check_inverse_accuracy()
    time_kernels(results)
    mpc_assembly_path(results, ptxas)

    params = robots.aliengo_params(DEV)
    commands = torch.tensor([0.4, 0.1, 0.2], device=DEV).repeat(BATCH, 1)
    stream = synthetic_stream(CHECK_TICKS, BATCH, SEED)
    main_path(results, params, commands, stream)
    accurate_path(results, params, commands, stream)
    prebuilt_p_path(results, params)
    profiler_paths(results)
    bench_paths(results)
    parallel_path(results)
    closed_loop(results)
    env_path(results)
    fsm_path(results)
    play_cli()
    train_cfg, recorded = train_path(results)
    train_update(train_cfg, recorded)
    train_learning(results)
    train_resume(results)
    train_cli()
    policy_weights()
    policy_path(results)
    eval_path(results)
    policy_cli()
    articulated_params()
    articulated_invariants()
    articulated_step()
    articulated_loop(results)
    three_tier(results)
    viewer_path(results)
    examples_path(results)
    scripts_path(results)

    results["mpc_assembly"]["launches"] = (assembly_launches
                                           + mpc_assembly.launch_count())
    for key, *_ in KERNEL_ROWS:
        check(results[key]["launches"] > 0, f"{key} never launched on its path")
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": "rl_mpc_locomotion_tpu_torch/" + src, "replaces": tpu,
        "launches": results[key]["launches"],
        "max_abs_err": results[key]["max_abs_err"], "ms": results[key]["ms"],
        "plain_ms": results[key]["plain_ms"],
        "bound_ms": results[key]["bound_ms"],
        "bound_by": results[key]["bound_by"],
        "library_ms": results[key]["library_ms"], "redesigned": redesigned}
        for key, name, src, tpu, redesigned in KERNEL_ROWS]})
    emit({"seconds": time.time() - t_start, "failures": failures})
    if failures:
        sys.exit(1)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
