"""Each cell's loop at a few robots on the CPU (the program takes its plain
versions there), judged by the cell's own limits: the program agrees with
the plain reference; the control (the reference in TF32 in the program's
place) and each fault the cell can have, planted under the window's path,
come out not correct. One test runs a short benchmark run on the card and
skips without one.

    python -m pytest locobench/tests -q
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from locobench import harness
from locobench.traffic import Reservoir

FLEET = "fleet_aliengo_trot_b262144"
LOOP = "loop_aliengo_articulated_e65536"
CELLS = {FLEET: (8, 4), LOOP: (4, 6)}   # robots, window steps on the CPU
CONTROL_ROBOTS = 128    # TF32's worst robots need a sample of some size


def run_cell(workload: str, impl: str = "program", seed: int = 2 ** 31 + 11,
             robots: int = 0):
    """A run's set-up, window, and comparison, at a few robots on the CPU;
    returns (correct, numbers)."""
    robots, steps = robots or CELLS[workload][0], CELLS[workload][1]
    spec = harness.cell_spec(workload)
    spec["traffic"] = dict(spec["traffic"], robots=robots,
                           check=dict(spec["traffic"]["check"], robots=robots))
    cell = harness.make_cell(spec, seed, torch.device("cpu"), impl)
    cell.build()
    cell.warmup()
    keep = Reservoir(spec["traffic"]["check"]["steps"], seed)
    for _ in range(steps):
        keep.offer(cell.step(False))
    cell.take(keep.items)
    numbers = cell.check()
    numbers.pop("_info")
    return harness.judge(numbers, spec["limits"])[0], numbers


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_program_agrees_with_reference(workload):
    correct, numbers = run_cell(workload)
    assert correct, numbers


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(workload):
    correct, numbers = run_cell(workload, "control_tf32",
                                robots=CONTROL_ROBOTS)
    assert not correct, numbers


def _where(mask, new, old):
    """Per robot: ``new`` where ``mask``, else ``old``, over nested states."""
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*[_where(mask, n, o) for n, o in zip(new, old)])
    m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def _state_unchanged(monkeypatch):
    from rl_mpc_locomotion_tpu_torch.control import runner
    orig = runner.min_step

    def broken(params, cfg, state, *args, **kw):
        _, tau, m = orig(params, cfg, state, *args, **kw)
        return state, tau, m
    monkeypatch.setattr(runner, "min_step", broken)


def _half_batch(monkeypatch):
    """The second half of the robots left out: their state and torques as
    they were."""
    from rl_mpc_locomotion_tpu_torch.control import runner
    orig = runner.min_step

    def broken(params, cfg, state, *args, **kw):
        new, tau, m = orig(params, cfg, state, *args, **kw)
        keep = torch.arange(tau.shape[0]) < tau.shape[0] // 2
        return (_where(keep, new, state),
                torch.where(keep[:, None], tau, torch.zeros_like(tau)), m)
    monkeypatch.setattr(runner, "min_step", broken)


def _answer_altered(monkeypatch):
    """Row 1's answer altered where it is produced: every force doubled."""
    from rl_mpc_locomotion_tpu_torch.ops.cuda import fused_qp
    orig = fused_qp.fused_solve_chain_batch

    def broken(*args, **kw):
        x, *rest = orig(*args, **kw)
        return (x * 2.0, *rest)
    monkeypatch.setattr(fused_qp, "fused_solve_chain_batch", broken)


def _plant_unchanged(monkeypatch):
    from rl_mpc_locomotion_tpu_torch.sim import physics
    monkeypatch.setattr(physics, "step", lambda params, cfg, ter, st, tau:
                        (st, torch.zeros_like(st.f_leg), st.contact))


FAULTS = [(FLEET, _state_unchanged), (FLEET, _half_batch),
          (FLEET, _answer_altered), (LOOP, _state_unchanged),
          (LOOP, _half_batch), (LOOP, _answer_altered),
          (LOOP, _plant_unchanged)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w.split('_')[0]}-{f.__name__[1:]}"
                              for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    correct, numbers = run_cell(workload)
    assert not correct, numbers


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_short_run_on_the_card(workload):
    """A benchmark run of two seconds on the card: exit 0, a correct result
    whose last key is ``checks``, the cell's end-to-end metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs only on the card")
    out = subprocess.run([sys.executable, "locobench/run.py", "--workload",
                          workload, "--seed", "2718281829", "--seconds", "2",
                          "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in
                                    harness.cell_spec(workload)["end_to_end"]}
    assert line["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_on_the_card(workload):
    """The control at the cell's own size on the card: not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's size runs only on the card")
    out = subprocess.run([sys.executable, "locobench/run.py", "--workload",
                          workload, "--seed", "3100000004", "--seconds", "3",
                          "--trace", "0", "--impl", "control_tf32"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=900, env={**os.environ})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False
