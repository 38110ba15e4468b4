"""The benchmark's own checks on the CPU: ``BENCHMARK.json`` against the
contract it is written to, every name it uses found on disk, the imports,
the operation count, and the result line's schema.

    python -m pytest locobench/tests -q
"""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from locobench import flops, harness, metrics, trace

ROOT = harness.ROOT
HERE = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_and_sizes():
    b = bench()
    assert set(b) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and 1 <= len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells has to fit its 43200 s
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    for p in b["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    for word in b["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in b["paths"])
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128


def test_entries_keys_names_units():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    names = [x["name"] for k in ("configs", "workloads") for x in b[k]]
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_every_cell_reports_what_it_must():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in b["end_to_end"])
    for cell in cells:
        spec = harness.cell_spec(cell)
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"], cell
        for m in spec["per_layer"]:
            assert m["moves"] in e2e, (cell, m["name"])
    e2e_cells = {m["name"]: set(m.get("workloads", cells))
                 for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e_cells
        assert set(m.get("workloads", cells)) <= e2e_cells[m["moves"]]


def test_names_found_on_disk():
    """Each cell's configuration, traffic, loop and limits, and each
    per-layer metric's reader, are files of their own under the paths."""
    b = bench()
    for w in b["workloads"]:
        spec = harness.cell_spec(w["name"])
        assert spec["limits"] is not None, w["name"]
        assert os.path.exists(os.path.join(HERE, "loops",
                                           spec["config"]["loop"] + ".py"))
        assert set(spec["limits"]) >= {"mismatches", "start_gap"}
        assert spec["limits"]["mismatches"] == 0
    for m in b["per_layer"]:
        assert callable(metrics.reader(m["name"]))


FORBIDDEN_ALWAYS = {"jax", "jaxlib", "flax", "rl_mpc_locomotion_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    """The harness and the program it drives load no JAX module, compared
    by whole top-level names (the program's name begins with the JAX
    package's)."""
    tops = _loaded("import locobench.harness, locobench.readings as r\n"
                   "import locobench.loops.fleet, locobench.loops.closed_loop\n"
                   "from locobench.loops import common\n"
                   "import rl_mpc_locomotion_tpu_torch.control.runner\n"
                   "import rl_mpc_locomotion_tpu_torch.sim.articulated")
    assert "rl_mpc_locomotion_tpu_torch" in tops
    assert not tops & FORBIDDEN_ALWAYS


def test_reference_imports_nothing_of_the_program():
    tops = _loaded("import locobench.reference.controller\n"
                   "import locobench.reference.plant")
    assert not tops & (FORBIDDEN_ALWAYS | {"rl_mpc_locomotion_tpu_torch"})
    for name in ("controller.py", "plant.py", "__init__.py"):
        with open(os.path.join(HERE, "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in {"torch", "numpy", "xml",
                                             "typing", "__future__"}, mod


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["rl_mpc_locomotion_tpu_torch.ops.qp", "jaxtyping", "jax.numpy",
         "rl_mpc_locomotion_tpu", "flax.linen", "torch"]) == [
        "flax.linen", "jax.numpy", "rl_mpc_locomotion_tpu"]


def test_row1_operation_count_from_shapes():
    """The frozen count of one row-1 solve, term by term from the QP's
    shapes; at 4096 robots over 67 TFLOP/s it is PERF.md's 0.110 ms bound."""
    h, iters, ruiz = 10, 24, 2
    n, nb = 12 * h, 4 * h
    m = 5 * nb
    terms = flops.solve_terms(h, iters, ruiz)
    # the Hessian's lower blocks, counted one FMA at a time
    fma = sum(12 * 12 * 13 for a in range(h) for b in range(a + 1))
    assert terms["hessian"] == 2 * fma
    assert terms["factor"] == n ** 3 / 3
    assert terms["admm"] == (iters + 1) * (2 * n * n + 2 * 2 * 15 * nb
                                           + 6 * m + 3 * n)
    assert flops.solve_flops(h, iters, ruiz) == 1794520
    peaks = harness.peaks_for("NVIDIA H100 80GB HBM3")
    least = flops.least_seconds(4096, {"horizon": h, "iters": iters,
                                       "ruiz_iters": ruiz}, peaks)
    assert least == pytest.approx(0.1097e-3, rel=1e-3)
    # bound by operations, not bytes, at these shapes
    assert 4096 * flops.solve_bytes(h) / peaks["hbm_bytes_per_s"] < least
    spec = harness.cell_spec("fleet_aliengo_trot_b262144")
    assert spec["config"]["qp_shape"] == {"horizon": h, "iters": iters,
                                          "ruiz_iters": ruiz}
    assert spec["config"]["sizes"] == {"variables": n, "rows": m,
                                       "cone_blocks": nb, "horizon": h}


def test_result_line_schema():
    rows = [["tau_gap", 1e-4, 0.1], ["mismatches", 0, 0]]
    line = harness.result_line(True, 10, 0, {"solves_per_s": {
        "value": 1.5e6, "unit": "solves/s"}}, {"platform": "gpu",
        "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "memory_peak_bytes": 1}, {"device_ops": [], "idle_gaps": []}, rows)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["checks"]["tau_gap"] == {"value": 1e-4, "limit": 0.1}
    json.dumps(line)
    assert harness.judge({"tau_gap": 1e-4, "mismatches": 0},
                         {"tau_gap": 0.1, "mismatches": 0})[0]
    assert not harness.judge({"tau_gap": 1.0, "mismatches": 0},
                             {"tau_gap": 0.1, "mismatches": 0})[0]
    assert not harness.judge({"tau_gap": float("nan"), "mismatches": 0},
                             {"tau_gap": 0.1, "mismatches": 0})[0]
    assert not harness.judge({"tau_gap": 0.0}, None)[0]


def test_trace_reduction_and_readers():
    """A kernel is charged to the harness range open when it was launched;
    busy and idle time are clipped to the traced window; a reader with
    nothing to read returns None."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "tick.min_step",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 2, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "rlmpc::fused_solve_chain_k",
         "ts": 20, "dur": 50, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 80,
         "dur": 10, "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_user_annotation",
         "name": "plant.physics_step", "ts": 75, "dur": 20},
    ]
    s = trace.summarize(ev, 100e-6, 2)
    assert s["kernels"] == 2
    assert s["by_range"] == pytest.approx({"tick.min_step": 50e-6,
                                           "plant.physics_step": 10e-6})
    assert s["busy_s"] == pytest.approx(60e-6)
    assert sum(s["idle_gaps"].values()) == pytest.approx(40e-6)
    ctx = {"trace": s, "config": harness.cell_spec(
        "fleet_aliengo_trot_b262144")["config"], "robots": 4,
        "peaks": harness.peaks_for("NVIDIA H100 80GB HBM3")}
    assert metrics.reader("qp_kernel_ms.fleet")(ctx) == pytest.approx(0.025)
    assert metrics.reader("device_idle_share.fleet")(ctx) == pytest.approx(40)
    empty = dict(ctx, trace=trace.summarize([], 1.0, 1))
    for name in ("qp_kernel_ms.fleet", "qp_roofline.fleet",
                 "period_mfu.fleet", "device_idle_share.fleet",
                 "tick_launches.fleet", "plant_ms.articulated"):
        assert metrics.reader(name)(empty) is None
    assert trace.breakdown(s)["device_ops"][0][0].startswith("rlmpc::")


def test_run_refuses_without_the_card():
    out = subprocess.run([sys.executable, "locobench/run.py", "--workload",
                          "fleet_aliengo_trot_b262144", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
