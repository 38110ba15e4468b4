"""The benchmark's run: set-up, the measured window, the traced segment, the
comparison, the result line.

Everything that belongs to one cell is found by name: the workload in
``BENCHMARK.json`` names its configuration (``locobench/configs/<c>.json``,
whose ``loop`` names ``locobench/loops/<loop>.py``) and its traffic
(``locobench/traffic/<t>.json``); the correctness limits are
``locobench/limits/<workload>.json``; a per-layer metric is
``locobench/metrics/<metric>.py``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rl_mpc_locomotion_tpu")


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(workload: str) -> dict:
    """The workload's entry, configuration, traffic, limits and metrics."""
    bench = _load(ROOT, "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    config = _load(HERE, "configs", wl["config"] + ".json")
    config["qp_shape"] = {"horizon": config["control"]["horizon"],
                          "iters": config["qp"]["iters"],
                          "ruiz_iters": config["qp"]["ruiz_iters"]}
    limits_path = os.path.join(HERE, "limits", workload + ".json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return {"workload": wl, "config": config,
            "traffic": _load(HERE, "traffic", wl["traffic"] + ".json"),
            "limits": _load(limits_path) if os.path.exists(limits_path) else None,
            "end_to_end": e2e, "per_layer": layer}


def make_cell(spec: dict, seed: int, device, impl: str = "program"):
    loop = importlib.import_module("locobench.loops." + spec["config"]["loop"])
    return loop.Cell(spec["config"], spec["traffic"], seed, device, impl)


def forbidden_modules(names=None) -> list:
    """The loaded modules (or ``names``) whose whole top-level name is JAX's
    or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def device_info(torch, dev) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}


def peaks_for(kind: str):
    for prefix, p in _load(HERE, "peaks.json").items():
        if kind.startswith(prefix):
            return p
    return None


def measure(cell, torch, seconds: float) -> tuple:
    """The window: steps back to back for ``seconds`` of the host's clock,
    a CUDA event after each; returns (per-step device ms, kept records)."""
    from locobench.traffic import Reservoir
    keep = Reservoir(cell.traffic["check"]["steps"], cell.seed)
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    t_end = time.perf_counter() + seconds
    while True:
        keep.offer(cell.step(False))
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if time.perf_counter() >= t_end:
            break
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])], keep.items


def window_info(step_ms: list) -> dict:
    """How the window's steps spread: their count, total and quantiles, and
    how many took more than 1 % over the median."""
    from locobench.traffic import quantile
    med = quantile(step_ms, 0.5)
    return {"steps": len(step_ms), "total_ms": sum(step_ms),
            "ms": {str(q): quantile(step_ms, q)
                   for q in (0.01, 0.05, 0.5, 0.9, 0.95, 0.99, 1.0)},
            "over_1pct": sum(1 for v in step_ms if v > 1.01 * med)}


def judge(numbers: dict, limits) -> tuple:
    """(correct, [[name, value, limit], ...]) of the compared numbers."""
    if limits is None:
        return False, [[k, v, None] for k, v in numbers.items()]
    rows = [[k, numbers[k], limits[k]] for k in limits]
    ok = all(v is not None and v == v and v <= lim for _, v, lim in rows)
    return ok, rows


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown, rows) -> dict:
    """The last line of a run: its result, with the compared
    numbers beside their limits under ``checks``, last."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return line


def run(args, t0: float) -> int:
    import torch
    spec = cell_spec(args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    parts = {"imports_s": time.perf_counter() - t0}
    t = time.perf_counter()
    torch.empty(1, device=dev)
    torch.cuda.synchronize()
    parts["cuda_context_s"] = time.perf_counter() - t
    t = time.perf_counter()
    from rl_mpc_locomotion_tpu_torch.ops.cuda import _build
    _build.load_library()
    parts["kernel_library_s"] = time.perf_counter() - t
    parts["kernel_library_built"] = _build.build_seconds > 0
    t = time.perf_counter()
    cell = make_cell(spec, args.seed, dev, args.impl)
    cell.build()
    torch.cuda.synchronize()
    parts["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cell.warmup()
    torch.cuda.synchronize()
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    print(json.dumps({"setup_parts": parts, "setup_s": setup_s}), flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, records = measure(cell, torch, args.seconds)
    attempted, failed, diverged = cell.counts(len(step_ms))
    print(json.dumps({"window": window_info(step_ms) | {
        "qp_diverged": diverged, "qp_diverged_share": diverged / attempted}}),
        flush=True)
    metrics = {k: {"value": v, "unit": None}
               for k, v in cell.end_to_end(step_ms).items()}
    metrics["setup_s"] = {"value": setup_s, "unit": None}
    device = device_info(torch, dev)
    breakdown = None
    if args.trace:
        from locobench import metrics as readers, trace
        summary = trace.run_traced(cell.step, spec["traffic"]["trace_steps"])
        ctx = {"trace": summary, "config": spec["config"],
               "robots": cell.robots, "peaks": peaks_for(device["kind"])}
        metrics = {}
        for m in spec["per_layer"]:
            v = readers.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        breakdown = trace.breakdown(summary)
        print(json.dumps({"trace": {k: summary[k] for k in
                                    ("window_s", "busy_s", "kernels", "steps",
                                     "by_range")}}), flush=True)
    else:
        for m in spec["end_to_end"]:
            if m["name"] not in metrics:
                raise RuntimeError(f"the loop reports no {m['name']}")
            metrics[m["name"]]["unit"] = m["unit"]
        metrics = {m["name"]: metrics[m["name"]] for m in spec["end_to_end"]}
    device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    cell.take(records)
    del records
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = cell.check()
    info = numbers.pop("_info")
    info.pop("all_fields")
    info.pop("start_all_fields")
    info["check_s"] = time.perf_counter() - t
    info["window_steps"] = len(step_ms)
    correct, rows = judge(numbers, spec["limits"])
    print(json.dumps({"check": info}), flush=True)

    bad = forbidden_modules()
    if bad:
        print("loaded in this process: " + ", ".join(bad), file=sys.stderr)
        return 3
    for name, v, lim in rows:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result_line(correct, attempted, failed, metrics, device,
                                 breakdown, rows)), flush=True)
    return 0


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(prog="python3 locobench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--impl", default="program",
                   choices=("program", "control_tf32"),
                   help="control_tf32 puts the plain reference in float32 "
                        "with TF32 matmuls in the program's place (the "
                        "comparison's control; not a benchmark run)")
    return run(p.parse_args(argv), t0)
