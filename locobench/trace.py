"""The traced segment of a ``--trace 1`` run and its reduction.

After the measured window the harness runs a few more steps of the same
loop under ``torch.profiler`` (CUPTI), with ``record_function`` ranges that
the harness itself opens around its calls into each layer of the program.
The trace is written to the run's ``TMPDIR``, read back and deleted.

The traced window is the device time between two CUDA events recorded
around the traced steps, after two untraced steps that leave the device
busy, so that it starts in the steady state. Device operations (kernels,
copies, fills) are clipped to that window; a kernel is charged to the
innermost harness range that was open on the host when it was launched
(CUPTI's correlation id), or, failing that, to the device-side copy of the
range that holds it.
"""
from __future__ import annotations

import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_IDLE = "host_outside_ranges"


def run_traced(step, n_steps: int, warm_steps: int = 2) -> dict:
    """``warm_steps`` untraced steps, then ``n_steps`` traced ones; returns
    the reduction of the trace (``summarize``)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm_steps):
        step(True)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev0.record()
        for _ in range(n_steps):
            step(True)
        ev1.record()
        torch.cuda.synchronize()
    window_s = ev0.elapsed_time(ev1) * 1e-3
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, window_s, n_steps)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(ranges, t):
    """Name of the innermost range (start, end, name) holding t, or None."""
    best = None
    for a, b, name in ranges:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else None


def summarize(events, window_s: float, n_steps: int) -> dict:
    """Device seconds by kernel name and by harness range, kernel count,
    busy seconds and idle gaps by host range, over the traced window.
    Times in the trace are microseconds."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not dev:
        return {"window_s": window_s, "steps": n_steps, "busy_s": 0.0,
                "kernels": 0, "by_name": {}, "by_range": {}, "idle_gaps": {}}
    t_end = max(e["ts"] + e["dur"] for e in dev)
    t_start = t_end - window_s * 1e6
    runtime = {e["args"]["correlation"]: e["ts"] for e in xs
               if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    host_ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                   if e.get("cat") == "user_annotation"]
    gpu_ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                  if e.get("cat") == "gpu_user_annotation"]
    by_name, by_range, spans, kernels = {}, {}, [], 0
    for e in dev:
        a = max(e["ts"], t_start)
        b = min(e["ts"] + e["dur"], t_end)
        if b <= a:
            continue
        spans.append((a, b))
        sec = (b - a) * 1e-6
        if e.get("cat") == "kernel":
            kernels += 1
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + sec
        corr = e.get("args", {}).get("correlation")
        where = (_innermost(host_ranges, runtime[corr]) if corr in runtime
                 else _innermost(gpu_ranges, e["ts"]))
        key = where or HOST_IDLE
        by_range[key] = by_range.get(key, 0.0) + sec
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, last = {}, t_start
    for a, b in busy + [[t_end, t_end]]:
        if a > last:
            key = _innermost(host_ranges, last) or HOST_IDLE
            gaps[key] = gaps.get(key, 0.0) + (a - last) * 1e-6
        last = max(last, b)
    return {"window_s": window_s, "steps": n_steps, "busy_s": busy_s,
            "kernels": kernels, "by_name": by_name, "by_range": by_range,
            "idle_gaps": gaps}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    by what the host was doing, each as [name, seconds]."""
    def largest(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": largest(summary["by_name"]),
            "idle_gaps": largest(summary["idle_gaps"])}
