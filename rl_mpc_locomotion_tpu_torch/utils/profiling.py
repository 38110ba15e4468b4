"""Tracing and timing: section timers on CUDA events, and torch.profiler.

Counterpart of ``rl_mpc_locomotion_tpu/utils/profiling.py``:

- ``Timer``        named EMA timer of a section of device work: a CUDA event
                   before and after the section on the current stream, read
                   later, so the hot loop is never synchronised. Needs a
                   card (the JAX version's host clock is not carried over).
- ``timed``        context-manager flavour of the same, over a registry.
- ``device_trace`` ``torch.profiler`` over a block, trace written as Chrome
                   JSON into a directory (no-op for ``None``).
- ``annotate``     ``torch.profiler.record_function``: a named range in a
                   trace.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch

EMA = 0.95


class Timer:
    """Exponential-moving-average timer of a section of device work.

    >>> t = Timer("mpc_solve")
    >>> with t:
    ...     solve()
    >>> t.mean_ms          # waits for the recorded sections to finish

    A section's time is the device time between its two events; it becomes
    readable once the device has passed the second one. ``mean_ms``,
    ``last_ms``, ``count`` and ``stats()`` synchronise on the recorded
    events first. Raises without a card.
    """

    def __init__(self, name: str):
        if not torch.cuda.is_available():
            raise RuntimeError("Timer: no CUDA device; it times device work "
                               "with CUDA events")
        self.name = name
        self._mean_ms = 0.0
        self._last_ms = 0.0
        self._count = 0
        self._pending = []

    def __enter__(self):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self._pending.append([start, None])
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._pending[-1][1] = end
        self._drain(wait=False)

    def _drain(self, wait: bool) -> None:
        """Fold in the sections whose end event the device has passed (all
        of them, after waiting, with ``wait``)."""
        while self._pending and self._pending[0][1] is not None:
            start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._pending.pop(0)
            ms = start.elapsed_time(end)
            self._last_ms = ms
            self._mean_ms = (EMA * self._mean_ms + (1.0 - EMA) * ms
                             if self._count else ms)
            self._count += 1

    @property
    def mean_ms(self) -> float:
        self._drain(wait=True)
        return self._mean_ms

    @property
    def last_ms(self) -> float:
        self._drain(wait=True)
        return self._last_ms

    @property
    def count(self) -> int:
        self._drain(wait=True)
        return self._count

    def stats(self) -> Dict[str, float]:
        return {f"{self.name}_ms": self.mean_ms,
                f"{self.name}_last_ms": self.last_ms}


@contextlib.contextmanager
def timed(timers: Dict[str, Timer], name: str):
    """Registry-based timing: creates or updates ``timers[name]``."""
    timer = timers.get(name)
    if timer is None:
        timer = timers[name] = Timer(name)
    with timer:
        yield timer


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (CPU and, with a card, CUDA
    activity); the trace goes to ``log_dir/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto). No-op when ``log_dir`` is None.
    Yields the profiler (None for the no-op), whose ``key_averages()`` sums
    device time by kernel. Run the hot section once before entering:
    first-call work (kernel builds, allocations) swamps a short trace."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Label a section inside an active trace."""
    return torch.profiler.record_function(name)
