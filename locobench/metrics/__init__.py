"""Per-layer metrics, one reader a file, found by the metric's name
(``<name>.py``). ``read(ctx)`` returns a number, or None where the trace has
nothing to read; ``ctx`` holds the reduced trace (``locobench/trace.py``),
the configuration, the robots and the card's peaks."""
from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    path = os.path.join(HERE, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "locobench.metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_seconds(ctx, fragment: str):
    """Device seconds of the kernels whose name holds ``fragment``, or None
    where the trace has none."""
    hits = [s for k, s in ctx["trace"]["by_name"].items() if fragment in k]
    return sum(hits) if hits else None


def range_seconds(ctx, name: str):
    """Device seconds charged to the harness range ``name``, or None."""
    return ctx["trace"]["by_range"].get(name)
