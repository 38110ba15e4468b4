"""Metrics sink: per-iteration scalars onto disk.

Counterpart of ``MetricsWriter`` in ``rl_mpc_locomotion_tpu/utils/metrics.py``
(the reference's TensorBoard channel, rsl_rl's OnPolicyRunner): a JSONL
file always, and TensorBoard scalars when ``torch.utils.tensorboard``
imports. The MPC frame logger waits for ROADMAP Queue A item 9.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _tensorboard_writer():
    """torch's SummaryWriter class, or None where it does not import (it
    needs the tensorboard package)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter


def _scalarize(value) -> Optional[float]:
    """A metric as a float, or None for anything but one number."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    try:
        arr = np.asarray(value, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    if arr.size != 1:
        return None
    return float(arr.reshape(()))


class MetricsWriter:
    """Writes one metrics dict per step to JSONL (+ TensorBoard if present).

    >>> w = MetricsWriter("runs/exp0")
    >>> w.write(10, {"mean_reward": 0.5, "kl": 0.01})
    >>> w.close()
    """

    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 jsonl_name: str = "metrics.jsonl"):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, jsonl_name), "a",
                           buffering=1)
        writer = _tensorboard_writer() if use_tensorboard else None
        self._tb = writer(log_dir=log_dir) if writer is not None else None

    @property
    def has_tensorboard(self) -> bool:
        return self._tb is not None

    def write(self, step: int, metrics: Mapping[str, Any],
              prefix: str = "") -> None:
        row: Dict[str, Any] = {"step": int(step), "ts": time.time()}
        for key, val in metrics.items():
            scalar = _scalarize(val)
            if scalar is None:
                continue
            name = f"{prefix}{key}"
            row[name] = scalar
            if self._tb is not None:
                self._tb.add_scalar(name, scalar, int(step))
        self._jsonl.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
