"""Metrics sinks: per-iteration scalars and per-solve MPC frames onto disk.

Counterpart of ``rl_mpc_locomotion_tpu/utils/metrics.py``:

- ``MetricsWriter`` (the reference's TensorBoard channel, rsl_rl's
  OnPolicyRunner): a JSONL file always, and TensorBoard scalars when
  ``torch.utils.tensorboard`` imports.
- ``MPCFrameLogger`` (the reference's Logger.py): per-solve MPC frames (com
  state, desired state, GRFs, loss terms, weights, tick) flattened by
  ``pack_mpc_frame`` and flushed to one ``.npz`` of named fields; through
  the native wait-free ring buffer (``utils/native_runtime``) when its
  library builds, so the control loop never writes to disk, buffered in
  Python otherwise. It takes numpy arrays or tensors (read back to the
  host).
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


#: Field layout of one flattened MPC telemetry frame, as the reference logs a
#: solve: 13 com state, 13 desired state, 12 GRFs, 3 loss terms (state,
#: torque, total), 13 weights, 1 tick = 55 floats.
MPC_FRAME_FIELDS = (
    ("com_state", 13),
    ("desired_state", 13),
    ("grf", 12),
    ("loss", 3),
    ("weights", 13),
    ("tick", 1),
)
MPC_FRAME_SIZE = sum(n for _, n in MPC_FRAME_FIELDS)


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float32)


def pack_mpc_frame(com_state, desired_state, grf, loss, weights,
                   tick) -> np.ndarray:
    """One MPC solve's telemetry as a (MPC_FRAME_SIZE,) float32 vector."""
    parts = [_host(com_state).reshape(13), _host(desired_state).reshape(13),
             _host(grf).reshape(12), _host(loss).reshape(3),
             _host(weights).reshape(13), _host(tick).reshape(1)]
    return np.concatenate(parts)


def unpack_mpc_frames(frames: np.ndarray) -> Dict[str, np.ndarray]:
    """(k, MPC_FRAME_SIZE) -> dict of named arrays."""
    frames = np.asarray(frames).reshape(-1, MPC_FRAME_SIZE)
    out = {}
    off = 0
    for name, n in MPC_FRAME_FIELDS:
        out[name] = frames[:, off:off + n]
        off += n
    return out


class MPCFrameLogger:
    """Per-solve MPC telemetry recorder (the reference's Logger.py).

    ``log(...)`` takes one solve's arrays; ``flush()`` writes one ``.npz``
    with the named fields and returns its path. ``native`` says whether the
    native ring buffer carried the frames.
    """

    def __init__(self, log_dir: str = "logs", use_native: bool = True):
        from .native_runtime import TelemetryLogger

        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(
            log_dir, f"mpclog_{time.strftime('%Y%m%d_%H%M%S')}")
        self._native = None
        if use_native:
            native = TelemetryLogger(self._path + ".bin",
                                     frame_size=MPC_FRAME_SIZE)
            if native.available:
                self._native = native
        self.native = self._native is not None
        self._frames: list = []

    def log(self, com_state, desired_state, grf, loss, weights,
            tick) -> None:
        frame = pack_mpc_frame(com_state, desired_state, grf, loss, weights,
                               tick)
        if self._native is not None:
            self._native.push(frame)
        else:
            self._frames.append(frame)

    def flush(self) -> str:
        """Write the frames logged so far to ``<path>.npz``; returns the
        path."""
        if self._native is not None:
            self._native.flush()
            self._native.close()
            frames = type(self._native).read(self._path + ".bin").reshape(
                -1, MPC_FRAME_SIZE)
            self._native = None
        else:
            frames = (np.stack(self._frames) if self._frames
                      else np.zeros((0, MPC_FRAME_SIZE), np.float32))
        out = self._path + ".npz"
        np.savez(out, **unpack_mpc_frames(frames))
        return out
