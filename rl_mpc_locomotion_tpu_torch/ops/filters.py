"""Streaming filters.

Counterpart of ``rl_mpc_locomotion_tpu/ops/filters.py``: a Neumaier-
compensated moving average (the reference declares it for ground-normal and
velocity smoothing) as a pure function over a filter state. ``index`` and
``count`` are 0-dim int32 tensors; the sample ``shape`` may carry a batch
axis, so one state filters a whole batch of robots in lockstep. Nothing is
read back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class MovingWindowState(NamedTuple):
    buffer: torch.Tensor      # (window, ...) ring buffer
    index: torch.Tensor       # () int32 next write slot
    count: torch.Tensor       # () int32 valid entries
    sum: torch.Tensor         # (...) running sum
    correction: torch.Tensor  # (...) Neumaier compensation


def init_moving_window(window: int, shape=(), device="cpu"
                       ) -> MovingWindowState:
    shape = tuple(shape)
    return MovingWindowState(
        buffer=torch.zeros((window,) + shape, dtype=torch.float32,
                           device=device),
        index=torch.zeros((), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        sum=torch.zeros(shape, dtype=torch.float32, device=device),
        correction=torch.zeros(shape, dtype=torch.float32, device=device),
    )


def _neumaier_add(total, correction, value):
    """Compensated add: the running sum and its correction."""
    new_total = total + value
    big = total.abs() >= value.abs()
    correction = correction + torch.where(
        big, (total - new_total) + value, (value - new_total) + total)
    return new_total, correction


def moving_window_update(state: MovingWindowState, value):
    """Push a sample; returns (new_state, current average)."""
    window = state.buffer.shape[0]
    value = torch.as_tensor(value, dtype=torch.float32,
                            device=state.buffer.device).expand(
                                state.buffer.shape[1:])
    slot = state.index.reshape(1).long()
    oldest = state.buffer.index_select(0, slot)[0]
    full = state.count >= window
    total, corr = _neumaier_add(state.sum, state.correction,
                                torch.where(full, -oldest, 0.0 * oldest))
    total, corr = _neumaier_add(total, corr, value)
    buffer = state.buffer.index_copy(0, slot, value.unsqueeze(0))
    count = torch.clamp_max(state.count + 1, window)
    new_state = MovingWindowState(
        buffer=buffer,
        index=torch.remainder(state.index + 1, window),
        count=count,
        sum=total,
        correction=corr,
    )
    avg = (total + corr) / count.to(torch.float32)
    return new_state, avg


def smooth(values, window: int):
    """Filter a whole trace: (T, ...) samples -> (T, ...) moving averages,
    one update a sample in order (the JAX package's ``lax.scan``)."""
    values = torch.as_tensor(values, dtype=torch.float32)
    state = init_moving_window(window, values.shape[1:], values.device)
    out = []
    for value in values:
        state, avg = moving_window_update(state, value)
        out.append(avg)
    return torch.stack(out)
