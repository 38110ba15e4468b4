"""Gait phase arithmetic on batched tensors.

Counterpart of ``rl_mpc_locomotion_tpu/ops/gait.py``. Each gait is a row of
the offset/duration tables (in MPC segments, 10 segments a cycle); the phase
math is branch-free over the four legs and any leading batch shape.

Gait ids: 0=trot, 1=bound, 2=pronk, 3=pace, 4=stand->trot (default),
5=gallop, 6=walk, 7=trot-run.
"""
from __future__ import annotations

import torch

N_SEGMENTS = 10
NUM_LEGS = 4

# offsets / durations in MPC segments; row 4 duplicates trot (gait number 4
# falls through to the trotting default in the reference stack)
GAIT_OFFSETS = torch.tensor([
    [0, 5, 5, 0],   # 0 trotting
    [5, 5, 0, 0],   # 1 bounding
    [0, 0, 0, 0],   # 2 pronking
    [5, 0, 5, 0],   # 3 pacing
    [0, 5, 5, 0],   # 4 (stand) -> trot default
    [0, 2, 7, 9],   # 5 galloping
    [0, 3, 5, 8],   # 6 walking
    [0, 5, 5, 0],   # 7 trot running
], dtype=torch.float32)

GAIT_DURATIONS = torch.tensor([
    [5, 5, 5, 5],   # 0 trotting
    [4, 4, 4, 4],   # 1 bounding
    [4, 4, 4, 4],   # 2 pronking
    [5, 5, 5, 5],   # 3 pacing
    [5, 5, 5, 5],   # 4 -> trot default
    [4, 4, 4, 4],   # 5 galloping
    [5, 5, 5, 5],   # 6 walking
    [4, 4, 4, 4],   # 7 trot running
], dtype=torch.float32)

NUM_GAITS = GAIT_OFFSETS.shape[0]

_tables = {}


def _device_tables(device):
    """The two tables on ``device``, copied there once."""
    device = torch.device(device)
    if device not in _tables:
        _tables[device] = (GAIT_OFFSETS.to(device), GAIT_DURATIONS.to(device))
    return _tables[device]


def gait_params(gait_id, device=None):
    """(offsets, durations) in segments. ``gait_id`` is a Python int (one
    gait for the batch, rows of shape (4,)) or an integer tensor (...,)
    (rows of shape (...,4)); ``device`` is needed only for an int."""
    if isinstance(gait_id, int):
        offsets, durations = _device_tables(device if device is not None else "cpu")
        gid = min(max(gait_id, 0), NUM_GAITS - 1)
        return offsets[gid], durations[gid]
    offsets, durations = _device_tables(gait_id.device)
    gid = torch.clamp(gait_id.long(), 0, NUM_GAITS - 1)
    return offsets[gid], durations[gid]


def gait_iteration_phase(iteration_counter, iterations_per_mpc,
                         n_segments=N_SEGMENTS):
    """(segment index float, phase in segment units [0, n)).

    Phase is kept in segment units so that with iterations_per_mpc=2 every
    value is an exact multiple of 0.5: no float knife-edges at stance/swing
    boundaries.
    """
    counter = iteration_counter.to(torch.float32)
    ipm = float(iterations_per_mpc)
    phase_seg = torch.remainder(counter, ipm * n_segments) / ipm
    return phase_seg, phase_seg


def contact_state(phase_seg, offsets, durations, n_segments=N_SEGMENTS):
    """Per-leg stance progress in [0,1]; 0 when the leg is in swing.
    phase_seg (...,), offsets/durations (4,) or (...,4) -> (...,4)."""
    progress = phase_seg[..., None] - offsets
    progress = torch.where(progress < 0, progress + n_segments, progress)
    in_stance = progress <= durations
    return torch.where(in_stance, progress / durations,
                       torch.zeros_like(progress))


def swing_state(phase_seg, offsets, durations, n_segments=N_SEGMENTS):
    """Per-leg swing progress in [0,1]; 0 when the leg is in stance;
    full-stance legs (swing duration 0) return 0."""
    swing_offset = offsets + durations
    swing_offset = torch.where(swing_offset > n_segments,
                               swing_offset - n_segments, swing_offset)
    swing_duration = n_segments - durations
    progress = phase_seg[..., None] - swing_offset
    progress = torch.where(progress < 0, progress + n_segments, progress)
    in_swing = torch.logical_and(progress <= swing_duration,
                                 swing_duration > 0.0)
    return torch.where(in_swing,
                       progress / torch.clamp_min(swing_duration, 1e-9),
                       torch.zeros_like(progress))


def mpc_table(iteration, offsets, durations, n_segments=N_SEGMENTS):
    """(..., n_segments, 4) contact table for the MPC horizon. ``iteration``
    is the float segment index; rows switch exactly when the float segment
    boundary is crossed."""
    seg = torch.arange(n_segments, dtype=torch.float32,
                       device=iteration.device)
    it = torch.remainder(seg + iteration[..., None] + 1.0, n_segments)
    progress = it[..., :, None] - offsets[..., None, :]
    progress = torch.where(progress < 0, progress + n_segments, progress)
    return (progress < durations[..., None, :]).to(torch.float32)


def swing_time(durations, dt_mpc, n_segments=N_SEGMENTS):
    """Per-leg swing duration in seconds, (...,4). The reference stack uses
    leg 0's stance duration for every leg; reproduced."""
    return (dt_mpc * (n_segments - durations[..., 0:1])).expand(
        durations.shape)


def stance_time(durations, dt_mpc, n_segments=N_SEGMENTS):
    """Per-leg stance duration in seconds (leg 0's duration for all)."""
    return (dt_mpc * durations[..., 0:1]).expand(durations.shape)
