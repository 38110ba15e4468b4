"""Cubic Bezier interpolation and foot swing trajectories.

Counterpart of ``rl_mpc_locomotion_tpu/ops/bezier.py``; pure functions of
(p0, pf, height, phase, swing_time) over any leading batch shape.
"""
from __future__ import annotations

import torch


def cubic_bezier(y0, yf, x):
    """Cubic Bezier from y0 to yf at x in [0,1]."""
    bez = x * x * x + 3.0 * (x * x * (1.0 - x))
    return y0 + bez * (yf - y0)


def cubic_bezier_d1(y0, yf, x):
    """First derivative wrt x."""
    return 6.0 * x * (1.0 - x) * (yf - y0)


def cubic_bezier_d2(y0, yf, x):
    """Second derivative wrt x."""
    return (6.0 - 12.0 * x) * (yf - y0)


def swing_trajectory(p0, pf, height, phase, swing_time):
    """Foot swing position/velocity/acceleration at ``phase`` of a swing.

    xy follow one cubic Bezier p0->pf; z uses two chained Beziers (lift to
    p0.z+height over the first half, land to pf.z over the second), both
    halves evaluated and one selected.

    Args:
      p0, pf: (..., 3) swing start / target positions.
      height, phase, swing_time: broadcastable to (...,).
    Returns:
      (p, v, a) each shaped like p0.
    """
    st = torch.clamp_min(torch.as_tensor(swing_time, dtype=p0.dtype,
                                         device=p0.device), 1e-6)
    ph = phase[..., None]
    st3 = st[..., None] if st.dim() > 0 else st
    p = cubic_bezier(p0, pf, ph)
    v = cubic_bezier_d1(p0, pf, ph) / st3
    a = cubic_bezier_d2(p0, pf, ph) / (st3 * st3)

    z0, zf = p0[..., 2], pf[..., 2]
    zmid = z0 + height

    x1 = torch.clamp(phase * 2.0, 0.0, 1.0)
    zp1 = cubic_bezier(z0, zmid, x1)
    zv1 = cubic_bezier_d1(z0, zmid, x1) * 2.0 / st
    za1 = cubic_bezier_d2(z0, zmid, x1) * 4.0 / (st * st)

    x2 = torch.clamp(phase * 2.0 - 1.0, 0.0, 1.0)
    zp2 = cubic_bezier(zmid, zf, x2)
    zv2 = cubic_bezier_d1(zmid, zf, x2) * 2.0 / st
    za2 = cubic_bezier_d2(zmid, zf, x2) * 4.0 / (st * st)

    first_half = phase < 0.5
    zp = torch.where(first_half, zp1, zp2)
    zv = torch.where(first_half, zv1, zv2)
    za = torch.where(first_half, za1, za2)

    p = torch.cat([p[..., :2], zp[..., None]], dim=-1)
    v = torch.cat([v[..., :2], zv[..., None]], dim=-1)
    a = torch.cat([a[..., :2], za[..., None]], dim=-1)
    return p, v, a
