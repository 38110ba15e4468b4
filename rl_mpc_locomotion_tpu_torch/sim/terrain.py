"""Heightfield terrain: a sampled grid shared by the whole batch.

Counterpart of ``rl_mpc_locomotion_tpu/sim/terrain.py``. The constructors make
the grid with numpy from the same arguments and seed as the JAX package, so
the heights are bitwise the same; the grid then lives on ``device``.
``sample_height`` / ``sample_normal`` take world points of any leading shape.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Terrain(NamedTuple):
    height: torch.Tensor      # (H, W) meters
    cell_size: torch.Tensor   # () meters per cell
    origin: torch.Tensor      # (2,) world xy of grid corner (0,0)


def _terrain(grid, extent: float, cell: float, device) -> Terrain:
    return Terrain(
        height=torch.from_numpy(np.ascontiguousarray(grid, np.float32)
                                ).to(device),
        cell_size=torch.tensor(cell, dtype=torch.float32, device=device),
        origin=torch.tensor([-extent / 2, -extent / 2], dtype=torch.float32,
                            device=device))


def _slope_grid(slope, extent, cell, start_x):
    n = int(extent / cell)
    xs = np.arange(n) * cell - extent / 2
    h = np.maximum(0.0, (xs - start_x)) * slope
    return np.tile(h[:, None], (1, n)).astype(np.float32)


def _stairs_grid(step_height, step_run, extent, cell, start_x):
    n = int(extent / cell)
    xs = np.arange(n) * cell - extent / 2
    steps = np.floor(np.maximum(0.0, xs - start_x) / step_run)
    h = steps * step_height
    return np.tile(h[:, None].astype(np.float32), (1, n))


def _random_uniform_grid(seed, amplitude, extent, cell, smooth):
    rng = np.random.default_rng(seed)
    n = int(extent / cell)
    grid = rng.uniform(-amplitude, amplitude, (n, n)).astype(np.float32)
    for _ in range(smooth):
        grid = 0.25 * (np.roll(grid, 1, 0) + np.roll(grid, -1, 0)
                       + np.roll(grid, 1, 1) + np.roll(grid, -1, 1))
    # flat spawn pad in the middle
    c = n // 2
    pad = int(1.5 / cell)
    grid[c - pad:c + pad, c - pad:c + pad] = 0.0
    return grid


def flat(extent: float = 40.0, cell: float = 0.1, device="cpu") -> Terrain:
    n = int(extent / cell)
    return _terrain(np.zeros((n, n), np.float32), extent, cell, device)


def slope_platform(slope: float = 0.2, extent: float = 40.0,
                   cell: float = 0.1, start_x: float = 2.0,
                   device="cpu") -> Terrain:
    """Ramp rising with the given slope after start_x."""
    return _terrain(_slope_grid(slope, extent, cell, start_x), extent, cell,
                    device)


def stairs(step_height: float = 0.06, step_run: float = 0.3,
           extent: float = 40.0, cell: float = 0.1, start_x: float = 2.0,
           device="cpu") -> Terrain:
    """Staircase along +x."""
    return _terrain(_stairs_grid(step_height, step_run, extent, cell,
                                 start_x), extent, cell, device)


def random_uniform(seed: int = 0, amplitude: float = 0.04,
                   extent: float = 40.0, cell: float = 0.1, smooth: int = 2,
                   device="cpu") -> Terrain:
    """Random-uniform rough terrain, lightly smoothed so gradients exist."""
    return _terrain(_random_uniform_grid(seed, amplitude, extent, cell,
                                         smooth), extent, cell, device)


def uneven_patches(seed: int = 0, extent: float = 40.0, cell: float = 0.1,
                   device="cpu") -> Terrain:
    """4-quadrant mixed terrain: flat / rough / slope / stairs."""
    n = int(extent / cell)
    half = n // 2
    rough = _random_uniform_grid(seed, 0.04, extent, cell, 2)
    slope = _slope_grid(0.15, extent, cell, 0.0)
    stair = _stairs_grid(0.05, 0.3, extent, cell, 0.0)
    grid = np.zeros((n, n), np.float32)
    grid[half:, :half] = rough[half:, :half]
    grid[:half, half:] = slope[:half, half:]
    grid[half:, half:] = stair[half:, half:]
    # blend quadrant boundaries so the spawn pad doesn't end in a cliff
    for _ in range(4):
        grid = 0.2 * (np.roll(grid, 1, 0) + np.roll(grid, -1, 0)
                      + np.roll(grid, 1, 1) + np.roll(grid, -1, 1)) \
            + 0.2 * grid
    c = n // 2
    pad = int(1.0 / cell)
    grid[c - pad:c + pad, c - pad:c + pad] = 0.0
    return _terrain(grid, extent, cell, device)


def sample_height(terrain: Terrain, xy):
    """Bilinear height at world xy (..., 2) -> (...).

    The grid coordinate is clipped to [0, size - 1.001] as in the JAX
    package; the corner indices are clamped as integers too, so that a
    non-finite point (a diverged env) reads a valid cell and yields a
    non-finite height instead of an out-of-bounds gather.
    """
    g = (xy - terrain.origin) / terrain.cell_size
    h, w = terrain.height.shape
    gx = torch.clamp(g[..., 0], 0.0, h - 1.001)
    gy = torch.clamp(g[..., 1], 0.0, w - 1.001)
    fx0, fy0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - fx0, gy - fy0
    x0 = fx0.long().clamp(0, h - 2)
    y0 = fy0.long().clamp(0, w - 2)
    flat = terrain.height.reshape(-1)
    i00 = x0 * w + y0
    h00 = flat[i00]
    h10 = flat[i00 + w]
    h01 = flat[i00 + 1]
    h11 = flat[i00 + w + 1]
    return ((1 - fx) * (1 - fy) * h00 + fx * (1 - fy) * h10
            + (1 - fx) * fy * h01 + fx * fy * h11)


def sample_normal(terrain: Terrain, xy, eps: float = 0.05):
    """Finite-difference surface normal at world xy -> (..., 3), unit."""
    x, y = xy[..., 0], xy[..., 1]

    def at(dx, dy):
        return sample_height(terrain, torch.stack([x + dx, y + dy], dim=-1))

    dhdx = (at(eps, 0.0) - at(-eps, 0.0)) / (2 * eps)
    dhdy = (at(0.0, eps) - at(0.0, -eps)) / (2 * eps)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
