"""The one generator of the benchmark's inputs: it reads a traffic mix's
parameters (``locobench/traffic/<name>.json``) and makes the inputs on the
device from the seed, with one ``torch.Generator`` on the device and a few
large draws, in float32, the type the program takes.

A mix has ``robots`` and ``commands`` (uniform ranges of vx, vy, yaw rate)
and either
- ``snapshots``: that many states a robot (joints about ``joints_nominal``
  by +-``joint_noise``, joint rates +-``joint_rate``, base height in
  ``base_height``, roll and pitch +-``tilt``, yaw +-``yaw``, linear and
  angular velocity +-``lin_vel`` / ``ang_vel``), each with its own
  commands, cycled through by a loop that only controls; or
- ``start``: a plant's first state (joints about ``joints_nominal`` by
  +-``joint_noise``, the base ``height_offset`` above the robot's body
  height), one command a robot for the whole run.

Every seed draws the same sizes in the same order; only the values move.
"""
from __future__ import annotations

import math
import random

import torch


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return g


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _commands(gen, traffic, shape, device):
    c = traffic["commands"]
    return torch.stack([_uniform(gen, shape, *c["vx"], device),
                        _uniform(gen, shape, *c["vy"], device),
                        _uniform(gen, shape, *c["yaw"], device)], dim=-1)


def _quat_xyzw(roll, pitch, yaw):
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    return torch.stack([sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
                        cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy],
                       dim=-1)


def snapshots(traffic: dict, seed: int, device) -> dict:
    """(S, B, ...) joint angles and rates, root states [pos, quat xyzw, v,
    w] and commands."""
    s, b = traffic["snapshots"], traffic["robots"]
    gen = _generator(seed, 1, device)
    nominal = torch.tensor(traffic["joints_nominal"], dtype=torch.float32,
                           device=device).repeat(4)
    q = nominal + _uniform(gen, (s, b, 12), -traffic["joint_noise"],
                           traffic["joint_noise"], device)
    qd = _uniform(gen, (s, b, 12), -traffic["joint_rate"],
                  traffic["joint_rate"], device)
    rpy = _uniform(gen, (s, b, 3), -1.0, 1.0, device) * torch.tensor(
        [traffic["tilt"], traffic["tilt"], traffic["yaw"]], device=device)
    height = _uniform(gen, (s, b), *traffic["base_height"], device)
    vel = _uniform(gen, (s, b, 6), -1.0, 1.0, device) * torch.tensor(
        [traffic["lin_vel"]] * 3 + [traffic["ang_vel"]] * 3, device=device)
    zero = torch.zeros_like(height)
    body = torch.cat([torch.stack([zero, zero, height], dim=-1),
                      _quat_xyzw(rpy[..., 0], rpy[..., 1], rpy[..., 2]), vel],
                     dim=-1)
    return {"q": q, "qd": qd, "body": body,
            "commands": _commands(gen, traffic, (s, b), device)}


def start(traffic: dict, seed: int, device) -> dict:
    """(B, 12) first joint angles and (B, 3) commands of a closed loop."""
    b = traffic["robots"]
    gen = _generator(seed, 2, device)
    nominal = torch.tensor(traffic["joints_nominal"], dtype=torch.float32,
                           device=device).repeat(4)
    q0 = nominal + _uniform(gen, (b, 12), -traffic["joint_noise"],
                            traffic["joint_noise"], device)
    return {"q0": q0, "commands": _commands(gen, traffic, (b,), device)}


def sample(robots: int, count: int, seed: int) -> torch.Tensor:
    """The robots a run's comparison looks at, drawn from the seed (on the
    host, sorted)."""
    g = torch.Generator()
    g.manual_seed((int(seed) * 1000003 + 3) % (2 ** 63))
    return torch.sort(torch.randperm(robots, generator=g)[:min(count, robots)]).values


class Reservoir:
    """A uniform sample of ``k`` of the window's steps, drawn from the seed
    as they come (reservoir sampling): each kept step holds references to
    the tensors the step produced, nothing is copied."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.rng = random.Random((int(seed) * 1000003 + 4) % (2 ** 63))

    def offer(self, item):
        """Offer one step's record; ``None`` is no record."""
        if item is None:
            return
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.n)
        if j < self.k:
            self.items[j] = item


def quantile(values, q: float) -> float:
    """Nearest-rank quantile of a list (q in (0, 1])."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]
