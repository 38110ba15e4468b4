"""Domain randomisation over physics and robot parameters, for a batch.

Counterpart of ``rl_mpc_locomotion_tpu/sim/randomize.py``: a spec-driven
engine in which any scalar field of ``PhysicsConfig`` (``physics.<field>``)
or field of ``RobotParams`` (``robot.<field>``) is drawn per env from a
distribution (uniform / gaussian), applied by an operation (additive /
scaling) under a schedule over GLOBAL env steps; ``obs.noise`` and
``action.noise`` add noise to the env's streams.

JAX's PRNG streams cannot be reproduced in torch, so every function that
draws takes a ``torch.Generator`` and draws for the whole batch at once. The
arithmetic after a draw lives in functions of its own that take the drawn
values (``sample_from``, ``_draw_from``, ``apply_stream_from``): a test
feeds them the JAX package's draws. A draw is a dict ``{target: (B, ...)
tensor}``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from ..models.robots import PARAM_RANKS, RobotParams
from .physics import PhysicsConfig


@dataclasses.dataclass(frozen=True)
class RandomizationSpec:
    """One randomised property.

    distribution: 'uniform' | 'gaussian';
    operation: 'additive' | 'scaling'.
    range_: (lo, hi) for uniform, (mean, std) for gaussian.
    schedule: None (always full strength) | 'linear' (noise ramps 0 -> full
    over schedule_steps global env steps) | 'constant' (no noise until
    schedule_steps, full after).
    range_correlated: stream-noise targets only ('obs.noise' /
    'action.noise'): the correlated component, drawn once per
    (re-)randomisation and held fixed, while range_ is redrawn per element
    per step.
    """
    distribution: str = "uniform"
    operation: str = "scaling"
    range_: tuple = (0.9, 1.1)
    schedule: Optional[str] = None
    schedule_steps: int = 0
    range_correlated: tuple = (0.0, 0.0)


# friction / mass / damping / contact stiffness (common legged-robot DR)
DEFAULT_SPECS = (
    ("physics.friction_mu", RandomizationSpec(range_=(0.6, 1.3))),
    ("robot.body_mass", RandomizationSpec(range_=(0.9, 1.15))),
    ("physics.joint_damping", RandomizationSpec(range_=(0.8, 1.3))),
    ("physics.contact_kn", RandomizationSpec(range_=(0.7, 1.4))),
)


@dataclasses.dataclass(frozen=True)
class DomainRandomization:
    """What to randomise: a tuple of (target, RandomizationSpec).
    ``frequency``: re-draw every N *global* env steps (0 = only at reset)."""
    specs: tuple = DEFAULT_SPECS
    frequency: int = 0

    def spec(self, target: str) -> Optional[RandomizationSpec]:
        for t, s in self.specs:
            if t == target:
                return s
        return None


def from_dict(d: Mapping) -> DomainRandomization:
    """Build from a YAML-friendly dict:

    ``{"frequency": 0, "specs": {"physics.friction_mu":
    {"distribution": "uniform", "operation": "scaling",
    "range": [0.6, 1.3], "schedule": "linear", "schedule_steps": 1000}}}``
    """
    specs = []
    for target, sd in (d.get("specs") or {}).items():
        sd = dict(sd or {})
        if "range" in sd:
            sd["range_"] = tuple(sd.pop("range"))
        if "range_" in sd:
            sd["range_"] = tuple(sd["range_"])
        if "range_correlated" in sd:
            sd["range_correlated"] = tuple(sd["range_correlated"])
        specs.append((target, RandomizationSpec(**sd)))
    return DomainRandomization(
        specs=tuple(specs) if specs else DEFAULT_SPECS,
        frequency=int(d.get("frequency", 0)))


# noise injected into the action / observation streams; dims are the env's,
# passed in through ``stream_dims`` so this module stays env-agnostic
STREAM_TARGETS = ("action.noise", "obs.noise")


def _nominal(target: str, cfg: PhysicsConfig, params: RobotParams,
             device="cpu"):
    """The nominal value of a target: a 0-dim tensor for a physics field,
    the parameter tensor (shared or per env) for a robot field."""
    group, field = target.split(".", 1)
    if group == "physics":
        return torch.full((), float(getattr(cfg, field)), dtype=torch.float32,
                          device=device)
    if group == "robot":
        return getattr(params, field).to(torch.float32)
    raise ValueError(f"unknown randomization target group '{group}' "
                     f"(want physics.*, robot.*, obs.noise or action.noise):"
                     f" {target}")


def _per_env(target: str, value, batch: int):
    """``value`` with a leading env axis of ``batch``: shared values are
    broadcast, values that already carry one keep it."""
    group, field = target.split(".", 1)
    rank = PARAM_RANKS[field] if group == "robot" else 0
    if value.dim() == rank:
        return value.expand((batch,) + tuple(value.shape))
    return value


def _ramp(spec: RandomizationSpec, global_step):
    """Schedule factor in [0,1] for (B,) global steps."""
    if spec.schedule == "linear" and spec.schedule_steps > 0:
        return torch.clamp(global_step / float(spec.schedule_steps), 0.0, 1.0)
    if spec.schedule == "constant" and spec.schedule_steps > 0:
        return (global_step >= spec.schedule_steps).to(torch.float32)
    return 1.0


def _ramp_like(spec, global_step, value):
    """The schedule factor shaped to broadcast against (B, ...) ``value``."""
    r = _ramp(spec, global_step)
    if isinstance(r, torch.Tensor):
        r = r.reshape(r.shape + (1,) * (value.dim() - r.dim()))
    return r


def _sample_range(generator, spec: RandomizationSpec, range_, shape,
                  device):
    lo, hi = range_
    if spec.distribution == "gaussian":
        return lo + hi * torch.randn(shape, generator=generator,
                                     device=device)
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def _draw_from(spec: RandomizationSpec, value, sample, global_step):
    """The schedule applied to one draw: interpolate the sample toward the
    identity element (1 for scaling, 0 for additive) by the ramp factor."""
    ramp = _ramp_like(spec, global_step, sample)
    if spec.operation == "additive":
        return value + ramp * sample
    return value * (1.0 + ramp * (sample - 1.0))


def apply_stream_from(spec: RandomizationSpec, corr, value, eps,
                      global_step):
    """Stream noise on (B, dim) ``value``: the held correlated component
    ``corr`` plus the fresh uncorrelated draw ``eps``, under the schedule."""
    noise = corr + eps
    ramp = _ramp_like(spec, global_step, value)
    if spec.operation == "additive":
        return value + ramp * noise
    return value * (1.0 + ramp * (noise - 1.0))


def apply_stream(spec: RandomizationSpec, corr, value, generator,
                 global_step):
    """Apply stream noise to (B, dim) actions or observations; the
    uncorrelated component is redrawn per element per call."""
    eps = _sample_range(generator, spec, spec.range_, value.shape,
                        value.device)
    return apply_stream_from(spec, corr, value, eps, global_step)


def identity(cfg: PhysicsConfig, dr: Optional[DomainRandomization] = None,
             params: Optional[RobotParams] = None,
             stream_dims: Optional[Mapping] = None, batch: int = 1,
             device="cpu") -> dict:
    """The no-op draw: nominal values for every spec target, per env. With
    dr=None returns {}."""
    if dr is None:
        return {}
    out = {}
    for t, _ in dr.specs:
        if t in STREAM_TARGETS:
            dim = (stream_dims or {}).get(t.split(".", 1)[0], 1)
            out[t] = torch.zeros((batch, dim), dtype=torch.float32,
                                 device=device)
        else:
            out[t] = _per_env(t, _nominal(t, cfg, params, device), batch
                              ).clone()
    return out


def draw(dr: DomainRandomization, cfg: PhysicsConfig, params: RobotParams,
         generator, batch: int, stream_dims: Optional[Mapping] = None,
         device="cpu") -> dict:
    """The raw draws of one (re-)randomisation of the batch: per target a
    (B, ...) sample from its range (range_correlated for stream targets)."""
    out = {}
    for target, spec in dr.specs:
        if target in STREAM_TARGETS:
            dim = (stream_dims or {}).get(target.split(".", 1)[0], 1)
            out[target] = _sample_range(generator, spec,
                                        spec.range_correlated, (batch, dim),
                                        device)
        else:
            shape = _per_env(target, _nominal(target, cfg, params, device),
                             batch).shape
            out[target] = _sample_range(generator, spec, spec.range_, shape,
                                        device)
    return out


def sample_from(dr: DomainRandomization, cfg: PhysicsConfig,
                params: RobotParams, raw: dict, global_step) -> dict:
    """The randomised values from raw draws (``draw``'s output): stream
    targets hold the correlated component as drawn, the others the nominal
    value under the spec's operation and schedule."""
    out = {}
    for target, spec in dr.specs:
        if target in STREAM_TARGETS:
            out[target] = raw[target]
        else:
            batch = raw[target].shape[0]
            nominal = _per_env(target, _nominal(target, cfg, params,
                                                raw[target].device), batch)
            out[target] = _draw_from(spec, nominal, raw[target], global_step)
    return out


def sample(dr: DomainRandomization, cfg: PhysicsConfig, params: RobotParams,
           generator, global_step, stream_dims: Optional[Mapping] = None
           ) -> dict:
    """Draw the batch's randomisation. ``global_step`` is a (B,) integer
    tensor (the envs' global ticks): it sets the batch size and device.

    Returns {target: (B, ...) randomised value}; stream targets
    ('obs.noise'/'action.noise') hold the correlated component, a (B, dim)
    draw from range_correlated; ``stream_dims`` maps 'obs'/'action' to their
    dims."""
    raw = draw(dr, cfg, params, generator, global_step.shape[0], stream_dims,
               global_step.device)
    return sample_from(dr, cfg, params, raw, global_step)


def apply_to_config(cfg: PhysicsConfig, draws: dict) -> PhysicsConfig:
    """PhysicsConfig with the physics.* draws substituted as (B,) tensors."""
    updates = {t.split(".", 1)[1]: v for t, v in draws.items()
               if t.startswith("physics.")}
    return cfg._replace(**updates) if updates else cfg


def apply_to_params(params: RobotParams, draws: dict) -> RobotParams:
    """RobotParams with the robot.* draws substituted as per-env fields."""
    updates = {t.split(".", 1)[1]: v for t, v in draws.items()
               if t.startswith("robot.")}
    return params._replace(**updates) if updates else params
