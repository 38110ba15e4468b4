"""YAML-backed configuration loading for the frozen config dataclasses.

Counterpart of ``rl_mpc_locomotion_tpu/utils/config.py``, over the port's
configs (frozen dataclasses and NamedTuples of Python scalars): load a YAML
file (or dict) and overlay it onto the defaults, with dotted-key overrides
for CLI use, e.g.

    cfg = load_train_config("cfg/aliengo.yaml",
                            overrides={"ppo.learning_rate": 3e-4,
                                       "env.control.qp.iters": 80})

Unknown keys raise — typos never silently no-op. PyYAML is imported by
``load_yaml`` only: nothing else here needs it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional


def _is_config_obj(obj) -> bool:
    return dataclasses.is_dataclass(obj) or hasattr(obj, "_fields")


def _fields(obj) -> dict:
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj)}
    return obj._asdict()  # NamedTuple


def _replace(obj, **kw):
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **kw)
    return obj._replace(**kw)


def overlay(cfg, values: Mapping[str, Any]):
    """Recursively overlay a nested dict of values onto a config object."""
    updates = {}
    fields = _fields(cfg)
    for key, val in values.items():
        if key not in fields:
            raise KeyError(
                f"unknown config key '{key}' for {type(cfg).__name__}; "
                f"valid: {sorted(fields)}")
        cur = fields[key]
        if isinstance(val, Mapping) and _is_config_obj(cur):
            updates[key] = overlay(cur, val)
        elif isinstance(val, list):
            updates[key] = tuple(val)
        else:
            updates[key] = val
    return _replace(cfg, **updates)


def apply_overrides(cfg, overrides: Mapping[str, Any]):
    """Dotted-key overrides: {'env.control.dt': 0.005}."""
    nested: dict = {}
    for dotted, val in overrides.items():
        node = nested
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return overlay(cfg, nested)


def load_yaml(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(defaults, path: Optional[str] = None,
                overrides: Optional[Mapping[str, Any]] = None):
    """defaults (a config object) + YAML file + dotted overrides."""
    cfg = defaults
    if path:
        cfg = overlay(cfg, load_yaml(path))
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def load_train_config(path: Optional[str] = None,
                      overrides: Optional[Mapping[str, Any]] = None):
    from ..rl.train import TrainConfig
    return load_config(TrainConfig(), path, overrides)


def load_control_config(path: Optional[str] = None,
                        overrides: Optional[Mapping[str, Any]] = None):
    from ..control.types import ControlConfig
    return load_config(ControlConfig(), path, overrides)
