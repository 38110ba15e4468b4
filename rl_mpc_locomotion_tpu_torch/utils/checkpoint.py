"""Checkpoints of (model, Adam state, lr, generator) + env state, with
``torch.save``.

Counterpart of ``rl_mpc_locomotion_tpu/utils/checkpoint.py`` (the
reference's rsl_rl ``model_<i>.pt`` flow and its latest-checkpoint
discovery, ``get_load_path``). Layout per step: the file ``model_<i>``
holds the ``TrainState``; the sibling file ``model_<i>_env`` holds the env
snapshot (env state, obs, tick and the env's generator), so that resuming
continues the run exactly: episodes keep their progress, commands, DR
draws, and both random streams go on where they were. A checkpoint without
the sibling still resumes, with fresh episodes.

What is saved is plain data: nested dicts and lists of CPU tensors and
Python scalars (a module as its ``state_dict``, a generator as its
``get_state()``, CUDA generators included), read back with
``torch.load(weights_only=True)``. Restoring walks a target of the same
structure (a fresh state): its tensors are replaced by the saved ones on
the target's device, and its modules and generators are loaded in place.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"model_{step}")


def _pack(obj):
    if isinstance(obj, torch.nn.Module):
        return {k: v.detach().cpu() for k, v in obj.state_dict().items()}
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if hasattr(obj, "_fields"):
        return {k: _pack(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pack(v) for v in obj]
    return obj


def _unpack(target, saved):
    if isinstance(target, torch.nn.Module):
        target.load_state_dict(saved)
        return target
    if isinstance(target, torch.Generator):
        target.set_state(saved)
        return target
    if isinstance(target, torch.Tensor):
        return saved.to(target.device)
    if hasattr(target, "_fields"):
        return type(target)(**{k: _unpack(v, saved[k])
                               for k, v in target._asdict().items()})
    if isinstance(target, dict):
        return {k: _unpack(v, saved[k]) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unpack(t, s) for t, s in zip(target, saved))
    return saved


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(_pack(obj), tmp)
    os.replace(tmp, path)


def save_checkpoint(directory: str, step: int, state: Any,
                    env_snapshot: Optional[dict] = None) -> str:
    """Save ``state`` at model_<step>; ``env_snapshot`` (a dict of env
    state / obs / tick / generator) goes to the model_<step>_env sibling."""
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, step)
    _save(state, path)
    if env_snapshot is not None:
        _save(env_snapshot, path + "_env")
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """Highest-step model_<i> in directory (get_load_path equivalent)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("model_") and not name.endswith("_env"):
            try:
                steps.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    if not steps:
        return None
    return _ckpt_path(directory, max(steps))


def restore_checkpoint(path: str, target: Any) -> Any:
    """``target`` (a structure like the saved one) with the saved values;
    its modules and generators are loaded in place."""
    return _unpack(target, torch.load(os.path.abspath(path),
                                      weights_only=True))


def restore_model(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load only the model of a TrainState checkpoint into ``model`` (in
    place), for deployment: the rest (Adam state, lr, the trainer's
    generator, whose state is that of the device it trained on) is not
    needed there."""
    saved = torch.load(os.path.abspath(path), weights_only=True)
    return _unpack(model, saved["model"])


def restore_env_snapshot(path: str, target: dict) -> Optional[dict]:
    """Restore the model_<i>_env sibling of a TrainState checkpoint.

    ``target`` gives the structure (a fresh env batch from reset, the obs,
    the tick and the env's generator). Returns None when the checkpoint has
    no env snapshot."""
    if not os.path.isfile(path + "_env"):
        return None
    return restore_checkpoint(path + "_env", target)
