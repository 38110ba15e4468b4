"""Seeding (the reference's utils/utils.py ``set_seed``).

Counterpart of ``rl_mpc_locomotion_tpu/utils/seeding.py``. The device-side
randomness of the port flows from explicit ``torch.Generator`` objects
(``key``), which the env, the rollout and the update take as arguments, so
a run is reproducible from its seed whatever the global generators hold.
``set_seed`` seeds the host-side ones: python's ``random``, numpy's global
generator and torch's default generators.
"""
from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch


def set_seed(seed: Optional[int] = None, torch_deterministic: bool = False
             ) -> int:
    """Seed python, numpy and torch; returns the seed (a random one if None
    is given). ``torch_deterministic`` also asks torch for deterministic
    algorithms (warning, not raising, where an op has none)."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    torch.manual_seed(seed)
    if torch_deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    return seed


def key(seed: int, device, stream: int = 0) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, stream)``:
    distinct streams of one seed are independent (numpy's SeedSequence
    mixes the pair into the 32-bit seed the generator takes)."""
    mixed = np.random.SeedSequence([seed, stream]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))
