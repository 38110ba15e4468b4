"""Batched physics, terrain, domain randomisation and the RL environment."""

from . import env, physics, randomize, terrain  # noqa: F401
