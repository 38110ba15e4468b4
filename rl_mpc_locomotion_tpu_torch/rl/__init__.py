"""PPO training on the device."""

from . import ppo, train  # noqa: F401
