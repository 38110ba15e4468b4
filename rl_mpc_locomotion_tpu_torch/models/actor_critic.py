"""Actor-critic MLP policy (rsl_rl ActorCritic recipe).

Counterpart of ``rl_mpc_locomotion_tpu/models/actor_critic.py``: actor and
critic MLPs [512, 256, 128] with ELU, a Gaussian policy with a learnable
state-independent log-std (init noise 1.0), float32. The products are
``torch.nn.Linear``.

Initialised as flax initialises ``nn.Dense``: ``lecun_normal`` weights (a
normal truncated at two standard deviations, rescaled to variance
1 / fan_in) and zero biases, so that learning starts from the same
distribution of policies as the JAX package's. ``reset_parameters`` draws
them from the ``torch.Generator`` given (torch's global one for None).

The flax module takes its input width from the first call; a torch module
needs it at construction, so ``MLP`` and ``ActorCritic`` take it as their
last argument (``env.NUM_OBS`` by default).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

NUM_OBS = 48     # sim/env.NUM_OBS; not imported, to keep models/ below sim/

# flax's variance_scaling with "truncated_normal": the standard deviation of
# a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """In place: flax's ``lecun_normal`` for a ``(out, in)`` weight."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        weight.mul_(std)
    return weight


class MLP(nn.Module):
    """``hidden`` ELU layers, then a linear output of ``out_dim``."""

    def __init__(self, hidden: Sequence[int], out_dim: int,
                 in_dim: int = NUM_OBS):
        super().__init__()
        widths = [in_dim, *hidden, out_dim]
        self.dense = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(widths[:-1], widths[1:]))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in self.dense:
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x):
        for layer in self.dense[:-1]:
            x = nn.functional.elu(layer(x))
        return self.dense[-1](x)


class ActorCritic(nn.Module):
    """``forward(obs) -> (mean, log_std broadcast to mean's shape, value)``
    for ``obs`` of any leading shape."""

    def __init__(self, num_actions: int,
                 hidden: Sequence[int] = (512, 256, 128),
                 init_noise_std: float = 1.0, num_obs: int = NUM_OBS):
        super().__init__()
        self.num_actions = num_actions
        self.num_obs = num_obs
        self.init_noise_std = init_noise_std
        self.actor = MLP(hidden, num_actions, num_obs)
        self.critic = MLP(hidden, 1, num_obs)
        self.log_std = nn.Parameter(torch.empty(num_actions))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fresh flax-style parameters: the actor's layers, then the
        critic's, drawn from ``generator``."""
        self.actor.reset_parameters(generator)
        self.critic.reset_parameters(generator)
        with torch.no_grad():
            self.log_std.fill_(math.log(self.init_noise_std))

    def forward(self, obs):
        mean = self.actor(obs)
        value = self.critic(obs)[..., 0]
        # a tensor of its own, not a view: PPO updates the parameter in place
        return mean, self.log_std.expand_as(mean).clone(), value
