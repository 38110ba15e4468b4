"""PPO on the device: rollout, GAE, clipped surrogate, adaptive-KL learning
rate — the rsl_rl recipe, as the JAX package's ``rl/ppo.py`` has it.

Hyperparameters default to the reference's tasks/legged_config_ppo.py:
clip 0.2, value clip, entropy 0.01, 5 epochs x 4 minibatches, gamma 0.99,
lam 0.95, lr 1e-3 adaptive toward KL 0.01, grad-norm 1, T=24 steps/env.

Differences of form from the JAX file:

- ``TrainState`` holds the ``ActorCritic`` module itself (its parameters are
  the policy's), the Adam state, the learning rate as a 0-d tensor on the
  model's device, and a ``torch.Generator`` in place of the PRNG key.
  ``rollout`` draws the action noise from it and ``ppo_update`` one
  permutation an epoch; ``noise=`` and ``perms=`` give the draws instead
  (a test feeds the JAX package's). ``ppo_update`` writes the new
  parameters into the module in place.
- The optimizer is optax's ``clip_by_global_norm -> scale_by_adam ->
  scale(-1)`` times the learning rate, written on tensors: ``Optimizer``
  with ``init`` and ``update`` over dicts of named parameters.
- Nothing reads a tensor back to the host: the learning-rate decision and
  the non-finite guard are ``torch.where`` on device scalars.
- Over a device mesh (``axis_name``) the statistics that JAX reduces with
  ``pmean`` are averaged over the ranks by all-reduces of 0-d tensors on
  the device (``parallel.mesh.pmean``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..models.actor_critic import ActorCritic
from ..parallel.mesh import axis_group, pmean


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_steps: int = 24
    num_minibatches: int = 4
    num_epochs: int = 5
    clip_param: float = 0.2
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    entropy_coef: float = 0.01
    gamma: float = 0.99
    lam: float = 0.95
    learning_rate: float = 1e-3
    schedule: str = "adaptive"        # 'adaptive' | 'fixed'
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    lr_min: float = 1e-5
    lr_max: float = 1e-2


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and the two moments,
    keyed by parameter name."""
    count: torch.Tensor     # () int32
    mu: dict
    nu: dict


class TrainState(NamedTuple):
    model: ActorCritic
    opt_state: AdamState
    lr: torch.Tensor        # () float32, on the model's device
    generator: torch.Generator


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    mean: torch.Tensor
    log_std: torch.Tensor


class Optimizer(NamedTuple):
    init: Callable      # params dict -> AdamState
    update: Callable    # (grads dict, AdamState) -> (updates dict, AdamState)


def make_optimizer(cfg: PPOConfig) -> Optimizer:
    """optax.chain(clip_by_global_norm(max_grad_norm), scale_by_adam(),
    scale(-1)), operation for operation: the clip divides by the global
    norm only where it is not below ``max_grad_norm`` (no epsilon), Adam
    (b1 0.9, b2 0.999, eps 1e-8 outside the square root, eps_root 0)
    corrects the bias by the incremented count. The caller multiplies the
    updates by the lr."""
    max_norm = cfg.max_grad_norm
    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(params: dict) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads: dict, state: AdamState):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < max_norm
        grads = {k: torch.where(keep, g, (g / g_norm) * max_norm)
                 for k, g in grads.items()}
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k]
              for k, g in grads.items()}
        count = state.count + 1
        c = count.to(torch.float32)
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
        updates = {k: -1.0 * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps))
                   for k in grads}
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return Optimizer(init, update)


def init_train_state(generator: torch.Generator, model: ActorCritic,
                     obs_dim: int, cfg: PPOConfig) -> TrainState:
    """Fresh parameters drawn from ``generator`` (which the state then
    keeps for sampling), zero Adam moments, the initial lr."""
    if obs_dim != model.num_obs:
        raise ValueError(f"obs_dim {obs_dim} != the model's input width "
                         f"{model.num_obs}")
    model.reset_parameters(generator)
    opt_state = make_optimizer(cfg).init(dict(model.named_parameters()))
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32,
                      device=model.log_std.device)
    return TrainState(model=model, opt_state=opt_state, lr=lr,
                      generator=generator)


# float32 constants as the JAX file computes them (jnp.log of a float32)
_HALF_LOG_2PI = 0.5 * float(torch.log(torch.tensor(2.0 * math.pi)))
_HALF_LOG_2PIE = 0.5 * float(torch.log(torch.tensor(2.0 * math.pi * math.e)))


def gaussian_log_prob(mean, log_std, action):
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * torch.square(action - mean) / var - log_std
                     - _HALF_LOG_2PI, dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + _HALF_LOG_2PIE, dim=-1)


def compute_gae(cfg: PPOConfig, rewards, values, dones, last_value):
    """GAE over a (T, B) rollout; done masks bootstrap (rsl_rl storage)."""
    gae = torch.zeros_like(last_value)
    next_value = last_value
    advantages = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        not_done = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + cfg.gamma * next_value * not_done - values[t]
        gae = delta + cfg.gamma * cfg.lam * not_done * gae
        advantages[t] = gae
        next_value = values[t]
    advantages = torch.stack(advantages)
    return advantages, advantages + values


AUX_KEYS = ("qp_pri_res", "qp_dua_res", "qp_diverged", "fall")


def rollout(model: ActorCritic, env_step: Callable, env_state, obs,
            generator: torch.Generator, num_steps: int,
            noise: Optional[torch.Tensor] = None):
    """Collect (T, B, ...) transitions, without autograd.

    env_step(env_state, actions, t) -> (env_state, obs, reward, done, info)
    with ``t`` the Python step index. The action noise is drawn from
    ``generator`` unless ``noise`` (T, B, A) gives it. The solver telemetry
    of ``info`` (``AUX_KEYS``), where present, comes back stacked (T, B).

    Returns (env_state, obs, traj, aux).
    """
    steps, aux = [], {}
    with torch.no_grad():
        for t in range(num_steps):
            mean, log_std, value = model(obs)
            eps = (noise[t] if noise is not None else torch.randn(
                mean.shape, generator=generator, device=mean.device))
            action = mean + torch.exp(log_std) * eps
            log_prob = gaussian_log_prob(mean, log_std, action)
            env_state, next_obs, reward, done, info = env_step(env_state,
                                                               action, t)
            steps.append(Transition(obs=obs, action=action,
                                    log_prob=log_prob, value=value,
                                    reward=reward, done=done, mean=mean,
                                    log_std=log_std))
            for k in AUX_KEYS:
                if k in info:
                    aux.setdefault(k, []).append(info[k])
            obs = next_obs
    traj = Transition(*(torch.stack(xs) for xs in zip(*steps)))
    return env_state, obs, traj, {k: torch.stack(v) for k, v in aux.items()}


def _identity(g):
    return g


def ppo_update(model: ActorCritic, cfg: PPOConfig, train: TrainState,
               traj: Transition, last_value,
               grad_reduce: Callable = _identity,
               axis_name: Optional[str] = None,
               perms: Optional[torch.Tensor] = None):
    """One PPO update over a rollout: ``num_epochs`` epochs of
    ``num_minibatches`` minibatches of one permutation of the T*B rows.

    ``grad_reduce`` maps the dict of gradients (identity on one card,
    ``parallel.mesh.psum_grads`` over a mesh). ``axis_name`` names the mesh
    axis the env batch is split over (``ENV_AXIS``): every statistic that
    feeds back into the update is then averaged over it, as JAX's
    ``reduce_mean`` does, or the ranks part silently: the advantage moments
    (global normalisation), each minibatch's KL (the adaptive lr must be the
    same on every rank) and the logged losses, reward and value. ``perms``
    (num_epochs, T*B) gives the permutations instead of the generator.

    A minibatch whose gradients are not all finite changes nothing: the
    parameters, the Adam state and the lr keep their values (a
    ``torch.where`` on a device flag, no host read). Returns (train,
    metrics) with the metrics as 0-d device tensors; the model's parameters
    are updated in place.
    """
    if axis_name is None:
        def reduce_mean(*xs):
            return list(xs)
    else:
        axis_group(axis_name)     # raises outside a process group

        def reduce_mean(*xs):
            return pmean(xs, axis_name)
    advantages, returns = compute_gae(cfg, traj.reward, traj.value,
                                      traj.done, last_value)
    # global moments: E[x] and E[x^2] are mean-reducible across ranks
    adv_mean, adv_sq = reduce_mean(torch.mean(advantages),
                                   torch.mean(torch.square(advantages)))
    adv_std = torch.sqrt(torch.clamp_min(adv_sq - torch.square(adv_mean),
                                         0.0)) + 1e-8
    norm_adv = ((advantages - adv_mean) / adv_std).reshape(-1)

    t, b = traj.reward.shape
    flat = Transition(*(x.reshape((t * b,) + x.shape[2:]) for x in traj))
    returns_f = returns.reshape(-1)
    opt = make_optimizer(cfg)
    params = dict(model.named_parameters())
    names = list(params)
    mb = t * b // cfg.num_minibatches

    def loss_fn(batch, adv, ret):
        mean, log_std, value = model(batch.obs)
        log_prob = gaussian_log_prob(mean, log_std, batch.action)
        ratio = torch.exp(log_prob - batch.log_prob)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param,
                            1.0 + cfg.clip_param) * adv
        policy_loss = -torch.mean(torch.minimum(surr1, surr2))
        if cfg.use_clipped_value_loss:
            v_clipped = batch.value + torch.clamp(
                value - batch.value, -cfg.clip_param, cfg.clip_param)
            value_loss = torch.mean(torch.maximum(
                torch.square(value - ret), torch.square(v_clipped - ret)))
        else:
            value_loss = torch.mean(torch.square(value - ret))
        entropy = torch.mean(gaussian_entropy(log_std))
        # analytic KL(old || new) for the adaptive schedule (rsl_rl ppo.py)
        kl = torch.mean(torch.sum(
            log_std - batch.log_std
            + (torch.exp(2 * batch.log_std)
               + torch.square(batch.mean - mean)) / (2 * torch.exp(2 * log_std))
            - 0.5, dim=-1))
        total = (policy_loss + cfg.value_loss_coef * value_loss
                 - cfg.entropy_coef * entropy)
        return total, (policy_loss, value_loss, kl)

    opt_state, lr = train.opt_state, train.lr
    stats = []
    for epoch in range(cfg.num_epochs):
        idx = (perms[epoch] if perms is not None else torch.randperm(
            t * b, generator=train.generator, device=norm_adv.device))
        for i in range(cfg.num_minibatches):
            sel = idx[i * mb:(i + 1) * mb]
            batch = Transition(*(x[sel] for x in flat))
            with torch.enable_grad():
                loss, (pl, vl, kl) = loss_fn(batch, norm_adv[sel],
                                             returns_f[sel])
                grads = torch.autograd.grad(loss, [params[k] for k in names])
            with torch.no_grad():
                grads = grad_reduce(dict(zip(names, grads)))
                # the lr decision below must be the same on every rank
                kl, = reduce_mean(kl.detach())
                if cfg.schedule == "adaptive":
                    new_lr = torch.where(
                        kl > cfg.desired_kl * 2.0, lr / 1.5,
                        torch.where(kl < cfg.desired_kl / 2.0, lr * 1.5, lr))
                    new_lr = torch.clamp(new_lr, cfg.lr_min, cfg.lr_max)
                else:
                    new_lr = lr
                # non-finite guard: a poisoned minibatch (inf advantage, NaN
                # grad) must not corrupt params / optimizer state; the lr
                # stays too. Behind sim/env.py's per-env NaN reset.
                ok = torch.stack([torch.isfinite(g).all()
                                  for g in grads.values()]).all()
                new_lr = torch.where(ok, new_lr, lr)
                updates, new_state = opt.update(grads, opt_state)
                for k in names:
                    p = params[k]
                    p.copy_(torch.where(ok, p + updates[k] * new_lr, p))
                opt_state = AdamState(
                    count=torch.where(ok, new_state.count, opt_state.count),
                    mu={k: torch.where(ok, new_state.mu[k], opt_state.mu[k])
                        for k in names},
                    nu={k: torch.where(ok, new_state.nu[k], opt_state.nu[k])
                        for k in names})
                lr = new_lr
            stats.append(torch.stack([loss.detach(), pl.detach(),
                                      vl.detach(), kl]))
    train = train._replace(opt_state=opt_state, lr=lr)
    loss, pl, vl, kl = torch.stack(stats).mean(dim=0)
    # losses, reward and value are rank-local (kl is reduced already)
    loss, pl, vl, reward, value = reduce_mean(
        loss, pl, vl, torch.mean(traj.reward), torch.mean(traj.value))
    metrics = {"loss": loss, "policy_loss": pl, "value_loss": vl, "kl": kl,
               "lr": lr, "mean_reward": reward, "mean_value": value}
    return train, metrics
