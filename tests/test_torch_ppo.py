"""The port's actor-critic and PPO (``models/actor_critic``, ``rl/ppo``)
against the JAX package, on the CPU.

The full-width ``ActorCritic`` ([512, 256, 128], 48 obs, 12 actions) on a
small rollout (T = 4, B = 6). The same flax parameters and optax state go
into both packages through ``utils/convert``; JAX's permutations (split
from its rng as ``ppo_update`` splits it) are passed to the port's
``ppo_update`` as ``perms``. The JAX side runs ``ppo_update`` alone under
``jax.jit``.

Tolerances: forward within 1e-5 of max(1, |ref|); log-prob, entropy and
GAE within 1e-5 of max(1, |ref|). After a whole update (5 epochs x 4
minibatches): the lr within 1e-6 relative (the same branches), the metrics
within 1e-4 of max(1, |ref|), the Adam moments within 5e-3 of the tensor's
largest |moment|, and the parameters measured against how far JAX moved
them (the tensor's largest |new - old|): 99.9 % of the entries within 1e-3
of it and every entry within 0.25 of it. Adam divides a gradient by its
own running RMS, so an entry whose gradient is at rounding level (1e-9,
beside eps = 1e-8) takes a step whose size follows the rounding: after one
step the two packages' largest difference was 9 % of the step and their
99.9th percentile 7.5e-6; after 20 steps 2.6 % and 5.7e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.models.actor_critic import ActorCritic as JActorCritic
from rl_mpc_locomotion_tpu.rl import ppo as jppo

from rl_mpc_locomotion_tpu_torch.models.actor_critic import ActorCritic
from rl_mpc_locomotion_tpu_torch.rl import ppo
from rl_mpc_locomotion_tpu_torch.utils import convert

T, B, OBS, ACT = 4, 6, 48, 12


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(cfg, seed=3, model=None):
    model = model or JActorCritic(num_actions=ACT)
    return model, jppo.init_train_state(jax.random.PRNGKey(seed), model, OBS,
                                        cfg)


def _port_state(jts, cfg):
    return ppo.TrainState(
        model=convert.actor_critic_from_flax(to_np(jts.params)),
        opt_state=convert.adam_state_from_optax(to_np(jts.opt_state)),
        lr=torch.tensor(cfg.learning_rate), generator=torch.Generator())


def test_forward_matches_flax_and_init_follows_lecun_normal():
    jm, jts = _jax_state(jppo.PPOConfig())
    model = convert.actor_critic_from_flax(to_np(jts.params))
    obs = np.random.default_rng(0).normal(size=(5, 7, OBS)).astype(np.float32)
    want = to_np(jm.apply(jts.params, obs))
    got = model(torch.from_numpy(obs))
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_err(g.detach().numpy(), w) < 1e-5
    for w, g in zip(jax.tree.leaves(to_np(jts.params)),
                    jax.tree.leaves(convert.actor_critic_to_numpy(model))):
        np.testing.assert_array_equal(g, w)

    # the port's own init: flax's distribution (truncated normal, variance
    # 1 / fan_in, |w| <= 2 / 0.8796 / sqrt(fan_in)), zero biases, log_std 0
    ported = ActorCritic(ACT)
    ported.reset_parameters(torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(ported.named_parameters(),
                                 model.named_parameters()):
        assert p.shape == q.shape, name
        if name.endswith("weight"):
            fan_in = p.shape[1]
            assert abs(float(p.std()) * np.sqrt(fan_in) - 1.0) < 0.05, name
            assert float(p.abs().max()) <= 2.0 / 0.87962566 / np.sqrt(fan_in)
        else:
            assert float(p.detach().abs().max()) == 0.0, name
    again = ActorCritic(ACT)
    again.reset_parameters(torch.Generator().manual_seed(0))
    for p, q in zip(ported.parameters(), again.parameters()):
        assert torch.equal(p, q)


def test_log_prob_entropy_and_gae_match_jax():
    rng = np.random.default_rng(1)
    mean = rng.normal(size=(T, B, ACT)).astype(np.float32)
    log_std = rng.normal(scale=0.3, size=(T, B, ACT)).astype(np.float32)
    action = rng.normal(size=(T, B, ACT)).astype(np.float32)
    got = ppo.gaussian_log_prob(*map(torch.from_numpy, (mean, log_std,
                                                        action)))
    assert rel_err(got.numpy(), jppo.gaussian_log_prob(mean, log_std,
                                                       action)) < 1e-5
    assert rel_err(ppo.gaussian_entropy(torch.from_numpy(log_std)).numpy(),
                   jppo.gaussian_entropy(log_std)) < 1e-5

    cfg_j, cfg = jppo.PPOConfig(), ppo.PPOConfig()
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.3
    last = rng.normal(size=B).astype(np.float32)
    want = to_np(jppo.compute_gae(cfg_j, rewards, values, dones, last))
    got = ppo.compute_gae(cfg, *map(torch.from_numpy,
                                    (rewards, values, dones, last)))
    assert dones.any()
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < 1e-5


def _rollout(jm, jts, seed=0):
    """A recorded rollout of the JAX policy on random observations, as the
    JAX package's Transition, and the last value."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, B, OBS)).astype(np.float32)
    mean, log_std, value = jm.apply(jts.params, obs)
    action = mean + rng.normal(size=(T, B, ACT)).astype(np.float32)
    traj = jppo.Transition(
        obs=jnp.asarray(obs), action=action,
        log_prob=jppo.gaussian_log_prob(mean, log_std, action), value=value,
        reward=jnp.asarray(rng.normal(size=(T, B)).astype(np.float32)),
        done=jnp.asarray(rng.random((T, B)) < 0.2), mean=mean,
        log_std=log_std)
    return traj, jnp.asarray(rng.normal(size=B).astype(np.float32))


def jax_perms(rng, cfg, n):
    """The permutations JAX's ppo_update draws from ``rng``."""
    perms = []
    for _ in range(cfg.num_epochs):
        rng, key = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(key, n)))
    return torch.from_numpy(np.stack(perms).astype(np.int64))


def assert_update_matches(model, new, metrics, jts, jnew, jmetrics):
    """The port's update result against JAX's, at the module's
    tolerances."""
    old = convert._flax_to_torch(to_np(jts.params), "cpu")
    want = convert._flax_to_torch(to_np(jnew.params), "cpu")
    got = model.state_dict()
    ratios = []
    for k in want:
        moved = float((want[k] - old[k]).abs().max())
        assert moved > 0.0, k
        ratios.append(((got[k] - want[k]).abs() / moved).reshape(-1))
    ratios = torch.cat(ratios).numpy()
    assert np.quantile(ratios, 0.999) < 1e-3 and ratios.max() < 0.25, (
        np.quantile(ratios, 0.999), ratios.max())

    wadam = convert.adam_state_from_optax(to_np(jnew.opt_state))
    assert int(new.opt_state.count) == int(wadam.count)
    for k in want:
        for mom in ("mu", "nu"):
            w = getattr(wadam, mom)[k]
            g = getattr(new.opt_state, mom)[k]
            assert float((g - w).abs().max()) <= 5e-3 * float(w.abs().max())
    assert abs(float(new.lr) / float(jnew.lr) - 1.0) < 1e-6
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert rel_err(float(metrics[k]), float(v)) < 1e-4, k


# (case, PPOConfig fields, what the case must show)
UPDATE_CASES = [
    ("fixed_no_clip", dict(schedule="fixed", max_grad_norm=100.0), "no_clip"),
    ("adaptive_kl", dict(schedule="adaptive", learning_rate=1e-4),
     "kl_crosses_both"),
    ("fixed_clip", dict(schedule="fixed"), "clip"),
]


@pytest.mark.parametrize("kw,shows", [c[1:] for c in UPDATE_CASES],
                         ids=[c[0] for c in UPDATE_CASES])
def test_ppo_update_matches_jax(kw, shows):
    """One whole update from the same parameters, Adam state and
    permutations. The hook on grad_reduce records each minibatch's global
    gradient norm and KL (at the parameters the minibatch starts from), so
    each case shows what it exercises: the clip off, the clip on, the KL
    below desired / 2 and above 2 x desired."""
    cfg_j = jppo.PPOConfig(num_steps=T, **kw)
    cfg = ppo.PPOConfig(num_steps=T, **kw)
    jm, jts = _jax_state(cfg_j)
    traj, last = _rollout(jm, jts)
    jnew, jmetrics = jax.jit(lambda ts, tr, lv: jppo.ppo_update(
        jm, cfg_j, ts, tr, lv))(jts, traj, last)

    state = _port_state(jts, cfg)
    model = state.model
    ptraj = ppo.Transition(*(torch.from_numpy(np.array(x)) for x in traj))
    perms = jax_perms(jts.rng, cfg, T * B)
    flat = ppo.Transition(*(x.reshape((T * B,) + x.shape[2:])
                            for x in ptraj))
    mb = T * B // cfg.num_minibatches
    norms, kls = [], []

    def hook(grads):
        e, i = divmod(len(norms), cfg.num_minibatches)
        sel = perms[e][i * mb:(i + 1) * mb]
        with torch.no_grad():
            mean, log_std, _ = model(flat.obs[sel])
            kls.append(float(torch.mean(torch.sum(
                log_std - flat.log_std[sel]
                + (torch.exp(2 * flat.log_std[sel])
                   + torch.square(flat.mean[sel] - mean))
                / (2 * torch.exp(2 * log_std)) - 0.5, dim=-1))))
        norms.append(float(torch.sqrt(sum(torch.sum(g * g)
                                          for g in grads.values()))))
        return grads

    new, metrics = ppo.ppo_update(model, cfg, state, ptraj,
                                  torch.from_numpy(np.array(last)),
                                  grad_reduce=hook, perms=perms)
    assert len(norms) == cfg.num_epochs * cfg.num_minibatches
    if shows == "no_clip":
        assert max(norms) < cfg.max_grad_norm
    elif shows == "clip":
        assert min(norms) > cfg.max_grad_norm
    else:
        assert min(kls) < cfg.desired_kl / 2.0
        assert max(kls) > cfg.desired_kl * 2.0
    assert_update_matches(model, new, metrics, jts, jnew, jmetrics)


def _poisoned(model_apply, t, b, obs_dim, act_dim):
    obs = np.ones((t, b, obs_dim), np.float32)
    action = np.zeros((t, b, act_dim), np.float32)
    mean, log_std, value = model_apply(obs)
    return obs, action, mean, log_std, value


def test_nonfinite_guard_in_both_packages():
    """A NaN reward (NaN loss and gradients) leaves the parameters, the Adam
    state and the lr as they were, in the JAX package and in the port."""
    cfg_j = jppo.PPOConfig(num_steps=4, num_minibatches=1, num_epochs=1,
                           schedule="fixed", learning_rate=1e-2)
    cfg = ppo.PPOConfig(num_steps=4, num_minibatches=1, num_epochs=1,
                        schedule="fixed", learning_rate=1e-2)
    jm = JActorCritic(num_actions=2, hidden=(16,))
    jts = jppo.init_train_state(jax.random.PRNGKey(0), jm, 4, cfg_j)
    t, b = 4, 2
    obs, action, mean, log_std, value = _poisoned(
        lambda o: jm.apply(jts.params, o), t, b, 4, 2)
    lp = jppo.gaussian_log_prob(mean, log_std, action)
    reward = np.full((t, b), np.nan, np.float32)
    done = np.zeros((t, b), np.float32)
    traj = jppo.Transition(obs=jnp.asarray(obs), action=jnp.asarray(action),
                           log_prob=lp, value=value,
                           reward=jnp.asarray(reward), done=jnp.asarray(done),
                           mean=mean, log_std=log_std)
    jnew, _ = jppo.ppo_update(jm, cfg_j, jts, traj, jnp.zeros(b))
    for old, new in zip(jax.tree.leaves(jts.params),
                        jax.tree.leaves(jnew.params)):
        np.testing.assert_array_equal(np.asarray(old), np.asarray(new))
    assert float(jnew.lr) == float(jts.lr)

    model = ActorCritic(2, hidden=(16,), num_obs=4)
    state = ppo.init_train_state(torch.Generator().manual_seed(0), model, 4,
                                 cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        mean, log_std, value = model(torch.from_numpy(obs))
    ptraj = ppo.Transition(
        obs=torch.from_numpy(obs), action=torch.from_numpy(action),
        log_prob=ppo.gaussian_log_prob(mean, log_std,
                                       torch.from_numpy(action)),
        value=value, reward=torch.from_numpy(reward),
        done=torch.from_numpy(done), mean=mean, log_std=log_std)
    new, metrics = ppo.ppo_update(model, cfg, state, ptraj, torch.zeros(b))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert int(new.opt_state.count) == 0
    for k in before:
        assert float(new.opt_state.mu[k].abs().max()) == 0.0
        assert float(new.opt_state.nu[k].abs().max()) == 0.0
    assert float(new.lr) == float(state.lr)
    assert not np.isfinite(float(metrics["loss"]))


def test_gae_matches_manual():
    cfg = ppo.PPOConfig(gamma=0.9, lam=0.8)
    rewards = torch.tensor([[1.0], [1.0], [1.0]])
    values = torch.tensor([[0.5], [0.5], [0.5]])
    adv, ret = ppo.compute_gae(cfg, rewards, values, torch.zeros((3, 1)),
                               torch.tensor([0.5]))
    want = np.zeros(3)
    gae = 0.0
    for t in reversed(range(3)):
        delta = 1.0 + 0.9 * 0.5 - 0.5
        gae = delta + 0.9 * 0.8 * gae
        want[t] = gae
    np.testing.assert_allclose(adv.numpy()[:, 0], want, atol=1e-5)
    np.testing.assert_allclose(ret.numpy()[:, 0], want + 0.5, atol=1e-5)


def test_gae_done_masks_bootstrap():
    cfg = ppo.PPOConfig(gamma=0.9, lam=0.8)
    adv, _ = ppo.compute_gae(cfg, torch.tensor([[1.0], [1.0]]),
                             torch.tensor([[0.5], [0.5]]),
                             torch.tensor([[False], [True]]),
                             torch.tensor([99.0]))
    # t=1 terminal: delta = 1 - 0.5 = 0.5 (no bootstrap from 99)
    np.testing.assert_allclose(float(adv[1, 0]), 0.5, atol=1e-5)


def test_update_moves_policy_toward_advantage():
    model = ActorCritic(2, hidden=(16,), num_obs=4)
    cfg = ppo.PPOConfig(num_steps=8, num_minibatches=2, num_epochs=2,
                        schedule="fixed", learning_rate=1e-2)
    gen = torch.Generator().manual_seed(0)
    state = ppo.init_train_state(gen, model, 4, cfg)
    t, b = 8, 4
    obs = torch.ones((t, b, 4))
    action = torch.randn((t, b, 2), generator=gen)
    with torch.no_grad():
        mean, log_std, value = model(obs)
        m0 = model(torch.ones(4))[0]
    traj = ppo.Transition(obs=obs, action=action,
                          log_prob=ppo.gaussian_log_prob(mean, log_std,
                                                         action),
                          value=value, reward=action[..., 0],
                          done=torch.zeros((t, b)), mean=mean,
                          log_std=log_std)
    _, metrics = ppo.ppo_update(model, cfg, state, traj, torch.zeros(b))
    with torch.no_grad():
        m1 = model(torch.ones(4))[0]
    assert float(m1[0]) > float(m0[0])  # pushed toward +dim0
    assert np.isfinite(float(metrics["loss"]))


def test_axis_name_and_obs_width_are_checked():
    """The obs width is checked; ``axis_name`` raises outside a process
    group (as a JAX collective on an unbound axis does) and on an unknown
    axis, and under a one-rank group the reduced update equals the plain
    one bit for bit (the two-rank case: tests/test_torch_parallel.py)."""
    from rl_mpc_locomotion_tpu_torch.parallel import distributed, mesh
    model = ActorCritic(2, hidden=(8,), num_obs=4)
    cfg = ppo.PPOConfig(num_steps=4, num_minibatches=2, num_epochs=2)
    with pytest.raises(ValueError, match="input width"):
        ppo.init_train_state(torch.Generator(), model, 5, cfg)
    state = ppo.init_train_state(torch.Generator().manual_seed(1), model, 4,
                                 cfg)
    with pytest.raises(RuntimeError, match="make_mesh"):
        ppo.ppo_update(model, cfg, state, None, None, axis_name="env")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        ppo.ppo_update(model, cfg, state, None, None, axis_name="batch")

    gen = torch.Generator().manual_seed(2)
    obs = torch.randn((4, 3, 4), generator=gen)
    with torch.no_grad():
        mean, log_std, value = model(obs)
    action = mean + torch.randn(mean.shape, generator=gen)
    traj = ppo.Transition(obs=obs, action=action,
                          log_prob=ppo.gaussian_log_prob(mean, log_std,
                                                         action),
                          value=value, reward=torch.randn((4, 3),
                                                          generator=gen),
                          done=torch.zeros((4, 3)), mean=mean,
                          log_std=log_std)
    perms = torch.stack([torch.randperm(12, generator=gen)
                         for _ in range(cfg.num_epochs)])
    start = {k: v.clone() for k, v in model.state_dict().items()}
    results = []
    for reduced in (False, True):
        model.load_state_dict(start)
        if reduced:
            mesh.make_mesh(device_type="cpu")
        try:
            new, metrics = ppo.ppo_update(
                model, cfg, state, traj, torch.zeros(3),
                grad_reduce=mesh.psum_grads if reduced else ppo._identity,
                axis_name="env" if reduced else None, perms=perms)
        finally:
            distributed.shutdown()
        results.append(({k: v.clone() for k, v in model.state_dict().items()},
                        new.lr, metrics))
    (p0, lr0, m0), (p1, lr1, m1) = results
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert not all(torch.equal(p0[k], start[k]) for k in p0)
    assert torch.equal(lr0, lr1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
