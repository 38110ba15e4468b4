"""The port's rollout and training loop (``rl/ppo.rollout``,
``rl/train``, ``utils/{checkpoint,config,metrics,seeding}``, ``cli
train``) against the JAX package and against itself, on the CPU.

JAX's draws cannot be reproduced in torch, so its action noise (split from
its rng as ``rollout`` splits it, or drawn in the test) and its
permutations go into the port as ``noise=`` and ``perms=``; a JAX env
state comes in through ``utils/convert``.

Tolerances: the rollout on a stand-in env within 1e-5 of max(1, |ref|)
(its stand-in is float32 arithmetic of the policy's outputs). One whole
iteration of the real env (Aliengo, flat ground, B = 4, T = 2, the JAX
side composed eagerly: the vmapped ``env.step`` twice with the gate
unbatched, then ``ppo_update`` under ``jax.jit``): the physics state and
observations within 1e-3 of max(1, |ref|) and rewards within 1e-5
(``tests/test_torch_env.py``'s), the parameters as
``tests/test_torch_ppo.py`` holds them after an update (99.9 % of the
entries within 1e-3 of JAX's largest movement of the tensor, every entry
within 0.25 of it), the lr within 1e-6 relative. Resume on the CPU:
bit-identical.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu.control.types import ControlConfig as JControlConfig
from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.models.actor_critic import ActorCritic as JActorCritic
from rl_mpc_locomotion_tpu.ops.qp import QPConfig as JQPConfig
from rl_mpc_locomotion_tpu.rl import ppo as jppo
from rl_mpc_locomotion_tpu.sim import env as jenv
from rl_mpc_locomotion_tpu.sim import terrain as jterrain
from rl_mpc_locomotion_tpu.utils import config as jconfig

from rl_mpc_locomotion_tpu_torch import cli
from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.models.actor_critic import ActorCritic
from rl_mpc_locomotion_tpu_torch.ops.qp import QPConfig
from rl_mpc_locomotion_tpu_torch.parallel.mesh import ENV_AXIS
from rl_mpc_locomotion_tpu_torch.rl import ppo
from rl_mpc_locomotion_tpu_torch.rl import train as train_mod
from rl_mpc_locomotion_tpu_torch.sim import env
from rl_mpc_locomotion_tpu_torch.utils import checkpoint, config, convert
from rl_mpc_locomotion_tpu_torch.utils import metrics as metrics_mod
from rl_mpc_locomotion_tpu_torch.utils import seeding

from test_torch_ppo import assert_update_matches, jax_perms

CHEAP = dict(iters=8, iters2=0, adaptive_rho=False, polish=False,
             ruiz_iters=1)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def to_np(tree):
    return jax.tree.map(np.array, tree)


def _cheap_env():
    return env.EnvConfig(control=ControlConfig(
        qp=QPConfig(use_kernel=False, **CHEAP)))


# ---- rollout -------------------------------------------------------------------

def _stand_in(xp, tanh):
    """A deterministic env on the policy's actions, written for either
    package (``xp`` numpy-like, ``tanh``): state (B,), obs (B, 48)."""
    scale = xp.asarray(np.linspace(-1.0, 1.0, 48, dtype=np.float32))

    def env_step(s, a, t):
        s = 0.9 * s + tanh(a).sum(-1) * 0.1
        obs = tanh(s[:, None] * scale + 0.01 * t)
        reward = s - 0.1 * (a * a).mean(-1)
        done = s > 0.2
        solve = (t % 2 == 1) * 1.0
        info = {"qp_pri_res": abs(s) * solve, "qp_dua_res": s * s * solve,
                "qp_diverged": s > 0.5, "fall": done}
        return s, obs, reward, done, info
    return env_step


def test_rollout_matches_jax_on_a_stand_in_env():
    t_steps, b = 5, 3
    jm = JActorCritic(num_actions=12)
    jts = jppo.init_train_state(jax.random.PRNGKey(1), jm, 48,
                                jppo.PPOConfig())
    rng = np.random.default_rng(2)
    s0 = rng.normal(scale=0.1, size=b).astype(np.float32)
    obs0 = rng.normal(size=(b, 48)).astype(np.float32)
    jstep = _stand_in(jnp, jnp.tanh)
    js, jobs, jrng, jtraj, jaux = to_np(jppo.rollout(
        jm, jts.params, jstep, jnp.asarray(s0), jnp.asarray(obs0), jts.rng,
        t_steps))
    # JAX's noise, split from its rng as rollout splits it
    noise, key = [], jts.rng
    for _ in range(t_steps):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (b, 12))))
    model = convert.actor_critic_from_flax(to_np(jts.params))
    s, obs, traj, aux = ppo.rollout(
        model, _stand_in(torch, torch.tanh), torch.from_numpy(s0),
        torch.from_numpy(obs0), torch.Generator(), t_steps,
        noise=torch.from_numpy(np.stack(noise)))
    assert rel_err(s.numpy(), js) < 1e-5
    assert rel_err(obs.numpy(), jobs) < 1e-5
    for name, g, w in zip(ppo.Transition._fields, traj, jtraj):
        assert g.shape == w.shape, name
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert rel_err(g.numpy(), w) < 1e-5, name
    assert set(aux) == set(jaux) == set(ppo.AUX_KEYS)
    for k in aux:
        assert rel_err(aux[k].numpy().astype(np.float64),
                       jaux[k].astype(np.float64)) < 1e-5, k
    assert not traj.action.requires_grad

    # without noise=: drawn from the generator, reproducibly
    a = ppo.rollout(model, _stand_in(torch, torch.tanh), torch.from_numpy(s0),
                    torch.from_numpy(obs0),
                    torch.Generator().manual_seed(4), 2)[2]
    b2 = ppo.rollout(model, _stand_in(torch, torch.tanh),
                     torch.from_numpy(s0), torch.from_numpy(obs0),
                     torch.Generator().manual_seed(4), 2)[2]
    assert all(torch.equal(x, y) for x, y in zip(a, b2))


# ---- one whole iteration of the real env -------------------------------------------

def test_train_iteration_matches_jax():
    """Aliengo on flat ground, B = 4, T = 2 (a solve on the second step):
    the port's make_train_step against JAX's pieces composed eagerly from
    the same env state, parameters, Adam state, noise and permutations."""
    b, t_steps = 4, 2
    jp = jrobots.aliengo_params()
    jcfg = jenv.EnvConfig(control=JControlConfig(
        qp=JQPConfig(use_pallas=False, **CHEAP)))
    jppo_cfg = jppo.PPOConfig(num_steps=t_steps)
    ter_j = jterrain.flat(extent=10.0, cell=0.2)
    jstate = jax.vmap(lambda k: jenv.reset(jp, jcfg, k))(
        jax.random.split(jax.random.PRNGKey(11), b))
    jobs = jax.vmap(lambda s: jenv.observations(jp, jcfg, s))(jstate)
    state0, obs0 = convert.env_state_from_numpy(to_np(jstate)), \
        torch.from_numpy(np.array(jobs))
    jm = JActorCritic(num_actions=12)
    jts = jppo.init_train_state(jax.random.PRNGKey(5), jm, 48, jppo_cfg)
    noise = np.random.default_rng(6).normal(size=(t_steps, b, 12)).astype(
        np.float32)

    steps = []
    for t in range(t_steps):
        mean, log_std, value = jm.apply(jts.params, jobs)
        action = mean + jnp.exp(log_std) * noise[t]
        lp = jppo.gaussian_log_prob(mean, log_std, action)
        gate = (t + 1) % jcfg.control.iterations_between_mpc == 0
        jstate, next_obs, rew, done, _ = jax.vmap(
            lambda s, a: jenv.step(jp, jcfg, ter_j, s, a,
                                   solve_gate=jnp.bool_(gate)))(jstate,
                                                                action)
        steps.append(jppo.Transition(obs=jobs, action=action, log_prob=lp,
                                     value=value, reward=rew, done=done,
                                     mean=mean, log_std=log_std))
        jobs = next_obs
    traj = jax.tree.map(lambda *xs: jnp.stack(xs), *steps)
    _, _, last = jm.apply(jts.params, jobs)
    jnew, jmetrics = jax.jit(lambda ts, tr, lv: jppo.ppo_update(
        jm, jppo_cfg, ts, tr, lv))(jts, traj, last)
    jstate, jobs = to_np(jstate), np.asarray(jobs)

    cfg = train_mod.TrainConfig(num_envs=b,
                                ppo=ppo.PPOConfig(num_steps=t_steps),
                                env=_cheap_env())
    model = convert.actor_critic_from_flax(to_np(jts.params))
    state = ppo.TrainState(
        model=model, opt_state=convert.adam_state_from_optax(
            to_np(jts.opt_state)),
        lr=torch.tensor(cfg.ppo.learning_rate), generator=torch.Generator())
    step_fn, _ = train_mod.make_train_step(
        robots.aliengo_params("cpu"), cfg,
        convert.terrain_from_numpy(to_np(ter_j)), model)
    new, es, obs, tick, metrics = step_fn(
        state, state0, obs0, 0, torch.Generator(),
        noise=torch.from_numpy(noise),
        perms=jax_perms(jts.rng, cfg.ppo, t_steps * b))

    assert tick == t_steps
    assert not bool(np.asarray(traj.done).any())
    for name, g, w in zip(env.physics.PhysState._fields, es.phys,
                          jstate.phys):
        assert rel_err(g.numpy(), w) < 1e-3, name
    assert rel_err(obs.numpy(), jobs) < 1e-3
    assert abs(float(metrics["mean_reward"])
               - float(jmetrics["mean_reward"])) < 1e-5
    np.testing.assert_array_equal(es.ctrl.loco.iteration_counter.numpy(),
                                  jstate.ctrl.loco.iteration_counter)
    # one solve (t = 1) over 4 envs: the telemetry of its residuals
    assert float(metrics["qp_pri_res_p50"]) > 0.0
    assert float(metrics["qp_diverged_frac"]) == 0.0
    qp_keys = {k for k in metrics if k.startswith("qp_")}
    assert_update_matches(model, new, {k: v for k, v in metrics.items()
                                       if k not in qp_keys},
                          jts, jnew, jmetrics)


def test_qp_telemetry_percentiles_over_solve_ticks():
    """Percentiles over the solve ticks only (residual > 0), index
    ((1 - p) * n) into the descending sort as the JAX file takes it; 0.0
    when nothing was solved."""
    pri = torch.tensor([[0.0, 0.0], [4.0, 1.0], [0.0, 0.0], [3.0, 2.0]])
    aux = {"qp_pri_res": pri, "qp_dua_res": 10.0 * pri,
           "qp_diverged": torch.tensor([[False, False], [True, False],
                                        [False, False], [False, False]])}
    m = train_mod.qp_telemetry(aux)
    # solve values descending: 4, 3, 2, 1 (n = 4)
    assert float(m["qp_pri_res_p50"]) == 2.0     # index int(0.5 * 4) = 2
    assert float(m["qp_pri_res_p99"]) == 4.0     # index int(0.01 * 4) = 0
    assert float(m["qp_dua_res_p50"]) == 20.0
    assert float(m["qp_diverged_frac"]) == 0.25
    none = train_mod.qp_telemetry({k: torch.zeros_like(v)
                                   for k, v in aux.items()})
    assert all(float(v) == 0.0 for v in none.values())


# ---- the training loop ---------------------------------------------------------

def _small_cfg(**kw):
    return train_mod.TrainConfig(
        num_envs=4, ppo=ppo.PPOConfig(num_steps=4, num_minibatches=2,
                                      num_epochs=2), env=_cheap_env(), **kw)


def test_resume_is_bit_identical_on_the_cpu(tmp_path):
    """4 straight iterations (a checkpoint after 2) against 2 + resume 2:
    the same parameters, Adam state, lr and last metrics, bit for bit."""
    cfg = _small_cfg(seed=3, save_interval=2, max_iterations=4)
    params = robots.aliengo_params("cpu")
    quiet = lambda s: None  # noqa: E731
    d = str(tmp_path / "run")
    straight, hist_s = train_mod.train(params, cfg, log_fn=quiet,
                                       checkpoint_dir=d, device="cpu")
    logs = []
    resumed, hist_r = train_mod.train(params, cfg, log_fn=logs.append,
                                      max_iterations=2,
                                      resume_from=d + "/model_2",
                                      device="cpu")
    assert any("env state restored (tick 8)" in line for line in logs)
    for (k, v), w in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert torch.equal(straight.opt_state.count, resumed.opt_state.count)
    for k in straight.opt_state.mu:
        assert torch.equal(straight.opt_state.mu[k], resumed.opt_state.mu[k])
        assert torch.equal(straight.opt_state.nu[k], resumed.opt_state.nu[k])
    assert torch.equal(straight.lr, resumed.lr)
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())
    last_s = {k: v for k, v in hist_s[-1].items() if k != "steps_per_s"}
    last_r = {k: v for k, v in hist_r[-1].items() if k != "steps_per_s"}
    assert last_s == last_r and last_s["iter"] == 3
    assert all(math.isfinite(v) for v in last_s.values())
    # and a resume differs from a fresh run with the same seed
    fresh = train_mod.train(params, cfg, log_fn=quiet, max_iterations=2,
                            device="cpu")[0]
    assert not all(torch.equal(v, w) for v, w in zip(
        fresh.model.state_dict().values(),
        resumed.model.state_dict().values()))


def test_latest_checkpoint_discovery_and_missing_dir(tmp_path):
    cfg = ppo.PPOConfig()
    model = ActorCritic(12, hidden=(16,))
    ts = ppo.init_train_state(torch.Generator().manual_seed(5), model, 48,
                              cfg)
    checkpoint.save_checkpoint(str(tmp_path), 3, ts)
    checkpoint.save_checkpoint(str(tmp_path), 7, ts,
                               env_snapshot={"tick": 56})
    (tmp_path / "model_x").write_text("")       # not a step: skipped
    (tmp_path / "notes").write_text("")
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("model_7")
    assert checkpoint.latest_checkpoint(str(tmp_path / "nope")) is None

    want = {k: v.clone() for k, v in model.state_dict().items()}
    gen_state = ts.generator.get_state()
    other = ActorCritic(12, hidden=(16,))
    fresh = ppo.init_train_state(torch.Generator().manual_seed(6), other, 48,
                                 cfg)
    restored, start_it, path = train_mod.resume_train_state(
        str(tmp_path), fresh, log_fn=lambda *_: None)
    assert start_it == 7 and path.endswith("model_7")
    assert restored.model is other
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(restored.generator.get_state(), gen_state)
    assert checkpoint.restore_env_snapshot(path, {"tick": 0}) == {"tick": 56}
    assert checkpoint.restore_env_snapshot(
        str(tmp_path / "model_3"), {"tick": 0}) is None
    with pytest.raises(FileNotFoundError):
        train_mod.resume_train_state(str(tmp_path / "nope"), fresh,
                                     log_fn=lambda *_: None)


def _walk_configs(a, b, path=""):
    """Every field of the port's config tree equal to the JAX package's
    (``use_kernel`` is the port's name for ``use_pallas``)."""
    if dataclasses.is_dataclass(a) or hasattr(a, "_fields"):
        names = ([f.name for f in dataclasses.fields(a)]
                 if dataclasses.is_dataclass(a) else list(a._fields))
        for name in names:
            other = "use_pallas" if name == "use_kernel" else name
            _walk_configs(getattr(a, name), getattr(b, other),
                          f"{path}.{name}")
    else:
        assert a == b, (path, a, b)


def test_config_overlay_matches_jax():
    overrides = {"ppo.learning_rate": 3e-4, "env.control.qp.iters": 80,
                 "env.episode_length": 500, "num_envs": 64}
    got = config.load_train_config("cfg/aliengo.yaml", overrides)
    want = jconfig.load_train_config("cfg/aliengo.yaml", overrides)
    _walk_configs(got, want)
    assert got.num_envs == 64 and got.ppo.learning_rate == 3e-4
    assert got.env.control.qp.iters == 80 and got.ppo.num_steps == 24
    assert got.env.control.iterations_between_mpc == 2
    ctrl = config.load_control_config(overrides={"dt": 0.005})
    _walk_configs(ctrl, jconfig.load_control_config(overrides={"dt": 0.005}))
    with pytest.raises(KeyError, match="unknown config key"):
        config.apply_overrides(got, {"ppo.learning_rat": 1.0})


def test_metrics_writer_jsonl(tmp_path):
    with metrics_mod.MetricsWriter(str(tmp_path),
                                   use_tensorboard=False) as w:
        assert not w.has_tensorboard
        w.write(0, {"kl": torch.tensor(0.5), "lr": 1e-3,
                    "vec": torch.zeros(3), "name": "x"}, prefix="train/")
        w.write(10, {"kl": np.float32(0.25)})
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 10]
    assert rows[0]["train/kl"] == 0.5 and rows[0]["train/lr"] == 1e-3
    assert "train/vec" not in rows[0] and "train/name" not in rows[0]
    assert rows[1]["kl"] == 0.25


def test_heterogeneous_train_step_stays_finite():
    """Aliengo, Go1 and A1 in one batch (stacked per-env params): one
    iteration runs with finite metrics and observations."""
    params = train_mod.stacked_robot_params([0, 1, 2, 0, 1, 2], "cpu")
    assert train_mod.is_per_env(params)
    assert len(set(np.round(params.body_mass.numpy(), 3))) == 3
    cfg = dataclasses.replace(_small_cfg(), num_envs=6)
    model = ActorCritic(12)
    ts = ppo.init_train_state(seeding.key(0, "cpu"), model, 48, cfg.ppo)
    step_fn, reset_fn = train_mod.make_train_step(
        params, cfg, convert.terrain_from_numpy(
            to_np(jterrain.flat(extent=10.0, cell=0.2))), model)
    gen = seeding.key(0, "cpu", stream=1)
    env_state, obs = reset_fn(gen)
    ts, env_state, obs, tick, metrics = step_fn(ts, env_state, obs, 0, gen)
    assert tick == 4 and obs.shape == (6, 48)
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert bool(torch.isfinite(obs).all())
    # a mesh is a DeviceMesh over ENV_AXIS; over one rank the per-env
    # params are the rank's whole slice
    with pytest.raises(TypeError, match="DeviceMesh"):
        train_mod.make_train_step(params, cfg, None, model, mesh=ENV_AXIS)
    from rl_mpc_locomotion_tpu_torch.parallel import distributed, mesh
    try:
        _, reset_m = train_mod.make_train_step(
            params, cfg, None, model, mesh=mesh.make_mesh(device_type="cpu"))
        es_m, obs_m = reset_m(seeding.key(0, "cpu", stream=1))
    finally:
        distributed.shutdown()
    assert obs_m.shape == (6, 48) and es_m.commands.shape == (6, 3)
    with pytest.raises(TypeError):
        train_mod.make_env_fns(cfg, None)[1](params, env_state, None,
                                             torch.tensor(0), gen)


def test_seeding():
    assert seeding.set_seed(7) == 7
    a = torch.rand(3)
    seeding.set_seed(7)
    assert torch.equal(a, torch.rand(3))
    g0, g1 = seeding.key(1, "cpu"), seeding.key(1, "cpu", stream=1)
    x0, x1 = torch.rand(4, generator=g0), torch.rand(4, generator=g1)
    assert not torch.equal(x0, x1)
    assert torch.equal(x0, torch.rand(4, generator=seeding.key(1, "cpu")))


def test_cli_train_on_the_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    cli.main(["train", "--device", "cpu", "--num-envs", "4",
              "--max-iterations", "1", "--override", "ppo.num_steps=4",
              "--terrain", "flat", "--checkpoint", ckpt])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[train] it=0")]
    assert len(lines) == 1, out
    reward = float(lines[0].split("reward/step=")[1].split()[0])
    assert math.isfinite(reward)
    assert checkpoint.latest_checkpoint(ckpt).endswith("model_1")
    # --multi-device without torchrun: a group of one rank, the same run
    cli.main(["train", "--device", "cpu", "--num-envs", "4",
              "--max-iterations", "1", "--override", "ppo.num_steps=4",
              "--terrain", "flat", "--multi-device"])
    multi = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train] it=0")]
    assert len(multi) == 1
    assert multi[0].split(" sps=")[0] == lines[0].split(" sps=")[0]
    assert not torch.distributed.is_initialized()
