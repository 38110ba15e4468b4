"""The port's A/B evaluation (``rl/evaluate``), ``cli eval``, ``cli play
--mode Policy`` and the native runtime's loggers, against the JAX package,
on the CPU.

``evaluate`` runs each arm for 4 steps (two solve steps) at B = 4 on flat
ground from the JAX package's reset (``initial_state=``); the JAX side is
its ``evaluate``'s per-step body composed eagerly (``jax.vmap`` of
``env.step``, the batch-wide gate unbatched), since its jitted scan takes
minutes to compile on a CPU. Tolerance: every metric within 1e-4 of
max(1e-6, |ref|) relative, the fall count exactly. ``ab_compare``'s
aggregation and win criteria are held exactly against the JAX package's on
fixed per-seed results; the frame layout of ``pack_mpc_frame`` exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rl_mpc_locomotion_tpu import cli as jcli
from rl_mpc_locomotion_tpu.control.types import ControlConfig as JControlConfig
from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.models.actor_critic import (
    ActorCritic as JActorCritic)
from rl_mpc_locomotion_tpu.ops import rotations as jrot
from rl_mpc_locomotion_tpu.ops.qp import QPConfig as JQPConfig
from rl_mpc_locomotion_tpu.rl import evaluate as jeval
from rl_mpc_locomotion_tpu.sim import env as jenv
from rl_mpc_locomotion_tpu.sim import terrain as jterrain
from rl_mpc_locomotion_tpu.utils import metrics as jmetrics

from rl_mpc_locomotion_tpu_torch import cli
from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
from rl_mpc_locomotion_tpu_torch.control.weight_policy import WeightPolicy
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.ops.qp import QPConfig
from rl_mpc_locomotion_tpu_torch.rl import evaluate
from rl_mpc_locomotion_tpu_torch.sim import env
from rl_mpc_locomotion_tpu_torch.utils import convert, metrics, native_runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "aliengo_weight_policy")
B, T = 4, 4
CHEAP = dict(iters=8, iters2=0, adaptive_rho=False, polish=False,
             ruiz_iters=1)
METRICS = ("reward_per_step", "survival_rate", "falls", "lin_vel_err")


def to_np(tree):
    return jax.tree.map(np.array, tree)


def jax_evaluate(jp, jcfg, ter, pparams, state, num_steps, commands):
    """The JAX package's ``evaluate`` body, step by step (eager)."""
    ipm = jcfg.control.iterations_between_mpc
    model = JActorCritic(num_actions=jenv.NUM_ACTIONS)
    n = state.progress.shape[0]
    if commands is not None:
        state = state._replace(commands=jnp.broadcast_to(commands, (n, 3)))
    obs = jax.vmap(lambda s: jenv.observations(jp, jcfg, s))(state)
    fell = np.zeros(n, bool)
    rews, falls, verrs = [], [], []
    for t in range(num_steps):
        gate = jnp.bool_(((t + 1) % ipm) == 0)
        if pparams is not None:
            mean, _, _ = model.apply(pparams, obs)
            state, obs, rew, done, info = jax.vmap(
                lambda s, a: jenv.step(jp, jcfg, ter, s, a,
                                       solve_gate=gate))(state, mean)
        else:
            wb = jnp.broadcast_to(jp.mpc_weights, (n, 13))
            state, obs, rew, done, info = jax.vmap(
                lambda s, a, w: jenv.step(jp, jcfg, ter, s, a,
                                          solve_gate=gate, weights=w))(
                state, jnp.zeros((n, 12)), wb)
        fell |= np.asarray(info["fall"])
        if commands is not None:
            state = state._replace(
                commands=jnp.broadcast_to(commands, (n, 3)))
        r_bw = jax.vmap(jrot.quat_to_rot)(state.phys.quat)
        v_b = jnp.einsum("bij,bj->bi", r_bw, state.phys.v)
        verrs.append(np.asarray(jnp.linalg.norm(
            v_b[:, :2] - state.commands[:, :2], axis=-1)))
        rews.append(np.asarray(rew))
        falls.append(np.asarray(info["fall"]))
    return {"reward_per_step": float(np.mean(np.stack(rews))),
            "falls": float(np.sum(np.stack(falls))),
            "survival_rate": 1.0 - float(np.mean(fell.astype(np.float32))),
            "lin_vel_err": float(np.mean(np.stack(verrs)))}


@pytest.fixture(scope="module")
def policy():
    return WeightPolicy(CKPT, device="cpu")


@pytest.mark.parametrize("arm,commands", [
    ("policy", (0.3, 0.0, 0.1)), ("default", None)],
    ids=["policy_pinned_command", "default_random_commands"])
def test_evaluate_matches_jax(policy, arm, commands):
    """Each arm from JAX's reset (seeded keys): the port's evaluate against
    JAX's per-step body on the same states, within 1e-4 relative."""
    jp, pp = jrobots.aliengo_params(), robots.aliengo_params("cpu")
    jcfg = jenv.EnvConfig(control=JControlConfig(
        qp=JQPConfig(use_pallas=False, **CHEAP)))
    cfg = env.EnvConfig(control=ControlConfig(
        qp=QPConfig(use_kernel=False, **CHEAP)))
    ter_j = jterrain.flat(extent=10.0, cell=0.2)
    ter = convert.terrain_from_numpy(to_np(ter_j))
    jstate = jax.vmap(lambda k: jenv.reset(jp, jcfg, k))(
        jax.random.split(jax.random.PRNGKey(0), B))
    jpar = (jax.tree.map(jnp.asarray, convert.actor_critic_to_numpy(
        policy.model)) if arm == "policy" else None)
    want = jax_evaluate(jp, jcfg, ter_j, jpar, jstate, T,
                        None if commands is None else jnp.asarray(commands))
    got = evaluate.evaluate(
        pp, cfg, ter, policy.params if arm == "policy" else None,
        policy.model, num_steps=T, commands=commands,
        initial_state=convert.env_state_from_numpy(to_np(jstate)))
    assert (got["num_envs"], got["num_steps"]) == (B, T)
    assert got["falls"] == want["falls"]
    for k in METRICS:
        assert abs(got[k] - want[k]) <= 1e-4 * max(1e-6, abs(want[k])), (
            k, got[k], want[k])
    assert want["reward_per_step"] > 0 or commands is None
    assert want["lin_vel_err"] > 0


def test_pinned_commands_survive_a_reset(monkeypatch):
    """Env 0 times out on the first step and resets with fresh random
    commands; every step still sees the pinned command."""
    pp = robots.aliengo_params("cpu")
    cfg = env.EnvConfig(control=ControlConfig(
        qp=QPConfig(use_kernel=False, **CHEAP)), episode_length=5)
    ter = convert.terrain_from_numpy(to_np(jterrain.flat(extent=10.0,
                                                         cell=0.2)))
    state = env.reset(pp, cfg, torch.Generator().manual_seed(1), 0, batch=3,
                      device="cpu")
    state = state._replace(progress=torch.tensor([5, 0, 0],
                                                 dtype=torch.int32))
    seen, dones = [], []
    step = env.step

    def recording_step(*args, **kw):
        seen.append(args[3].commands.clone())
        out = step(*args, **kw)
        dones.append(out[3].clone())
        return out

    monkeypatch.setattr(env, "step", recording_step)
    pinned = (0.6, -0.2, 0.3)
    evaluate.evaluate(pp, cfg, ter, None, num_steps=3, commands=pinned,
                      initial_state=state)
    assert dones[0].tolist() == [True, False, False]
    assert len(seen) == 3
    for cmds in seen:
        assert torch.equal(cmds, torch.tensor([pinned] * 3))


def fixed_runs(reward, survival, falls, err=0.4):
    """Per-seed eval dicts for seeds 0, 1, 2 around the given means."""
    return [{"reward_per_step": reward * (1.0 + d), "survival_rate":
             survival + d, "falls": falls + 10 * i, "lin_vel_err": err + d,
             "num_envs": 64, "num_steps": 500}
            for i, d in enumerate((-0.01, 0.0, 0.02))]


@pytest.mark.parametrize("policy_arm,default_arm", [
    ((0.0057, 0.28, 159.0), (0.0044, 0.16, 310.0)),     # the committed A/B
    ((0.0057, 0.10, 159.0), (0.0044, 0.16, 310.0)),     # survives less
    ((0.0057, 0.28, 330.0), (0.0044, 0.28, 310.0)),     # falls more
    ((0.0040, 0.28, 159.0), (0.0044, 0.16, 310.0)),     # less reward
], ids=["wins", "survival", "falls", "reward"])
def test_ab_compare_aggregation_and_win_criteria_match_jax(
        monkeypatch, policy_arm, default_arm):
    """ab_compare over three seeds and a command sweep, with each arm's
    evaluate replaced by fixed results in both packages: the whole result
    (means, CIs, sweep rows, win criteria) equal to the JAX package's."""
    runs = {"policy": fixed_runs(*policy_arm),
            "default": fixed_runs(*default_arm)}

    def fake(params, cfg, ter, pp, model=None, num_envs=64, num_steps=500,
             seed=0, commands=None, **kw):
        r = dict(runs["default" if pp is None else "policy"][seed])
        if commands is not None:
            r["reward_per_step"] += float(commands[0])
        return r

    monkeypatch.setattr(jeval, "evaluate", fake)
    monkeypatch.setattr(evaluate, "evaluate", fake)
    sweep = [(0.5, 0.0, 0.0), (1.0, 0.0, 0.0)]
    kw = dict(num_envs=64, num_steps=500, seed=1, command_sweep=sweep,
              seeds=(0, 1, 2))
    want = jeval.ab_compare(None, None, None, "p", **kw)
    got = evaluate.ab_compare(None, None, None, "p", **kw)
    assert got == want
    assert evaluate._mean_ci95([0.5]) == jeval._mean_ci95([0.5])
    # and with the default arm's runs given
    got = evaluate.ab_compare(None, None, None, "p", seeds=(0, 1, 2),
                              default_runs=runs["default"])
    want = jeval.ab_compare(None, None, None, "p", seeds=(0, 1, 2),
                            default_runs=runs["default"])
    assert got == want


def test_cli_eval_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "eval.json"
    cli.main(["eval", "--device", "cpu", "--num-envs", "2", "--seconds",
              "0.04", "--checkpoint", CKPT, "--out", str(out)])
    res = json.loads(out.read_text())
    for arm in ("policy", "default"):
        assert res[arm]["num_envs"] == 2 and res[arm]["num_steps"] == 4
        assert all(np.isfinite(res[arm][k]) for k in METRICS)
    assert set(res["win_criteria"]) == {"reward", "survival", "falls"}
    assert "[eval] written to" in capsys.readouterr().out


def test_cli_play_policy_on_the_cpu(tmp_path, capsys):
    """play --mode Policy with the committed checkpoint and telemetry: the
    log holds one frame a tick in JAX's field layout; with --render it
    writes the animation."""
    tele = str(tmp_path / "tele.bin")
    cli.main(["play", "--mode", "Policy", "--device", "cpu", "--num-envs",
              "2", "--seconds", "0.04", "--checkpoint", CKPT,
              "--telemetry", tele])
    out = capsys.readouterr().out
    assert sum(ln.startswith("[play]") and "robot-ticks/s" in ln
               for ln in out.splitlines()) == 1
    frames = native_runtime.TelemetryLogger.read(tele)
    assert frames.shape == (4, len(cli.TELEMETRY_FIELDS))
    np.testing.assert_array_equal(frames[:, 0], np.arange(4))
    assert np.isfinite(frames).all() and (frames[:, 3] > 0.2).all()
    with open(tele + ".meta") as f:
        assert f.read().split("\n") == cli.TELEMETRY_FIELDS
    gif = tmp_path / "x.gif"
    cli.main(["play", "--mode", "Policy", "--device", "cpu", "--num-envs",
              "2", "--seconds", "0.04", "--checkpoint", CKPT, "--render",
              str(gif)])
    assert gif.stat().st_size > 0


class FakeGamepad:
    estop_flagged = False

    def get_command(self):
        return [0.25, -0.5, 0.75]

    def get_gait(self):
        return 6

    def get_mode(self):
        return 2


def test_gamepad_tick_update_and_inert_gamepad():
    got = cli.gamepad_tick_update(FakeGamepad())
    want = jcli.gamepad_tick_update(FakeGamepad())
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    pad = native_runtime.Gamepad("/nonexistent/js0")
    assert not pad.connected
    np.testing.assert_array_equal(pad.get_command(), np.zeros(3))
    assert (pad.get_gait(), pad.get_mode()) == (0, 2)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_telemetry_logger_round_trip(monkeypatch, tmp_path, native):
    """Frames back as pushed, through the native ring buffer and through
    the Python path (the library unavailable)."""
    if not native:
        monkeypatch.setattr(native_runtime, "_load_library", lambda: None)
    path = str(tmp_path / "log.bin")
    log = native_runtime.TelemetryLogger(path, frame_size=5,
                                         field_names=list("abcde"))
    assert log.available == native
    frames = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    for f in frames:
        assert log.push(f)
    log.flush()
    log.close()
    assert log.dropped == 0
    np.testing.assert_array_equal(native_runtime.TelemetryLogger.read(path),
                                  frames)
    with pytest.raises(ValueError):
        log.push(np.zeros(4))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_mpc_frame_logger_round_trip(tmp_path, native):
    """Frames packed as JAX's pack_mpc_frame packs them, logged (tensors
    and arrays), flushed to one .npz of named fields."""
    rng = np.random.default_rng(1)
    solves = [dict(com_state=rng.normal(size=13), desired_state=rng.normal(
        size=13), grf=rng.normal(size=(4, 3)), loss=rng.normal(size=3),
        weights=rng.normal(size=13), tick=2 * i) for i in range(3)]
    assert metrics.MPC_FRAME_FIELDS == jmetrics.MPC_FRAME_FIELDS
    for s in solves:
        np.testing.assert_array_equal(metrics.pack_mpc_frame(**s),
                                      jmetrics.pack_mpc_frame(**s))
    log = metrics.MPCFrameLogger(str(tmp_path), use_native=native)
    assert log.native == native
    for s in solves:
        log.log(**{k: torch.as_tensor(v) for k, v in s.items()})
    with np.load(log.flush()) as data:
        fields = {k: data[k] for k in data.files}
    want = jmetrics.unpack_mpc_frames(np.stack(
        [jmetrics.pack_mpc_frame(**s) for s in solves]))
    assert sorted(fields) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(fields[k], v, err_msg=k)
