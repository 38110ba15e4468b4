"""The port's weight policy (``control/weight_policy``) against the JAX
package, on the CPU, and the committed weights against the trained
checkpoints they were carried across from.

The trained checkpoints under ``artifacts/`` are orbax directories, which
only the JAX package can read. Their parameters are carried across once, as
``rl_mpc_locomotion_tpu_torch/weights/<run>/model_<i>.npz`` (the latest
checkpoint of each run in ``RUNS``; keys are the flax tree's paths joined by
'/', arrays float32 as orbax restores them). Write them with

    python tests/test_torch_weight_policy.py --write-weights

and run it again when a run is added under ``artifacts/`` (add it to
``RUNS``) or a run gets a newer checkpoint.

Tolerances: the weight files bitwise equal to their orbax checkpoints;
observations and ``actions_to_weights`` within 1e-6; ``policy_step`` (the
real ``aliengo_weight_policy`` parameters) and ``step_batch`` within 1e-5;
three ``policy_fsm_step`` ticks (JAX: eager ``jax.vmap``, the batch-wide
gate unbatched; a solve on the third) with torques within 5e-4 of
max(1, |tau|) (the FSM tick's parity tolerance), the policy's action
within 1e-5, the passive counts and FSM states exactly.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rl_mpc_locomotion_tpu.control import runner as jrunner  # noqa: E402
from rl_mpc_locomotion_tpu.control import state_estimator as jse  # noqa: E402
from rl_mpc_locomotion_tpu.control import weight_policy as jwp  # noqa: E402
from rl_mpc_locomotion_tpu.control.types import (  # noqa: E402
    ControlConfig as JControlConfig)
from rl_mpc_locomotion_tpu.models import robots as jrobots  # noqa: E402
from rl_mpc_locomotion_tpu.models.actor_critic import (  # noqa: E402
    ActorCritic as JActorCritic)
from rl_mpc_locomotion_tpu.ops.qp import QPConfig as JQPConfig  # noqa: E402
from rl_mpc_locomotion_tpu.sim import physics as jphysics  # noqa: E402
from rl_mpc_locomotion_tpu.utils import checkpoint as jckpt  # noqa: E402

from rl_mpc_locomotion_tpu_torch import cli  # noqa: E402
from rl_mpc_locomotion_tpu_torch.control import fsm  # noqa: E402
from rl_mpc_locomotion_tpu_torch.control import types  # noqa: E402
from rl_mpc_locomotion_tpu_torch.control import weight_policy  # noqa: E402
from rl_mpc_locomotion_tpu_torch.control.types import (  # noqa: E402
    ControlConfig)
from rl_mpc_locomotion_tpu_torch.control.weight_policy import (  # noqa: E402
    WeightPolicy)
from rl_mpc_locomotion_tpu_torch.models import robots  # noqa: E402
from rl_mpc_locomotion_tpu_torch.ops.qp import QPConfig  # noqa: E402
from rl_mpc_locomotion_tpu_torch.utils import convert  # noqa: E402

ART = os.path.join(ROOT, "artifacts")
WEIGHTS = os.path.join(ROOT, "rl_mpc_locomotion_tpu_torch", "weights")

# the trained runs carried across, and their observation width (48, or
# 48 + the 3-wide robot one-hot for the heterogeneous run)
RUNS = {
    "aliengo_weight_policy": 48,
    "aliengo_weight_policy_rough": 48,
    "go1_weight_policy_rough": 48,
    "a1_weight_policy_rough": 48,
    "mixed_weight_policy_rough": 51,
    "aliengo_weight_policy_coupled": 48,
}
ALIENGO = "aliengo_weight_policy"
ALIENGO_DIR = os.path.join(ART, ALIENGO)

CHEAP = dict(iters=8, iters2=0, adaptive_rho=False, polish=False,
             ruiz_iters=1)
L = fsm.LOCOMOTION


def orbax_checkpoint(run):
    """The latest model_<i> directory of an artifact run."""
    return jckpt.latest_checkpoint(os.path.join(ART, run))


def npz_path(run):
    return os.path.join(WEIGHTS, run,
                        os.path.basename(orbax_checkpoint(run)) + ".npz")


def flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, path + "/"))
        else:
            out[path] = value
    return out


def orbax_params(run):
    """The run's latest parameters as the JAX package's ``WeightPolicy``
    restores them, flattened to {path: float32 array}. Raises if the
    restore fell back to the random init (the JAX class prints and goes
    on)."""
    from rl_mpc_locomotion_tpu.control.weight_policy import WeightPolicy
    num_obs = RUNS[run]
    restored = WeightPolicy(checkpoint=orbax_checkpoint(run), num_obs=num_obs)
    fresh = WeightPolicy(num_obs=num_obs)
    got = flatten(jax.tree.map(np.asarray, restored.params))
    init = flatten(jax.tree.map(np.asarray, fresh.params))
    if all(np.array_equal(got[k], init[k]) for k in got):
        raise RuntimeError(f"orbax restore of {run} fell back to the init")
    return got


def write_weights():
    for run in RUNS:
        flat = orbax_params(run)
        path = npz_path(run)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, **flat)
        print(f"{path}: {len(flat)} arrays, "
              f"{sum(v.size for v in flat.values())} parameters")



# ---- helpers ----------------------------------------------------------------


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def jax_params(run):
    """The committed weights as the JAX package's parameter tree."""
    return jax.tree.map(jnp.asarray,
                        convert.flax_params_from_npz(npz_path(run)))


def random_inputs(b, seed):
    """(body (B,13) xyzw, q, qd, commands, prev_action), with entries
    beyond the observation clip (5) and actions beyond [-1, 1]."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(b, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    body = np.concatenate([rng.uniform(-1, 1, (b, 2)),
                           rng.uniform(0.25, 0.4, (b, 1)), quat,
                           rng.normal(0, 1, (b, 3)), rng.normal(0, 2, (b, 3))],
                          axis=-1)
    q = np.tile([0.0, 0.8, -1.6], (b, 4)) + rng.normal(0, 0.1, (b, 12))
    qd = rng.normal(0, 4, (b, 12))
    cmd = rng.uniform(-1.5, 1.5, (b, 3))
    prev = rng.uniform(-1.5, 1.5, (b, 12))
    return tuple(a.astype(np.float32) for a in (body, q, qd, cmd, prev))


def t(a):
    return torch.from_numpy(np.array(a))


# ---- the committed weights --------------------------------------------------

@pytest.mark.parametrize("run", list(RUNS))
def test_weights_equal_their_orbax_checkpoint(run):
    """Each committed .npz holds exactly the arrays orbax restores from the
    run's latest checkpoint: the same paths, float32, bitwise equal."""
    want = orbax_params(run)
    with np.load(npz_path(run)) as data:
        got = {k: data[k] for k in data.files}
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    model = convert.actor_critic_from_flax(
        convert.flax_params_from_npz(npz_path(run)))
    assert model.num_obs == RUNS[run]


def test_every_artifact_run_is_converted():
    """Every trained run under artifacts/ (the .r4_backup copies aside) has
    its latest checkpoint converted: a new run or checkpoint needs
    --write-weights."""
    found = {name for name in os.listdir(ART)
             if os.path.isdir(os.path.join(ART, name))
             and not name.endswith(".r4_backup")
             and jckpt.latest_checkpoint(os.path.join(ART, name))}
    assert found == set(RUNS)
    for run in RUNS:
        assert os.path.isfile(npz_path(run)), (run,
                                               weight_policy.WRITE_WEIGHTS)


# ---- observations and actions -----------------------------------------------

def test_constants_match_jax():
    for name in ("STAND_DOF_POS", "MPC_PARAM_SCALE", "MPC_PARAM_CONST"):
        np.testing.assert_array_equal(getattr(weight_policy, name).numpy(),
                                      np.asarray(getattr(jwp, name)))
    assert weight_policy.PolicyScales() == tuple(jwp.PolicyScales())


def test_observations_and_actions_match_jax():
    """Both observation layouts at B = 8 within 1e-6, with scales other
    than 1 and entries past the clip; actions_to_weights with actions
    outside [-1, 1]."""
    body, q, qd, cmd, prev = random_inputs(8, seed=1)
    scales = (1.5, 0.5, 2.0, 0.75)
    jp = jrobots.aliengo_params()
    est0 = jrunner.init_state(jp, JControlConfig()).est
    jses = jax.vmap(lambda bo: jse.update(est0, bo))(body)
    want = np.asarray(jax.vmap(lambda s, a, v, c, p: jwp.compute_observations(
        s, a, v, c, p, jwp.PolicyScales(*scales)))(jses, q, qd, cmd, prev))
    jses_np = jax.tree.map(np.asarray, jses)
    se = types.StateEstimate(**{k: t(v) for k, v in jses_np._asdict().items()})
    got = weight_policy.compute_observations(
        se, t(q), t(qd), t(cmd), t(prev), weight_policy.PolicyScales(*scales))
    assert got.shape == (8, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    want = np.asarray(jax.vmap(
        lambda bo, a, v, c, p: jwp.compute_observations_train_parity(
            bo, a, v, c, p, jwp.PolicyScales(*scales)))(
        body, q, qd, cmd, prev))
    got = weight_policy.compute_observations_train_parity(
        t(body), t(q), t(qd), t(cmd), t(prev),
        weight_policy.PolicyScales(*scales))
    assert np.abs(want).max() == 5.0        # the clip is exercised
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    actions = np.random.default_rng(2).uniform(-2, 2, (8, 12)).astype(
        np.float32)
    want = np.asarray(jax.vmap(jwp.actions_to_weights)(actions))
    got = weight_policy.actions_to_weights(t(actions))
    assert got.shape == (8, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_policy_step_matches_jax_with_trained_weights():
    """policy_step with the real aliengo_weight_policy parameters: weights
    and action within 1e-5."""
    body, q, qd, cmd, prev = random_inputs(8, seed=3)
    jmodel = JActorCritic(num_actions=12)
    jpar = jax_params(ALIENGO)
    want_w, want_a = jax.vmap(lambda bo, a, v, c, p: jwp.policy_step(
        jmodel, jpar, bo, a, v, c, p))(body, q, qd, cmd, prev)
    pol = WeightPolicy(ALIENGO_DIR, device="cpu")
    got_w, got_a = weight_policy.policy_step(
        pol.model, pol.params, t(body), t(q), t(qd), t(cmd), t(prev))
    assert not got_a.requires_grad
    assert rel_err(got_a.numpy(), want_a) < 1e-5
    assert rel_err(got_w.numpy(), want_w) < 1e-5


def test_policy_fsm_step_matches_jax():
    """Three ticks of policy_fsm_step at B = 4 from the same ControlState
    (locomotion, a solve on tick 2), each side threading its own previous
    action: torques within 5e-4 of max(1, |tau|), the action within 1e-5,
    passive counts and FSM states exactly."""
    b = 4
    jp, pp = jrobots.aliengo_params(), robots.aliengo_params("cpu")
    jcfg = JControlConfig(qp=JQPConfig(use_pallas=False, **CHEAP))
    cfg = ControlConfig(qp=QPConfig(use_kernel=False, **CHEAP))
    jmodel, jpar = JActorCritic(num_actions=12), jax_params(ALIENGO)
    pol = WeightPolicy(ALIENGO_DIR, device="cpu")
    jstate = jax.vmap(lambda _: jrunner.init_state(jp, jcfg, fsm_initial=L))(
        jnp.arange(b))
    state = convert.control_state_from_numpy(jax.tree.map(np.asarray, jstate))
    jprev = jnp.zeros((b, 12), jnp.float32)
    prev = torch.zeros(b, 12)
    jpi = jnp.zeros(b, jnp.int32)
    pi = torch.zeros(b, dtype=torch.int32)
    rng = np.random.default_rng(5)
    cmd = np.tile(np.array([0.5, 0.0, 0.1], np.float32), (b, 1))
    gates = []
    for tick in range(3):
        q = (np.tile([0.0, 0.8, -1.6], (b, 4))
             + 0.02 * rng.normal(size=(b, 12))).astype(np.float32)
        qd = (0.1 * rng.normal(size=(b, 12))).astype(np.float32)
        body = np.zeros((b, 13), np.float32)
        body[:, 2] = 0.34 + 0.01 * rng.normal(size=b)
        body[:, 6] = 1.0
        body[:, 7:13] = 0.1 * rng.normal(size=(b, 6))
        gate = bool(fsm.solve_gate(cfg, state))
        gates.append(gate)
        jstate, jtau, jprev, jpi, jmet = jax.vmap(
            lambda s, pa, a, v, bo, c, p: jwp.policy_fsm_step(
                jp, jcfg, jmodel, jpar, s, pa, a, v, bo, c, jnp.int32(0),
                jnp.int32(L), p, solve_gate=jnp.bool_(gate)))(
            jstate, jprev, q, qd, body, cmd, jpi)
        state, tau, prev, pi, met = weight_policy.policy_fsm_step(
            pp, cfg, pol.model, pol.params, state, prev, t(q), t(qd),
            t(body), t(cmd), 0, L, pi, solve_gate=gate)
        jtau = np.asarray(jtau)
        scale = np.maximum(1.0, np.abs(jtau).max(axis=-1, keepdims=True))
        assert (np.abs(tau.numpy() - jtau) / scale).max() < 5e-4, tick
        assert rel_err(prev.numpy(), jprev) < 1e-5, tick
        np.testing.assert_array_equal(met["policy_action"].numpy(),
                                      prev.numpy())
        np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
        np.testing.assert_array_equal(met["fsm_state"].numpy(),
                                      np.asarray(jmet["fsm_state"]))
    assert gates == [False, False, True]
    assert np.abs(np.asarray(jmet["f_ff"])).max() > 1.0       # it solved
    w = weight_policy.actions_to_weights(prev).numpy()
    assert (w[:, 3:6] >= 30).all() and (w[:, 3:6] <= 70).all()


def test_step_batch_matches_jax():
    """step_batch on batched physics and control states, with and without
    the previous action, within 1e-5 of the JAX class's."""
    b = 3
    jp = jrobots.aliengo_params()
    rng = np.random.default_rng(7)
    q0 = (np.tile([0.0, 0.8, -1.6], (b, 4))
          + 0.05 * rng.normal(size=(b, 12))).astype(np.float32)
    jps = jax.vmap(lambda q: jphysics.init_state(jp, q, 0.35))(q0)
    jps = jps._replace(v=jnp.asarray(rng.normal(0, 0.3, (b, 3)), jnp.float32),
                       qd=jnp.asarray(rng.normal(0, 1, (b, 12)), jnp.float32))
    jcs = jax.vmap(lambda _: jrunner.init_state(jp, JControlConfig()))(
        jnp.arange(b))
    jpol = jwp.WeightPolicy()
    jpol.params = jax_params(ALIENGO)
    pol = WeightPolicy(ALIENGO_DIR, device="cpu")
    ps = convert.phys_state_from_numpy(jax.tree.map(np.asarray, jps), b)
    cs = convert.control_state_from_numpy(jax.tree.map(np.asarray, jcs), b)
    cmd = np.array([0.5, 0.0, 0.2], np.float32)
    prev = rng.uniform(-1, 1, (b, 12)).astype(np.float32)
    for pa in (None, prev):
        want_w, want_a = jpol.step_batch(jps, jcs, jnp.asarray(cmd), pa)
        got_w, got_a = pol.step_batch(ps, cs, t(cmd),
                                      None if pa is None else t(pa))
        assert rel_err(got_a.numpy(), want_a) < 1e-5
        assert rel_err(got_w.numpy(), want_w) < 1e-5


# ---- WeightPolicy: what it loads and what it refuses ------------------------

def test_weight_policy_loads_jax_runs():
    """A JAX run directory and its model_<i> directory both resolve to the
    converted latest checkpoint; the 51-input mixed run loads at its width
    and gives JAX's forward."""
    pol = WeightPolicy(ALIENGO_DIR, device="cpu")
    assert pol.source == npz_path(ALIENGO)
    same = WeightPolicy(orbax_checkpoint(ALIENGO), device="cpu")
    for k, v in pol.params.items():
        assert torch.equal(v, same.params[k]), k
    mixed = "mixed_weight_policy_rough"
    pol = WeightPolicy(os.path.join(ART, mixed), num_obs=51, device="cpu")
    assert pol.num_obs == 51 and pol.model.num_obs == 51
    obs = weight_policy.compute_observations_train_parity(
        *map(t, random_inputs(6, seed=4))).numpy()
    obs = np.concatenate([obs, np.eye(3, dtype=np.float32)[[0, 1, 2] * 2]],
                         axis=-1)
    want, _, _ = JActorCritic(num_actions=12).apply(jax_params(mixed), obs)
    got, _, _ = pol.model(t(obs))
    assert rel_err(got.detach().numpy(), want) < 1e-5
    with pytest.raises(ValueError, match="51"):
        WeightPolicy(os.path.join(ART, mixed), device="cpu")


def test_weight_policy_loads_a_checkpoint_of_cli_train(tmp_path):
    """A run directory written by ``cli train --device cpu``: the policy
    holds the checkpoint's model."""
    from rl_mpc_locomotion_tpu_torch.utils import checkpoint

    ck = str(tmp_path / "ck")
    cli.main(["train", "--device", "cpu", "--num-envs", "4",
              "--max-iterations", "1", "--override", "ppo.num_steps=4",
              "--terrain", "flat", "--checkpoint", ck])
    pol = WeightPolicy(ck, device="cpu")
    assert pol.source == checkpoint.latest_checkpoint(ck)
    saved = torch.load(pol.source, weights_only=True)["model"]
    assert set(saved) == set(pol.params)
    for k, v in saved.items():
        assert torch.equal(pol.params[k], v), k
    fresh = WeightPolicy(device="cpu")
    assert any(not torch.equal(fresh.params[k], v) for k, v in saved.items())


@pytest.mark.parametrize("where", ["unconverted_jax_run", "missing",
                                   "empty_dir"])
def test_weight_policy_raises_on_what_it_cannot_load(where, tmp_path):
    """No random-init fallback: a JAX checkpoint without converted weights,
    a path that does not exist and a directory without checkpoints all
    raise, naming the path and the conversion command."""
    path = {"unconverted_jax_run": os.path.join(
                ART, "aliengo_weight_policy_rough.r4_backup"),
            "missing": str(tmp_path / "nowhere"),
            "empty_dir": str(tmp_path)}[where]
    with pytest.raises(FileNotFoundError, match="--write-weights") as err:
        WeightPolicy(path, device="cpu")
    assert repr(path) in str(err.value)


def test_random_init_is_seeded():
    a, b = WeightPolicy(device="cpu"), WeightPolicy(device="cpu")
    assert a.source is None
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k])
    assert math.isclose(float(a.params["log_std"][0]), 0.0)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-weights"]:
        sys.exit(f"usage: python {sys.argv[0]} --write-weights")
    jax.config.update("jax_platforms", "cpu")
    write_weights()
