"""The port's data parallelism (``parallel/{mesh,distributed}``,
``ppo_update(axis_name=)``, ``make_train_step(mesh=)``) on the CPU with gloo.

Two processes (this file run as a script, one a rank, launched like
``tests/test_distributed.py``) each take one half of a recorded rollout
(T = 4, B = 8, the full ``ActorCritic``) and run one
``ppo_update(axis_name=ENV_AXIS)`` with ``psum_grads``: both ranks must end
with bitwise-identical parameters, Adam state, lr and KL (a rank-local KL
would give each rank its own adaptive lr), and the result must match the
JAX package's ``shard_map``-ped ``ppo_update`` on a 2-device CPU mesh fed
the same halves and the permutations it draws for T*B/2 rows, within
``tests/test_torch_ppo.py``'s tolerances. The workers also check the mesh
helpers. In this process: a one-rank mesh leaves ``make_train_step``
bitwise equal to ``mesh=None``.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.models.actor_critic import ActorCritic
from rl_mpc_locomotion_tpu_torch.ops.qp import QPConfig
from rl_mpc_locomotion_tpu_torch.parallel import distributed
from rl_mpc_locomotion_tpu_torch.parallel import mesh as mesh_mod
from rl_mpc_locomotion_tpu_torch.parallel.mesh import ENV_AXIS
from rl_mpc_locomotion_tpu_torch.rl import ppo
from rl_mpc_locomotion_tpu_torch.rl import train as train_mod
from rl_mpc_locomotion_tpu_torch.sim import env, terrain
from rl_mpc_locomotion_tpu_torch.utils import seeding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, OBS, ACT = 4, 8, 48, 12
# the adaptive-KL case of tests/test_torch_ppo.py: the lr moves both ways
PPO_KW = dict(num_steps=T, schedule="adaptive", learning_rate=1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank: int, outdir: str):
    """One rank: the mesh helpers, then the update of its half."""
    distributed.initialize(backend="gloo")
    mesh = distributed.global_env_mesh("cpu")
    assert mesh.size() == 2 and mesh.get_local_rank(ENV_AXIS) == rank
    assert distributed.local_batch_slice(8) == (4 * rank, 4)
    try:
        distributed.local_batch_slice(7)
        raise AssertionError("an odd global batch over 2 ranks")
    except AssertionError as e:
        assert "must divide" in str(e)
    tree = {"x": torch.arange(8.0), "s": torch.tensor(3.0), "n": None}
    local = mesh_mod.shard_env_batch(mesh, tree)
    assert torch.equal(local["x"], torch.arange(4.0) + 4 * rank)
    try:
        mesh_mod.shard_env_batch(mesh, torch.zeros(5))
        raise AssertionError("5 rows over 2 ranks")
    except ValueError as e:
        assert "does not divide" in str(e)
    assert float(local["s"]) == 3.0 and local["n"] is None
    rep = mesh_mod.replicate(mesh, {"v": torch.full((3,), float(rank))})
    assert torch.equal(rep["v"], torch.zeros(3))
    g = mesh_mod.psum_grads({"a": torch.tensor([rank + 1.0, 2.0]),
                             "b": torch.full((2, 2), 4.0 * rank)})
    assert torch.equal(g["a"], torch.tensor([1.5, 2.0]))
    assert torch.equal(g["b"], torch.full((2, 2), 2.0))
    fn = mesh_mod.shard_map_env(mesh, lambda x, c: (x.sum() * c,),
                                (ENV_AXIS, None), (None,))
    assert float(fn(torch.arange(8.0), 2.0)[0]) == 2.0 * (
        sum(range(4 * rank, 4 * rank + 4)))

    data = torch.load(os.path.join(outdir, "inputs.pt"))
    model = ActorCritic(ACT)
    model.load_state_dict(data["model"])
    state = ppo.TrainState(model=model, opt_state=ppo.AdamState(
        data["count"], data["mu"], data["nu"]), lr=data["lr"],
        generator=torch.Generator())
    half = slice(rank * B // 2, (rank + 1) * B // 2)
    traj = ppo.Transition(*(x[:, half] for x in data["traj"]))
    new, metrics = ppo.ppo_update(
        model, ppo.PPOConfig(**PPO_KW), state, traj, data["last"][half],
        grad_reduce=mesh_mod.psum_grads, axis_name=ENV_AXIS,
        perms=data["perms"])
    torch.save({"model": model.state_dict(), "count": new.opt_state.count,
                "mu": new.opt_state.mu, "nu": new.opt_state.nu, "lr": new.lr,
                "metrics": metrics}, os.path.join(outdir, f"rank{rank}.pt"))
    distributed.shutdown()
    print(f"RESULT {rank}", flush=True)


def _jax_sharded_update(jm, cfg_j, jts, traj, last):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from rl_mpc_locomotion_tpu.rl import ppo as jppo

    jmesh = Mesh(np.array(jax.devices()[:2]), (ENV_AXIS,))

    def local(ts, tr, lv):
        return jppo.ppo_update(jm, cfg_j, ts, tr, lv,
                               grad_reduce=lambda g: jax.lax.pmean(
                                   g, ENV_AXIS), axis_name=ENV_AXIS)

    return jax.jit(jax.shard_map(
        local, mesh=jmesh, in_specs=(P(), P(None, ENV_AXIS), P(ENV_AXIS)),
        out_specs=(P(), P()), check_vma=False))(jts, traj, last)


def test_two_ranks_update_bitwise_equal_and_match_jax_shard_map(tmp_path):
    import jax
    import jax.numpy as jnp
    from rl_mpc_locomotion_tpu.rl import ppo as jppo
    from test_torch_ppo import (_jax_state, _port_state,
                                assert_update_matches, jax_perms)

    cfg_j, cfg = jppo.PPOConfig(**PPO_KW), ppo.PPOConfig(**PPO_KW)
    jm, jts = _jax_state(cfg_j)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(T, B, OBS)).astype(np.float32)
    mean, log_std, value = jm.apply(jts.params, obs)
    action = mean + rng.normal(size=(T, B, ACT)).astype(np.float32)
    traj = jppo.Transition(
        obs=jnp.asarray(obs), action=action,
        log_prob=jppo.gaussian_log_prob(mean, log_std, action), value=value,
        reward=jnp.asarray(rng.normal(size=(T, B)).astype(np.float32)),
        done=jnp.asarray(rng.random((T, B)) < 0.2), mean=mean,
        log_std=log_std)
    last = jnp.asarray(rng.normal(size=B).astype(np.float32))
    jnew, jmetrics = _jax_sharded_update(jm, cfg_j, jts, traj, last)

    state = _port_state(jts, cfg)
    torch.save({"model": state.model.state_dict(),
                "count": state.opt_state.count, "mu": state.opt_state.mu,
                "nu": state.opt_state.nu, "lr": state.lr,
                "traj": [torch.from_numpy(np.array(x)) for x in traj],
                "last": torch.from_numpy(np.array(last)),
                # each shard draws from the replicated rng for its rows
                "perms": jax_perms(jts.rng, cfg, T * B // 2)},
               tmp_path / "inputs.pt")

    port = _free_port()
    procs = []
    for rank in (0, 1):
        penv = dict(os.environ, MASTER_ADDR="localhost",
                    MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                    PYTHONPATH=REPO + os.pathsep
                    + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank),
             str(tmp_path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=penv, cwd=REPO))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "RESULT" in out, out[-4000:]

    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1))
    # the replication check: every parameter, moment, the lr and the KL
    # that drove it, bit for bit
    for k in r0["model"]:
        assert torch.equal(r0["model"][k], r1["model"][k]), k
        assert torch.equal(r0["mu"][k], r1["mu"][k]), k
        assert torch.equal(r0["nu"][k], r1["nu"][k]), k
    assert torch.equal(r0["lr"], r1["lr"])
    for k in r0["metrics"]:
        assert torch.equal(r0["metrics"][k], r1["metrics"][k]), k
    assert float(r0["lr"]) != cfg.learning_rate   # the adaptive path ran

    model = ActorCritic(ACT)
    model.load_state_dict(r0["model"])
    new = ppo.TrainState(model=model, opt_state=ppo.AdamState(
        r0["count"], r0["mu"], r0["nu"]), lr=r0["lr"], generator=None)
    assert float(r0["lr"]) == pytest.approx(float(jnew.lr), rel=1e-6)
    assert_update_matches(model, new, r0["metrics"], jts, jnew, jmetrics)


def _small_cfg():
    return train_mod.TrainConfig(
        num_envs=4, ppo=ppo.PPOConfig(num_steps=4, num_minibatches=2,
                                      num_epochs=2),
        env=env.EnvConfig(control=ControlConfig(qp=QPConfig(
            use_kernel=False, iters=8, iters2=0, adaptive_rho=False,
            polish=False, ruiz_iters=1))))


def _one_iteration(cfg, mesh):
    params = robots.aliengo_params("cpu")
    model = ActorCritic(12)
    ts = ppo.init_train_state(seeding.key(0, "cpu"), model, 48, cfg.ppo)
    gen = seeding.key(0, "cpu", stream=1)
    step_fn, reset_fn = train_mod.make_train_step(
        params, cfg, terrain.flat(extent=10.0, cell=0.2), model, mesh)
    es, obs = reset_fn(gen)
    ts, es, obs, tick, metrics = step_fn(ts, es, obs, 0, gen)
    return model, ts, es, metrics


def test_one_rank_mesh_train_step_equals_no_mesh():
    cfg = _small_cfg()
    want_model, want_ts, want_es, want_m = _one_iteration(cfg, None)
    mesh = mesh_mod.make_mesh(device_type="cpu")
    try:
        assert mesh.size() == 1 and mesh.mesh_dim_names == (ENV_AXIS,)
        with pytest.raises(ValueError, match="spans the world"):
            mesh_mod.make_mesh(2, device_type="cpu")
        got_model, got_ts, got_es, got_m = _one_iteration(cfg, mesh)
    finally:
        distributed.shutdown()
    for (k, v), w in zip(got_model.state_dict().items(),
                         want_model.state_dict().values()):
        assert torch.equal(v, w), k
    assert torch.equal(got_ts.lr, want_ts.lr)
    for k in want_ts.opt_state.mu:
        assert torch.equal(got_ts.opt_state.mu[k], want_ts.opt_state.mu[k])
        assert torch.equal(got_ts.opt_state.nu[k], want_ts.opt_state.nu[k])
    assert set(got_m) == set(want_m)
    for k in want_m:
        assert torch.equal(got_m[k].float(), want_m[k].float()), k
    assert torch.equal(got_es.phys.pos, want_es.phys.pos)


def test_mesh_helpers_check_their_inputs():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="make_mesh"):
        mesh_mod.axis_group(ENV_AXIS)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh_mod.axis_group("batch")
    assert distributed.local_batch_slice(6) == (0, 6)
    distributed.initialize(num_processes=1)     # one process: a no-op
    assert not torch.distributed.is_initialized()
    mesh = mesh_mod.make_mesh(device_type="cpu")
    try:
        # one rank holds the whole batch; a mesh must be a DeviceMesh
        x = torch.arange(5.0)
        assert torch.equal(mesh_mod.shard_env_batch(mesh, x), x)
        with pytest.raises(TypeError, match="DeviceMesh"):
            train_mod.make_train_step(robots.aliengo_params("cpu"),
                                      _small_cfg(), None, ActorCritic(12),
                                      mesh=ENV_AXIS)
    finally:
        distributed.shutdown()
    with pytest.raises(ValueError, match="one axis"):
        mesh_mod.shard_map_env(None, lambda x: x, ("batch",), (None,))


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2])
