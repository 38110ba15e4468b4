"""The port's measuring and campaign scripts
(``rl_mpc_locomotion_tpu_torch/scripts``) against the JAX package's
``scripts/``, on the CPU.

- ``qp_budget_sweep._summarize`` against the JAX file's statistics
  (``scripts/qp_budget_sweep.py:78-103``, transcribed line by line in
  ``jax.numpy``) on seeded arrays with masked (non-solve) ticks: exactly
  equal; ``measure`` at 4 envs x 6 steps returns the JAX row's keys.
- ``envelope_sweep.run`` on a 1 x 1 grid at 2 envs x 5 steps writes
  ``envelope.json`` with the JAX file's keys.
- ``plot_telemetry.load_frames`` against the JAX script's (loaded from
  ``scripts/`` with importlib) on logs the port's ``MPCFrameLogger`` and
  ``TelemetryLogger`` write: bitwise equal.
- ``multidev_scaling._worker`` at n = 1 on the CPU (a gloo group of one)
  returns the row's schema and leaves no group behind.
- ``run_campaigns``: ``Campaign``, ``CAMPAIGNS`` and ``DR_SPECS`` against the
  JAX file's, read with ``ast`` (importing it would create ``.jax_cache/``);
  one campaign at 2 iterations x 8 envs with a 4-env x 10-step eval, whose
  ``eval_ab.json`` has the layout of the committed JAX one;
  ``extend_and_select``'s ranking on hand-made eval dicts against the JAX
  file's sort.
- No new module imports matplotlib (or jax) when it is imported.
"""
import ast
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rl_mpc_locomotion_tpu_torch import cli
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.scripts import (envelope_sweep,
                                                 extend_and_select,
                                                 multidev_scaling,
                                                 plot_telemetry,
                                                 qp_budget_sweep,
                                                 run_campaigns)
from rl_mpc_locomotion_tpu_torch.utils import metrics
from rl_mpc_locomotion_tpu_torch.utils.native_runtime import TelemetryLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = os.path.join(REPO, "scripts")


def _jax_tree(name):
    with open(os.path.join(JAX_SCRIPTS, name)) as f:
        return ast.parse(f.read())


def _function(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


# ---- qp_budget_sweep -----------------------------------------------------------

def _jax_summary(gates, div, pri, dua, num_envs):
    """scripts/qp_budget_sweep.py:78-103, line by line."""
    gates, div = jnp.asarray(gates), jnp.asarray(div)
    pri, dua = jnp.asarray(pri), jnp.asarray(dua)
    nsolve = jnp.maximum(jnp.sum(gates), 1) * num_envs
    solve_mask = gates[:, None]
    p_flat = jnp.where(solve_mask, pri, -jnp.inf).reshape(-1)
    d_flat = jnp.where(solve_mask, dua, -jnp.inf).reshape(-1)

    def pctl(v, p):
        v = jnp.sort(v)
        idx = jnp.clip(((1.0 - p) * nsolve).astype(jnp.int32),
                       0, v.shape[0] - 1)
        return v[v.shape[0] - 1 - idx]

    return {"diverged_frac": float(
                jnp.sum(jnp.where(solve_mask, div, 0)) / nsolve),
            "pri_p99": float(pctl(p_flat, 0.99)),
            "dua_p99": float(pctl(d_flat, 0.99))}


@pytest.mark.parametrize("steps, envs, seed", [(40, 8, 0), (600, 64, 1),
                                               (7, 3, 2)])
def test_summarize_matches_jax(steps, envs, seed):
    rng = np.random.default_rng(seed)
    gates = ((np.arange(steps) + 1) % 2 == 0) & (rng.random(steps) > 0.1)
    solve = gates[:, None]
    div = (rng.random((steps, envs)) < 0.05) & solve
    pri = np.where(solve, rng.lognormal(-4, 1, (steps, envs)), 0.0)
    dua = np.where(solve, rng.lognormal(-2, 1, (steps, envs)), 0.0)
    pri, dua = pri.astype(np.float32), dua.astype(np.float32)
    got = qp_budget_sweep._summarize(gates, div, pri, dua, envs)
    assert got == _jax_summary(gates, div, pri, dua, envs)


def _jax_row_keys():
    fn = _function(_jax_tree("qp_budget_sweep.py"), "measure")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"):
            keys |= {kw.arg for kw in node.keywords}
    return keys


def test_measure_returns_the_jax_row():
    want = _jax_row_keys()
    assert want == {"diverged_frac", "pri_p99", "dua_p99", "robot",
                    "qp_iters", "num_envs", "num_steps", "wall_s", "policy"}
    row = qp_budget_sweep.measure("a1", 28, 4, 6,
                                  qp_budget_sweep.DEFAULT_CKPT, device="cpu")
    assert want <= set(row)
    assert (row["robot"], row["qp_iters"], row["num_envs"], row["num_steps"],
            row["policy"]) == ("a1", 28, 4, 6, "trained")
    for k in ("diverged_frac", "pri_p99", "dua_p99",
              "diverged_frac_env_ci95"):
        assert math.isfinite(row[k]), k
    assert 0.0 <= row["diverged_frac"] <= 1.0
    assert row["pri_p99"] > 0.0 and row["dua_p99"] > 0.0


# ---- envelope_sweep ------------------------------------------------------------

def test_envelope_point_writes_the_jax_keys(tmp_path):
    fn = _function(_jax_tree("envelope_sweep.py"), "run")
    result = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "result")
    want = {k.value for k in result.keys}
    ckpt = os.path.join(REPO, "artifacts", "aliengo_weight_policy_rough")
    res = envelope_sweep.run(ckpt, "aliengo", 2, 5, str(tmp_path),
                             device="cpu", vx_grid=[1.0], yaw_grid=[-0.5])
    with open(tmp_path / "envelope.json") as f:
        written = json.load(f)
    assert want <= set(written) and written == json.loads(json.dumps(res))
    assert written["checkpoint"] == "artifacts/aliengo_weight_policy_rough"
    (row,) = written["rows"]
    assert row["command"] == [1.0, 0.0, -0.5]
    for arm in ("policy", "default"):
        assert row[arm]["num_envs"] == 2 and row[arm]["num_steps"] == 5
        assert all(math.isfinite(row[arm][k]) for k in (
            "reward_per_step", "survival_rate", "falls", "lin_vel_err"))
    np.testing.assert_array_equal(envelope_sweep.VX_GRID,
                                  np.linspace(-2.5, 2.5, 9))
    np.testing.assert_array_equal(envelope_sweep.YAW_GRID,
                                  np.linspace(-2.0, 2.0, 5))


# ---- plot_telemetry -------------------------------------------------------------

def _jax_plot_telemetry():
    spec = importlib.util.spec_from_file_location(
        "jax_plot_telemetry", os.path.join(JAX_SCRIPTS, "plot_telemetry.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(n, size, seed):
    return np.random.default_rng(seed).normal(size=(n, size)).astype(
        np.float32)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], k)


def test_load_frames_matches_jax(tmp_path):
    jmod = _jax_plot_telemetry()
    # an MPCFrameLogger .npz
    log = metrics.MPCFrameLogger(str(tmp_path / "logs"))
    for i, f in enumerate(_frames(5, metrics.MPC_FRAME_SIZE, 0)):
        log.log(f[:13], f[13:26], f[26:38], f[38:41], f[41:54], float(i))
    npz = log.flush()
    # a native log of full MPC frames
    full = str(tmp_path / "full.bin")
    tl = TelemetryLogger(full, frame_size=metrics.MPC_FRAME_SIZE)
    for f in _frames(6, metrics.MPC_FRAME_SIZE, 1):
        tl.push(f)
    tl.flush()
    tl.close()
    # a generic log with its .meta sidecar, as cli play --telemetry writes
    gen = str(tmp_path / "play.bin")
    tl = TelemetryLogger(gen, frame_size=len(cli.TELEMETRY_FIELDS),
                         field_names=cli.TELEMETRY_FIELDS)
    for f in _frames(7, len(cli.TELEMETRY_FIELDS), 2):
        tl.push(f)
    tl.flush()
    tl.close()
    for path, n in ((npz, 5), (full, 6), (gen, 7)):
        got, want = plot_telemetry.load_frames(path), jmod.load_frames(path)
        _assert_same(got, want)
        first = got["_generic"]["tick"] if "_generic" in got else got["tick"]
        assert len(first) == n
    plot_telemetry.plot_generic(plot_telemetry.load_frames(gen)["_generic"],
                                str(tmp_path / "play.png"))
    assert (tmp_path / "play.png").exists()


# ---- multidev_scaling -----------------------------------------------------------

def test_multidev_worker_one_rank_on_cpu():
    import torch.distributed as dist
    row = multidev_scaling._worker(1, envs_per_device=4, timed_iters=1,
                                   device_type="cpu", rollout_steps=4)
    assert not dist.is_initialized()
    assert (row["n_devices"], row["envs_per_device"], row["global_envs"],
            row["rollout_steps"], row["sharded"]) == (1, 4, 4, 4, True)
    # CPU times under cpu_ names only, the device names hold None
    assert row["iter_ms"] is None and row["env_steps_per_s"] is None
    assert row["cpu_iter_ms"] > 0 and len(row["cpu_iter_ms_per_rank"]) == 1
    assert row["cpu_env_steps_per_s"] == pytest.approx(
        4 * 4 / (row["cpu_iter_ms"] * 1e-3))
    assert row["metrics_finite"] and row["device"] == "cpu"
    assert row["row1_launches_per_iteration"] == 0.0   # no card


# ---- the campaigns -------------------------------------------------------------

def _literal_call(node):
    return ([ast.literal_eval(a) for a in node.args],
            {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords})


def _assigned(tree, name):
    return next(n.value for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == name)


def test_campaigns_and_dr_specs_match_jax():
    tree = _jax_tree("run_campaigns.py")
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "Campaign")
    want_fields = [(n.target.id, None if n.value is None
                    else ast.literal_eval(n.value))
                   for n in cls.body if isinstance(n, ast.AnnAssign)]
    got_fields = [(f.name, None if f.default is dataclasses.MISSING
                   else f.default)
                  for f in dataclasses.fields(run_campaigns.Campaign)]
    assert got_fields == want_fields

    camps = _assigned(tree, "CAMPAIGNS")
    want = {ast.literal_eval(k): _literal_call(v)
            for k, v in zip(camps.keys, camps.values)}
    assert list(run_campaigns.CAMPAIGNS) == list(want)
    for key, (args, kw) in want.items():
        assert run_campaigns.CAMPAIGNS[key] == run_campaigns.Campaign(
            *args, **kw), key

    specs = _assigned(tree, "DR_SPECS")
    assert len(run_campaigns.DR_SPECS) == len(specs.elts)
    for (target, spec), node in zip(run_campaigns.DR_SPECS, specs.elts):
        assert target == ast.literal_eval(node.elts[0])
        _, kw = _literal_call(node.elts[1])
        for k, v in kw.items():
            assert getattr(spec, k) == v, (target, k)


def test_env_config_is_production_with_the_kernel():
    cfg = run_campaigns.env_config("rough", True, True, robot="a1")
    assert cfg.control.qp.use_kernel and not cfg.control.flat_ground
    assert cfg.base_init_height == 0.3
    assert cfg.dr.specs == run_campaigns.DR_SPECS
    assert cfg.command_curriculum_ticks == 30000


def test_mixed_campaign_cycles_the_robots():
    c = dataclasses.replace(run_campaigns.CAMPAIGNS["mixed_rough"],
                            num_envs=5)
    params = run_campaigns.train_params(c, "cpu")
    want = [robots.aliengo_params, robots.go1_params, robots.a1_params,
            robots.aliengo_params, robots.go1_params]
    np.testing.assert_array_equal(
        params.body_mass.numpy(),
        [float(fn("cpu").body_mass) for fn in want])


def test_one_campaign_runs(tmp_path, monkeypatch):
    # TensorBoard's import costs ~20 s here; the JSONL sink is what is read
    monkeypatch.setattr(metrics, "_tensorboard_writer", lambda: None)
    out = run_campaigns.run("a1_rough", device="cpu",
                            runs_dir=str(tmp_path), iterations=2, num_envs=8,
                            eval_envs=4, eval_steps=10)
    assert out == str(tmp_path / "a1_weight_policy_rough")
    assert sorted(os.listdir(out)) == ["eval_ab.json", "metrics.jsonl",
                                       "model_2", "model_2_env",
                                       "reward_curve.png"]
    with open(os.path.join(out, "eval_ab.json")) as f:
        res = json.load(f)
    with open(os.path.join(REPO, "artifacts", "a1_weight_policy_rough",
                           "eval_ab.json")) as f:
        committed = json.load(f)
    assert set(res) == set(committed) - {"selection"}
    for arm in ("policy", "default"):
        assert set(res[arm]) == set(committed[arm])
        assert res[arm]["seeds"] == [0, 1, 2]
        assert (res[arm]["num_envs"], res[arm]["num_steps"]) == (4, 10)
    assert set(res["win_criteria"]) == set(committed["win_criteria"])
    assert extend_and_select.candidates(out) == [2]


def _ab(p_surv, d_surv, p_rew, d_rew, win):
    return {"policy": {"survival_rate": p_surv, "reward_per_step": p_rew},
            "default": {"survival_rate": d_surv, "reward_per_step": d_rew},
            "policy_beats_default": win}


def test_ranking_on_hand_made_evals():
    results = [
        (100, {"a1": _ab(0.90, 0.80, 0.010, 0.008, True),
               "go1": _ab(0.70, 0.80, 0.012, 0.008, False)}),
        (200, {"a1": _ab(0.95, 0.80, 0.009, 0.008, True),
               "go1": _ab(0.90, 0.80, 0.009, 0.008, True)}),
        (300, {"a1": _ab(0.85, 0.80, 0.020, 0.008, True),
               "go1": _ab(0.90, 0.80, 0.020, 0.008, True)}),
        # ties 300 on every component: the later one ranks higher, as the
        # JAX file's stable sort of the candidates in order gives
        (400, {"a1": _ab(0.85, 0.80, 0.020, 0.008, True),
               "go1": _ab(0.90, 0.80, 0.020, 0.008, True)}),
        (500, {"a1": _ab(1.00, 0.80, 0.030, 0.008, False),
               "go1": _ab(1.00, 0.80, 0.030, 0.008, False)}),
    ]
    score = extend_and_select.score(results[0][1])
    assert score[0] == 1
    assert score[1] == pytest.approx(-0.10)
    assert score[2] == pytest.approx(0.006)
    ranked = extend_and_select.rank(results)
    # the JAX file: scores.sort(key=lambda t: t[0]) over the candidates
    jax_order = [(extend_and_select.score(r), s, r) for s, r in results]
    jax_order.sort(key=lambda t: t[0])
    assert [s for _, s, _ in ranked] == [s for _, s, _ in jax_order]
    # wins first, then the least survival margin (200's 0.10 over 300's
    # and 400's 0.05), then the reward margin
    assert [s for _, s, _ in ranked] == [500, 100, 300, 400, 200]
    sel = extend_and_select.selection_record(ranked, (0, 1, 2), (3, 4, 5),
                                             500, ranked[-1][1])
    assert sel["chosen_step"] == 200 and len(sel["candidates"]) == 5


# ---- imports --------------------------------------------------------------------

def test_new_modules_import_without_matplotlib_or_jax():
    mods = (["rl_mpc_locomotion_tpu_torch.cli",
             "rl_mpc_locomotion_tpu_torch.utils.viewer"]
            + [f"rl_mpc_locomotion_tpu_torch.{pkg}.{f[:-3]}"
               for pkg in ("examples", "scripts")
               for f in sorted(os.listdir(os.path.join(
                   REPO, "rl_mpc_locomotion_tpu_torch", pkg)))
               if f.endswith(".py")])
    assert len(mods) == 14
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in ('matplotlib', 'jax') if m in sys.modules]\n"
            "print('ok' if not bad else bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", (
        out.stdout, out.stderr)
