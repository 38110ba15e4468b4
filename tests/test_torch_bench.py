"""The port's benchmark harness (``rl_mpc_locomotion_tpu_torch/bench.py``,
``profile period`` / ``qp-knobs``) against the root ``bench.py``, on the CPU.

The root file is loaded from its path (its import points JAX's compilation
cache at ``.jax_cache``; the test points it back). Its inputs are taken from
its own source: the four assignments of ``bench`` (``bench.py:75-80``) run
alone. The lockstep loop: two periods at batch 2 against the JAX loop's four
ticks (un-jitted ``jax.vmap`` of ``runner.min_step``, the gate passed
unbatched), both on the plain QP pipeline at the production solve shape,
torques within 5e-4 of max(1, |tau|) (``tests/test_torch_control_step.py``'s
tolerance). The entry points run with ``device="cpu"`` at tiny sizes: the
root file's keys, the CPU's times only under ``cpu_*`` names; without a card
each entry raises by default.
"""
import ast
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from rl_mpc_locomotion_tpu_torch import bench, profile
from rl_mpc_locomotion_tpu_torch.ops.cuda import fused_qp
from rl_mpc_locomotion_tpu_torch.ops.qp import QPConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
# the production solve shape on the plain pipeline of both packages
FAST = dict(iters=24, iters2=0, adaptive_rho=False, deferred_rho=True,
            polish=False, ruiz_iters=2)
DETAIL_KEYS = {"batch", "mpc_period_ms", "control_ticks_per_s",
               "realtime_budget_ms", "qp_iters", "physical_floor_ms"}
ROW_KEYS = {"batch", "period_ms", "p50_ms", "p99_ms", "solves_per_s",
            "physical_floor_ms", "rejected_samples",
            "stall_rejected_samples", "realtime"}
TRAIN_KEYS = {"num_envs", "ppo_iteration_ms", "ppo_iteration_p99_ms",
              "rollout_steps", "terrain", "dr", "iters_timed"}


@pytest.fixture(scope="module")
def jbench():
    """The root bench.py as a module; JAX's cache directory restored."""
    import jax
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


def jax_bench_inputs(batch):
    """dof_q, dof_qd, body, commands as the root bench() computes them:
    its own assignments, run alone."""
    import jax.numpy as jnp
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "bench")
    names = ("dof_q", "dof_qd", "body", "commands")
    stmts = [n for n in fn.body if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Name)
             and n.targets[0].id in names]
    assert [s.targets[0].id for s in stmts] == list(names)
    scope = {"jnp": jnp, "batch": batch}
    exec(compile(ast.Module(body=stmts, type_ignores=[]), "bench.py",
                 "exec"), scope)
    return [np.asarray(scope[n]) for n in names]


def test_physical_floor_is_the_jax_flop_count_at_the_h100_peak(jbench):
    assert bench._FLOPS_PER_QP_ITER == jbench._FLOPS_PER_QP_ITER == 124800
    # 132 SMs x 128 float32 lanes x 2 (FMA) x 1.98 GHz
    assert bench.PEAK_F32_FLOPS == pytest.approx(132 * 128 * 2 * 1.98e9,
                                                 rel=2e-3)
    assert round(bench.physical_floor_ms(4096, 24), 3) == 0.183
    assert bench.physical_floor_ms(4096, 24) == pytest.approx(
        jbench.physical_floor_ms(4096, 24) * 2e14 / 67e12, rel=1e-12)


def test_bench_inputs_equal_the_jax_bench():
    for got, want in zip(bench.bench_inputs(5, "cpu"), jax_bench_inputs(5)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_lockstep_two_periods_match_the_jax_loop():
    import jax
    import jax.numpy as jnp
    from rl_mpc_locomotion_tpu.control import runner as jrunner
    from rl_mpc_locomotion_tpu.control.types import ControlConfig as JCC
    from rl_mpc_locomotion_tpu.models import robots as jrobots
    from rl_mpc_locomotion_tpu.ops.qp import QPConfig as JQPConfig
    from test_torch_control_step import assert_torques_close

    batch = 2
    jp = jrobots.aliengo_params()
    jcfg = JCC(qp=JQPConfig(use_pallas=False, **FAST))
    jstate = jax.vmap(lambda _: jrunner.init_state(jp, jcfg))(
        jnp.arange(batch))
    inputs = [jnp.asarray(x) for x in jax_bench_inputs(batch)]
    want = []
    for t in range(4):
        jstate, tau, _ = jax.vmap(
            lambda s, q, qd, b, c: jrunner.min_step(
                jp, jcfg, s, q, qd, b, c,
                solve_gate=jnp.bool_(t % 2 == 1)))(jstate, *inputs)
        want.append(np.asarray(tau))

    cfg, state, period = bench.lockstep(batch, torch.device("cpu"),
                                        QPConfig(use_kernel=False, **FAST))
    got = []
    for _ in range(2):
        state, tau, metrics = period(state)
        got.append(tau.numpy())
    assert cfg.qp.iters == 24
    assert_torques_close(got, want[1::2], 5e-4, "lockstep")
    assert np.abs(got[-1]).max() > 1.0          # the solve moved the legs


def _no_bare_times(d):
    """No timed key outside cpu_* holds a number on the CPU."""
    for k, v in d.items():
        if k.endswith(("_ms", "_per_s")) and not k.startswith("cpu_") \
                and k not in ("physical_floor_ms", "realtime_budget_ms"):
            assert v is None, k


def test_entries_on_the_cpu(tmp_path, capsys):
    before = fused_qp.launch_count()
    r = bench.bench(batch=2, warmup=1, iters=3, device="cpu")
    assert {"metric", "value", "unit", "vs_baseline", "detail"} <= set(r)
    assert r["metric"] == "mpc_solves_per_s"
    assert r["value"] is None and r["vs_baseline"] is None
    assert r["cpu_value"] > 0
    d = r["detail"]
    assert DETAIL_KEYS <= set(d) and d["qp_iters"] == 24
    assert d["mpc_period_ms"] is None and d["cpu_mpc_period_ms"] > 0
    assert d["cpu_period_p99_ms"] >= d["cpu_period_p50_ms"] > 0
    assert d["physical_floor_ms"] == bench.physical_floor_ms(2, 24)
    assert d["kernel_launches"] == 0 and d["torques_finite"]
    assert d["device"] == "cpu" and d["clock"] == "host"
    _no_bare_times(d)

    s = bench.sweep(batches=(2, 3), iters=2, warmup=1, out=tmp_path,
                    device="cpu")
    on_disk = json.loads((tmp_path / "SWEEP_torch.json").read_text())
    assert on_disk == json.loads(json.dumps(s))
    assert [row["batch"] for row in s["rows"]] == [2, 3] and not s["failed"]
    for row in s["rows"]:
        assert ROW_KEYS <= set(row) and row["cpu_p99_ms"] > 0
        assert row["realtime"] == (row["cpu_p99_ms"] <= 20.0)
        _no_bare_times(row)
    assert "largest_realtime_batch" in s

    t = bench.bench_train(num_envs=4, warmup=0, iters=1, device="cpu")
    assert t["metric"] == "train_env_steps_per_s" and t["value"] is None
    assert TRAIN_KEYS <= set(t["detail"]) and t["cpu_value"] > 0
    assert t["detail"]["rollout_steps"] == 24
    assert t["detail"]["metrics_finite"]
    _no_bare_times(t["detail"])
    assert fused_qp.launch_count() == before

    capsys.readouterr()
    profile.main(["period", "--device", "cpu", "--batch", "2", "--reps", "2",
                  "--iters-sweep", "10", "--ruiz-sweep", "0"])
    profile.main(["qp-knobs", "--device", "cpu", "--batch", "2", "--reps",
                  "2"])
    period, knobs = map(json.loads, capsys.readouterr().out.splitlines())
    assert {k for k in period if k.startswith("cpu_")} == {
        "cpu_no_solve_x2", "cpu_prod", "cpu_iters10", "cpu_ruiz0"}
    assert {k for k in knobs if k.startswith("cpu_")} == {
        "cpu_" + k for k in profile.QP_KNOBS}
    assert all(v > 0 for k, v in {**period, **knobs}.items()
               if k.startswith("cpu_"))


def _walk(a, b, path=""):
    """Every field of the port's config equal to the JAX package's
    (``use_kernel`` is the port's name for ``use_pallas``)."""
    if dataclasses.is_dataclass(a) or hasattr(a, "_fields"):
        names = ([f.name for f in dataclasses.fields(a)]
                 if dataclasses.is_dataclass(a) else list(a._fields))
        for name in names:
            other = "use_pallas" if name == "use_kernel" else name
            _walk(getattr(a, name), getattr(b, other), f"{path}.{name}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def test_bench_train_config_equals_the_jax_bench_train(jbench, monkeypatch):
    """The TrainConfig the root bench_train builds, caught where it reaches
    make_train_step (nothing is compiled), against the port's."""
    from rl_mpc_locomotion_tpu.rl import train as jtrain

    class Built(Exception):
        pass

    def catch(params, cfg, ter, model, mesh=None):
        raise Built(cfg)

    monkeypatch.setattr(jtrain, "make_train_step", catch)
    with pytest.raises(Built) as built:
        jbench.bench_train(num_envs=64)
    want = built.value.args[0]
    got = bench.train_config(64, device="cpu")
    assert got.env.dr is not None and got.env.control.flat_ground is False
    _walk(got, want)


def test_entries_raise_without_a_card(tmp_path):
    """Every entry defaults to the card and raises without one, before it
    writes anything (the sweeps would otherwise record every batch as
    failed)."""
    if torch.cuda.is_available():
        return
    calls = [bench.bench, bench.bench_train, bench.median_period_ms,
             lambda: bench.sweep(out=tmp_path),
             lambda: bench.train_sweep(out=tmp_path),
             profile.run_period, profile.run_qp_knobs,
             lambda: bench.main([]), lambda: bench.main(["--train"])]
    for fn in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(4, None) if fn is bench.median_period_ms else fn()
    assert not list(tmp_path.iterdir())
