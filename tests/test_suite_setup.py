"""The two rules the repo's root ``conftest.py`` sets for every test process.

- A module that the JAX package imports lazily inside a traced function is
  imported before any trace can: the two demos, run in a fresh process in
  this order, fail with ``UnexpectedTracerError`` without it.
- Each pytest-xdist worker's torch, BLAS and OpenMP pools hold its share of
  the cores, derived from the CPU affinity and the worker count.
"""
import os
import subprocess
import sys

import threadpoolctl
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lazy_jax_imports_survive_a_trace():
    """mpc_terrain_show's jitted tick reaches ``runner.fsm_step`` first;
    rl_mpc_show then reads fsm's module constants."""
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "tests/test_examples.py::test_mpc_terrain_show_runs",
         "tests/test_examples.py::test_rl_mpc_show_runs"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    assert "2 passed" in out.stdout, out.stdout[-4000:]


def test_worker_pools_are_at_their_share():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    share = max(1, len(os.sched_getaffinity(0)) // workers)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        assert os.environ[var] == str(share), var
    assert torch.get_num_threads() == share
    assert torch.get_num_interop_threads() == share
    pools = [p for p in threadpoolctl.threadpool_info()
             if p["user_api"] in ("blas", "openmp")]
    assert any(p["user_api"] == "blas" for p in pools), pools
    for pool in pools:
        assert pool["num_threads"] == share, pool
