"""Test-process setup of the port's suite, loaded before ``tests/conftest.py``
(the JAX reference's, which pins JAX to the CPU).

Thread sizing for the tests lives here and nowhere else: each pytest-xdist
worker gets an equal share of the cores this process may run on, the whole
set without xdist. OpenMP and BLAS read their variables when they load, and
this file runs before numpy, torch or jax is imported by a test file;
``threadpool_limits`` caps a pool that a plugin loaded earlier. Spawned
workers inherit the variables. XLA's CPU pool is not capped: jaxlib sizes it
to at least the device count, and the 8 virtual devices hold it at 8 whatever
XLA_FLAGS says.
"""
import os
import sys

WORKER_THREADS = max(1, len(os.sched_getaffinity(0))
                     // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = str(WORKER_THREADS)


def pytest_configure(config):
    try:
        import threadpoolctl
    except ImportError:
        pass
    else:
        threadpoolctl.threadpool_limits(WORKER_THREADS)
    try:
        import torch
    except ImportError:
        pass
    else:
        torch.set_num_threads(WORKER_THREADS)
        torch.set_num_interop_threads(WORKER_THREADS)
    if "jax" in sys.modules:
        # runner.fsm_step and cli's jitted tick import fsm lazily; a first
        # import inside a jax.jit trace leaks its module constants as tracers
        import rl_mpc_locomotion_tpu.control.fsm  # noqa: F401
