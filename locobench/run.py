"""The benchmark of rl_mpc_locomotion_tpu_torch on one card.

    python3 locobench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``,
each compared number beside its limit); earlier lines give the set-up in
parts, the spread of the window's steps and what the comparison saw. Exits non-zero, with no result, without
the card the workload asks for, or when a JAX module was loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
os.environ["RLMPC_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "locobench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "locobench_triton")
sys.path.insert(0, ROOT)

from locobench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
