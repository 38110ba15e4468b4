"""The readings that the correctness limits are set from, many seeds in one
process (the set-up's imports and the kernel build are paid once):

    python3 locobench/readings.py --workload <name> --seeds 11,12,... \
        --seconds 3 [--impl control_tf32]

For each seed: the cell's set-up, a short window at the cell's own size,
then the comparison, as a run makes them; one JSON line a seed with the
compared numbers and every field's worst gap. ``--impl control_tf32`` puts
the plain reference in float32 with TF32 matmuls in the program's place:
the control, whose readings have to fail. Not a benchmark run.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["RLMPC_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "locobench")
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from locobench import harness  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser(prog="python3 locobench/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--impl", default="program",
                   choices=("program", "control_tf32"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    spec = harness.cell_spec(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        cell = harness.make_cell(spec, seed, dev, args.impl)
        cell.build()
        cell.warmup()
        step_ms, records = harness.measure(cell, torch, args.seconds)
        attempted, failed, diverged = cell.counts(len(step_ms))
        cell.take(records)
        del records
        torch.cuda.empty_cache()
        numbers = cell.check()
        info = numbers.pop("_info")
        print(json.dumps({"seed": seed, "impl": args.impl, **numbers,
                          "edge_robots": info["edge_robots"],
                          "edge_mismatches": info["edge_mismatches"],
                          "fields": info["all_fields"],
                          "start_fields": info["start_all_fields"],
                          "steps": len(step_ms), "kept": info["steps"],
                          "failed": failed,
                          "diverged_share": diverged / attempted,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
