"""Re-run the multi-seed A/B eval (and the reward-curve plot and the
checkpoint clean-up: every checkpoint but the latest, the one evaluated,
goes) of an existing campaign run, without retraining.

Counterpart of ``scripts/eval_only.py``, for runs under
``runs_torch/<name>/`` (``run_campaigns``): used when an eval needs
regenerating against new eval code or with more seeds, while the run's
checkpoint stays the source of truth.

Usage: python -m rl_mpc_locomotion_tpu_torch.scripts.eval_only
       aliengo_rough [aliengo_flat ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from .extend_and_select import candidates
from .run_campaigns import (CAMPAIGNS, RUNS_DIR, eval_campaign, plot_curve,
                            remove_checkpoints)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("campaigns", nargs="+")
    ap.add_argument("--runs-dir", default=RUNS_DIR)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    for key in args.campaigns:
        c = CAMPAIGNS[key]
        out_dir = os.path.join(args.runs_dir, c.name)
        if not os.path.isdir(out_dir):
            raise FileNotFoundError(f"no run of {key} at {out_dir}")
        # the checkpoint evaluated is the run's latest (model_<iterations>
        # after run_campaigns, the winner after extend_and_select): keep it
        latest = max(candidates(out_dir))
        eval_campaign(c, out_dir, device=args.device)
        if not os.path.exists(os.path.join(out_dir, "reward_curve.png")):
            plot_curve(out_dir)
        remove_checkpoints(out_dir, lambda _, step: step == latest)
        print(f"[eval_only {key}] done -> {out_dir}")


if __name__ == "__main__":
    main()
