"""A fleet served in lockstep: the Min-mode controller alone, one MPC period
a step (two ticks of ``runner.min_step``, the second gated to solve), the
inputs cycling through the traffic's snapshots. The torques stay on the
device; nothing is read back inside the window.

``impl="program"`` drives the port; ``impl="control_tf32"`` puts the plain
reference, in float32 with TF32 matmuls, in its place (the control of the
comparison; the benchmark's own runs never take it).
"""
from __future__ import annotations

import torch

from locobench import compare, traffic as traffic_mod
from locobench.loops import common
from locobench.reference import controller as ref


class Cell:
    """The fleet: set-up, the window's periods, and their comparison."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 impl: str = "program"):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.impl = device, impl
        self.robots = traffic["robots"]

    def build(self):
        self.inputs = traffic_mod.snapshots(self.traffic, self.seed, self.device)
        self.tick = common.make_tick(self.config, self.robots, self.device,
                                     self.impl)
        self.state0 = self.tick.init_state()
        self.state, self.k = self.state0, 0
        self.diverged = torch.zeros((), dtype=torch.int64, device=self.device)
        self.failed = torch.zeros((), dtype=torch.int64, device=self.device)

    def _snapshot(self, k):
        i = k % self.traffic["snapshots"]
        return tuple(self.inputs[n][i] for n in ("q", "qd", "body", "commands"))

    def _period(self, state, k, traced):
        q, qd, body, cmd = self._snapshot(k)
        with common.span("tick.min_step", traced):
            mid, tau1, _ = self.tick(state, q, qd, body, cmd, False)
        with common.span("tick.min_step", traced):
            new, tau2, out = self.tick(mid, q, qd, body, cmd, True)
        return mid, tau1, new, tau2, out

    def warmup(self):
        for _ in range(self.traffic["warmup_steps"]):
            self.step(False)
        self.start = (self.k, self.state, self.last)
        self.diverged.zero_()
        self.failed.zero_()

    def step(self, traced: bool):
        prev, k = self.state, self.k
        mid, tau1, new, tau2, out = self._period(prev, k, traced)
        self.diverged += out["qp_diverged"].sum()
        self.failed += (~(torch.isfinite(tau1).all(-1)
                          & torch.isfinite(tau2).all(-1))).sum()
        self.state, self.k = new, k + 1
        self.last = (k, prev, mid, tau1, new, tau2, out)
        return self.last

    def end_to_end(self, step_ms: list) -> dict:
        window_s = sum(step_ms) * 1e-3
        return {"solves_per_s": self.robots * len(step_ms) / window_s,
                "period_p95_ms": traffic_mod.quantile(step_ms, 0.95)}

    def counts(self, steps: int) -> tuple:
        """(attempted, failed, diverged): the window's robot-periods, those
        whose torques were not finite, and the solves that diverged (the
        controller then holds its previous forces, as it is built to)."""
        return self.robots * steps, int(self.failed), int(self.diverged)

    # ---- the comparison ---------------------------------------------------

    def take(self, records):
        """The sampled robots of the start and of the kept steps, copied out
        of the program's tensors; then every program tensor is let go."""
        idx = traffic_mod.sample(self.robots, self.traffic["check"]["robots"],
                                 self.seed).to(self.device)
        pick = common.picker(idx)
        self.kept = {
            "idx": idx,
            "state0": pick(self.state0),
            "start": (self.start[0], pick(self.start[1]),
                      pick(self.start[2][5])),
            "steps": [(r[0], pick(r[1]), pick(r[2]), pick(r[3]), pick(r[4]),
                       pick(r[5]), pick(r[6]["qp_primal_violation"]))
                      for r in records],
            "inputs": [pick(tuple(v[i] for v in (self.inputs["q"],
                                                  self.inputs["qd"],
                                                  self.inputs["body"],
                                                  self.inputs["commands"])))
                       for i in range(self.traffic["snapshots"])]}
        del self.inputs, self.state, self.state0, self.start, self.last
        self.tick = None

    def check(self) -> dict:
        """Run the reference in float64 on the kept robots: from its own
        first state through the warm-up (``start_gap``), and from the
        program's own state at each kept period (the other numbers)."""
        kept, cfg = self.kept, self.config
        dt = torch.float64
        params, ctrl = common.ref_params(cfg, dt, self.device)
        floors, groups, default = common.compare_spec(cfg)
        margin = cfg["compare"]["divergence_margin"]
        tol = ctrl.qp_divergence_tol
        n = kept["idx"].shape[0]
        inputs = [tuple(t.to(dt) for t in snap) for snap in kept["inputs"]]
        S = len(inputs)

        def edge(viol):
            return (viol - tol).abs() < margin

        # the start: the reference's own first state, then the warm-up
        st = ref.init_state(params, ctrl, n, dt, self.device)
        t0 = compare.Tally(n, self.device, {}, "start_gap")
        t0.add(common.ref_tree(kept["state0"]), compare.flatten(st), floors)
        near = torch.zeros(n, dtype=torch.bool, device=self.device)
        for k in range(kept["start"][0]):
            q, qd, body, cmd = inputs[k % S]
            st, _, _ = ref.tick(params, ctrl, st, q, qd, body, cmd, False)
            st, tau, out = ref.tick(params, ctrl, st, q, qd, body, cmd, True)
            near |= edge(out["violation"])
        t0.add(common.ref_tree(kept["start"][1]) | {"tau": kept["start"][2]},
               compare.flatten(st) | {"tau": tau}, floors, near)
        # the window: each kept period from the program's state before it
        parts = []
        for k, prev, mid, tau1, new, tau2, viol in kept["steps"]:
            q, qd, body, cmd = inputs[k % S]
            t = compare.Tally(n, self.device, groups, default)
            r_mid, r_tau1, _ = ref.tick(params, ctrl, common.as_ref(prev, dt),
                                        q, qd, body, cmd, False)
            t.add(common.ref_tree(mid) | {"tau": tau1},
                  compare.flatten(r_mid) | {"tau": r_tau1}, floors)
            r_new, r_tau2, out = ref.tick(params, ctrl, common.as_ref(mid, dt),
                                          q, qd, body, cmd, True)
            t.add(common.ref_tree(new) | {"tau": tau2, "violation": viol},
                  compare.flatten(r_new) | {"tau": r_tau2,
                                            "violation": out["violation"]},
                  floors, edge(out["violation"]))
            parts.append(t.finish())
        res = compare.numbers(compare.combine(parts), t0.finish())
        res["_info"].update(robots=n, steps=[s[0] for s in kept["steps"]])
        return res
