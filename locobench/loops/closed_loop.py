"""A closed loop: the Min-mode controller and the plant, one
``runner.min_step`` and one ``physics.step`` a tick (every second tick
solves), on flat ground from the traffic's start, each robot holding its
command. Nothing is read back inside the window.

``impl="control_tf32"`` puts the plain reference of both, in float32 with
TF32 matmuls, in the program's place (the control of the comparison).
"""
from __future__ import annotations

import torch

from locobench import compare, traffic as traffic_mod
from locobench.loops import common
from locobench.reference import controller as ref
from locobench.reference import plant as ref_plant

# increments of these plant fields over a tick are compared, not the fields
INCREMENTS = ("pos", "quat", "v", "omega", "q", "qd", "anchor")


class ProgramPlant:
    """``physics.step`` of the port with the articulated plant attached."""

    def __init__(self, config: dict, params, device):
        from rl_mpc_locomotion_tpu_torch.sim import physics, terrain
        p = config["plant"]
        self.physics, self.params = physics, params
        self.cfg = physics.PhysicsConfig(articulated=True, **{
            k: p[k] for k in ("dt", "substeps", "joint_damping",
                              "joint_friction", "tau_limit", "contact_kn",
                              "contact_cn", "contact_kt", "contact_ct",
                              "friction_mu", "q_min", "q_max")})
        self.ter = terrain.flat(extent=p["terrain_extent"],
                                cell=p["terrain_cell"], device=device)

    def init_state(self, q0, height):
        return self.physics.init_state(self.params, q0, height, q0.shape[0],
                                       q0.device)

    def root_state(self, ps):
        return self.physics.root_state_vector(ps)

    def __call__(self, ps, tau):
        return self.physics.step(self.params, self.cfg, self.ter, ps, tau)[0]


class ControlPlant:
    """The reference plant in TF32 (``common.TF32``) in the program's place."""

    def __init__(self, config: dict, device):
        self.model = common.plant_model(config, torch.float32, device)
        self.cfg = config["plant"]

    def init_state(self, q0, height):
        return ref_plant.init_state(q0, height, torch.float32, q0.device)

    def root_state(self, ps):
        return ref_plant.root_state(ps)

    def __call__(self, ps, tau):
        with common.TF32():
            return ref_plant.step(self.model, self.cfg, ps, tau)[0]


class Cell:
    """The closed loop: set-up, the window's ticks, and their comparison."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 impl: str = "program"):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.impl = device, impl
        self.robots = traffic["robots"]

    def build(self):
        self.inputs = traffic_mod.start(self.traffic, self.seed, self.device)
        self.tick = common.make_tick(self.config, self.robots, self.device,
                                     self.impl)
        self.plant = (ProgramPlant(self.config, self.tick.params, self.device)
                      if self.impl == "program"
                      else ControlPlant(self.config, self.device))
        self.height = self.tick.params.body_height + self.traffic["height_offset"]
        self.cs0 = self.tick.init_state()
        self.ps0 = self.plant.init_state(self.inputs["q0"], self.height)
        self.state, self.t = (self.cs0, self.ps0), 0
        self.diverged = torch.zeros((), dtype=torch.int64, device=self.device)
        self.failed = torch.zeros((), dtype=torch.int64, device=self.device)

    def _tick(self, cs, ps, t, traced):
        with common.span("tick.min_step", traced):
            cs_new, tau, out = self.tick(cs, ps.q, ps.qd, self.plant.root_state(ps),
                                         self.inputs["commands"], t % 2 == 1)
        with common.span("plant.physics_step", traced):
            ps_new = self.plant(ps, tau)
        return cs_new, ps_new, tau, out

    def warmup(self):
        for _ in range(self.traffic["warmup_steps"]):
            self.step(False)
        self.start = (self.t, self.state, self.last)
        self.diverged.zero_()
        self.failed.zero_()

    def step(self, traced: bool):
        """One tick. Returns the record of a whole MPC period, the tick
        that does not solve and the one that does, on the second of them,
        and None on the first: the comparison keeps periods."""
        (cs, ps), t = self.state, self.t
        cs_new, ps_new, tau, out = self._tick(cs, ps, t, traced)
        self.diverged += out["qp_diverged"].sum()
        self.failed += (~torch.isfinite(tau).all(-1)).sum()
        self.state, self.t = (cs_new, ps_new), t + 1
        self.last = (t, cs, ps, cs_new, ps_new, tau, out)
        if t % 2 == 0:
            self.pending = self.last
            return None
        pair, self.pending = (self.pending, self.last), None
        return pair if pair[0] is not None else None

    def end_to_end(self, step_ms: list) -> dict:
        return {"robot_ticks_per_s":
                self.robots * len(step_ms) / (sum(step_ms) * 1e-3)}

    def counts(self, steps: int) -> tuple:
        """(attempted, failed, diverged): the window's robot-ticks, those
        whose torques were not finite, and the solves that diverged (the
        controller then holds its previous forces, as it is built to)."""
        return self.robots * steps, int(self.failed), int(self.diverged)

    # ---- the comparison ---------------------------------------------------

    def take(self, records):
        idx = traffic_mod.sample(self.robots, self.traffic["check"]["robots"],
                                 self.seed).to(self.device)
        pick = common.picker(idx)
        self.kept = {
            "idx": idx, "q0": pick(self.inputs["q0"]),
            "commands": pick(self.inputs["commands"]),
            "state0": pick((self.cs0, self.ps0)),
            "start": (self.start[0], pick(self.start[1]), pick(self.start[2][5])),
            "steps": [[(r[0], pick(r[1]), pick(r[2]), pick(r[3]), pick(r[4]),
                        pick(r[5]), pick(r[6]["qp_primal_violation"]))
                       for r in pair] for pair in records]}
        del self.inputs, self.state, self.cs0, self.ps0, self.start, self.last
        self.pending = None
        self.tick = self.plant = None

    def check(self) -> dict:
        """Run the reference in float64 on the kept robots: from its own
        first state through the warm-up (``start_gap``), and from the
        program's own state at each tick of the kept periods."""
        kept, cfg = self.kept, self.config
        dt = torch.float64
        params, ctrl = common.ref_params(cfg, dt, self.device)
        model = common.plant_model(cfg, dt, self.device)
        pcfg = cfg["plant"]
        floors, groups, default = common.compare_spec(cfg)
        tol = ctrl.qp_divergence_tol
        n = kept["idx"].shape[0]
        cmd = kept["commands"].to(dt)

        def edge(viol, margin):
            return (((viol - tol).abs() < cfg["compare"]["divergence_margin"])
                    | (margin < cfg["compare"]["contact_margin_m"]))

        def ref_tick(cs, ps, t):
            cs, tau, out = ref.tick(params, ctrl, cs, ps.q, ps.qd,
                                    ref_plant.root_state(ps), cmd, t % 2 == 1)
            ps_new, margin = ref_plant.step(model, pcfg, ps, tau)
            return cs, ps_new, tau, out, margin

        def plant_tree(ps_new, ps_prev):
            return {"plant." + f: (getattr(ps_new, f).to(dt)
                                   - getattr(ps_prev, f).to(dt)
                                   if f in INCREMENTS else getattr(ps_new, f))
                    for f in ref_plant.State._fields}

        def as_plant(ps):
            return ref_plant.State(*[x.to(dt) if torch.is_floating_point(x)
                                     else x for x in compare.convert(
                                         ps, ref_plant.State, {}, lambda v: v)])

        # the start: the reference's own first state, then the warm-up
        height = params.body_height + self.traffic["height_offset"]
        cs = ref.init_state(params, ctrl, n, dt, self.device)
        ps = ref_plant.init_state(kept["q0"], height, dt, self.device)
        t0 = compare.Tally(n, self.device, {}, "start_gap")
        cs_p0, ps_p0 = kept["state0"]
        t0.add(common.ref_tree(cs_p0) | {f"plant0.{f}": getattr(ps_p0, f)
                                         for f in ref_plant.State._fields},
               compare.flatten(cs) | {f"plant0.{f}": getattr(ps, f)
                                      for f in ref_plant.State._fields}, floors)
        near = torch.zeros(n, dtype=torch.bool, device=self.device)
        ps_first = ps
        for t in range(kept["start"][0]):
            cs, ps, tau, out, margin = ref_tick(cs, ps, t)
            near |= edge(out["violation"], margin)
        cs_pw, ps_pw = kept["start"][1]
        t0.add(common.ref_tree(cs_pw) | {"tau": kept["start"][2]}
               | plant_tree(ps_pw, ps_first),
               compare.flatten(cs) | {"tau": tau} | plant_tree(ps, ps_first),
               floors, near)
        # the window: each tick of a kept period from the program's state
        parts = []
        for pair in kept["steps"]:
            tally = compare.Tally(n, self.device, groups, default)
            for t, cs_prev, ps_prev, cs_new, ps_new, tau, viol in pair:
                ps_ref0 = as_plant(ps_prev)
                r_cs, r_ps, r_tau, out, margin = ref_tick(
                    common.as_ref(cs_prev, dt), ps_ref0, t)
                tally.add(common.ref_tree(cs_new) | {"tau": tau, "violation": viol}
                          | plant_tree(ps_new, ps_prev),
                          compare.flatten(r_cs) | {"tau": r_tau,
                                                   "violation": out["violation"]}
                          | plant_tree(r_ps, ps_ref0),
                          floors, edge(out["violation"], margin))
            parts.append(tally.finish())
        res = compare.numbers(compare.combine(parts), t0.finish())
        res["_info"].update(robots=n, steps=[p[0][0] for p in kept["steps"]])
        return res
