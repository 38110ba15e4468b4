"""The comparison that decides ``correct``: the program's answers against the
plain reference's, robot by robot, on the robots and steps sampled from the
seed.

Every output the reference computes is compared. A discrete one (a counter,
a flag) has to match exactly. A continuous one is judged per robot by its
largest difference over the reference's largest magnitude, the latter never
below the field's floor (the configuration's file states the floors: they
keep a value that is nought on one side from dividing by rounding). A robot
whose step the reference took within a stated margin of a discrete decision
(a foot's contact, a QP's divergence test) is counted apart: there float32
may rightly take the other branch, so it enters neither number, and only has
to be finite.
"""
from __future__ import annotations

import torch


def flatten(tree, prefix: str = "") -> dict:
    """Leaves of nested NamedTuples and dicts as {dotted name: tensor}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def convert(obj, ref_type, nested: dict, fn):
    """The program's NamedTuple ``obj`` as the reference's ``ref_type``,
    field by field by name (``nested`` maps a field name to the reference's
    type of a nested tuple), each tensor through ``fn``."""
    vals = {}
    for f in ref_type._fields:
        v = getattr(obj, f)
        vals[f] = (convert(v, nested[f], nested, fn) if f in nested
                   else fn(v))
    return ref_type(**vals)


def is_discrete(t) -> bool:
    return t.dtype == torch.bool or not torch.is_floating_point(t)


class Tally:
    """Per robot of the sample: the worst relative gap of each compared
    number (a leaf counts towards the number ``groups`` maps its name to,
    else towards ``default``), discrete mismatches, non-finite answers, and
    the robots on a decision's edge."""

    def __init__(self, robots: int, device, groups: dict, default: str):
        self.robots, self.device = robots, device
        self.groups, self.default = groups, default
        self.gaps = {}
        self.bad = torch.zeros(robots, dtype=torch.bool, device=device)
        self.edge = torch.zeros(robots, dtype=torch.bool, device=device)
        self.nonfinite = torch.zeros(robots, dtype=torch.bool, device=device)
        self.fields = {}

    def add(self, prog: dict, ref: dict, floors: dict, edge=None):
        """Compare leaf by leaf; ``edge`` (R,) marks robots on an edge."""
        if edge is not None:
            self.edge |= edge
        for name, r in ref.items():
            p = prog[name]
            n = r.shape[0]
            if is_discrete(r):
                self.bad |= (p.to(r.dtype) != r).reshape(n, -1).any(dim=1)
                continue
            key = name.rsplit(".", 1)[-1]
            if key not in floors:
                raise KeyError(f"no floor for compared field {name!r}")
            p64, r64 = p.double().reshape(n, -1), r.double().reshape(n, -1)
            fin_p = torch.isfinite(p64).all(dim=1)
            fin_r = torch.isfinite(r64).all(dim=1)
            self.nonfinite |= fin_p != fin_r
            scale = r64.abs().amax(dim=1).clamp_min(floors[key])
            g = torch.where(fin_p & fin_r,
                            (p64 - r64).abs().amax(dim=1) / scale,
                            torch.zeros_like(scale))
            g = torch.nan_to_num(g, nan=float("inf"))
            number = self.groups.get(key, self.default)
            self.gaps[number] = torch.maximum(
                self.gaps.get(number, torch.zeros_like(g)), g)
            self.fields[name] = torch.maximum(
                self.fields.get(name, torch.zeros_like(g)), g)

    def finish(self) -> dict:
        ok = ~self.edge

        def worst(g):
            return float(g[ok].max()) if bool(ok.any()) else 0.0

        return {"gaps": {k: worst(g) for k, g in self.gaps.items()},
                "mismatches": int(((self.bad & ok) | self.nonfinite).sum()),
                "edge_robots": int(self.edge.sum()),
                "edge_mismatches": int((self.bad & self.edge).sum()),
                "fields": {k: worst(g) for k, g in self.fields.items()}}


def combine(parts) -> dict:
    """The tallies of several sampled steps as one: each number's worst
    gap, the mismatches and the robots on an edge summed."""
    def worst(key):
        out = {}
        for p in parts:
            for k, v in p[key].items():
                out[k] = max(v, out.get(k, 0.0))
        return out
    fields = worst("fields")
    return {"gaps": worst("gaps"),
            "mismatches": sum(p["mismatches"] for p in parts),
            "edge_robots": sum(p["edge_robots"] for p in parts),
            "edge_mismatches": sum(p["edge_mismatches"] for p in parts),
            "fields": fields, "worst_fields": top(fields)}


def top(fields: dict, k: int = 4) -> dict:
    """The ``k`` fields with the largest gaps."""
    return dict(sorted(fields.items(), key=lambda kv: -kv[1])[:k])


def numbers(window: dict, start: dict) -> dict:
    """The compared numbers of a run, and what it saw besides (``_info``)."""
    out = dict(window["gaps"])
    out["start_gap"] = max(start["gaps"].values(), default=0.0)
    out["mismatches"] = window["mismatches"] + start["mismatches"]
    out["_info"] = {
        "edge_robots": window["edge_robots"] + start["edge_robots"],
        "edge_mismatches": window["edge_mismatches"] + start["edge_mismatches"],
        "worst_fields": window["worst_fields"],
        "start_worst_fields": top(start["fields"]),
        "all_fields": window["fields"], "start_all_fields": start["fields"]}
    return out
