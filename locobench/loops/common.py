"""What the loops share: the tick as the program runs it (or the control in
its place), the reference's constants from the configuration, and moving
the program's state into the reference's types."""
from __future__ import annotations

import contextlib
import os

import torch

from locobench import compare
from locobench.reference import controller as ref
from locobench.reference import plant as ref_plant

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
NESTED = {"est": ref.EstimatorState, "loco": ref.LocomotionState,
          "qp_state": ref.QPState}
CONTROL_CHUNK = 16384


def span(name: str, traced: bool):
    """A named range in the trace around a call into the program, opened
    only in the traced segment."""
    return (torch.profiler.record_function(name) if traced
            else contextlib.nullcontext())


def picker(idx):
    """Rows ``idx`` of every tensor of a nested state, as new tensors."""
    def pick(tree):
        if isinstance(tree, torch.Tensor):
            return tree.index_select(0, idx) if tree.dim() else tree
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*[pick(v) for v in tree])
        if isinstance(tree, tuple):
            return tuple(pick(v) for v in tree)
        return tree
    return pick


def as_ref(state, dtype):
    """A controller state of the program (or of the control) as the
    reference's ``ControlState``, floats in ``dtype``."""
    def cast(t):
        return t.to(dtype) if torch.is_floating_point(t) else t
    return compare.convert(state, ref.ControlState, NESTED, cast)


def ref_tree(state) -> dict:
    """The reference's leaves of a controller state of the program."""
    return compare.flatten(compare.convert(state, ref.ControlState, NESTED,
                                           lambda t: t))


def compare_spec(config: dict):
    """(floors, leaf -> number, the default number) from the file."""
    c = config["compare"]
    groups = {leaf: number for number, leaves in c["numbers"].items()
              for leaf in leaves}
    return c["floors"], groups, c["default_number"]


def plant_model(config: dict, dtype, device):
    p = config["plant"]
    return ref_plant.model_from_urdf(os.path.join(CONFIG_DIR, p["urdf"]),
                                     p["armature"], dtype, device)


def ref_params(config: dict, dtype, device):
    """(Params, Control) of the reference, as the configuration states
    them; with a plant whose ``srb_match`` is set, the controller's mass
    and inertia are the articulated model's composite at the stand pose."""
    params = ref.params_from_config(config["robot"], dtype, device)
    plant = config.get("plant")
    if plant and plant["srb_match"]:
        q = torch.tensor(plant["stand_q"], dtype=dtype, device=device).repeat(4)
        m, inertia = ref_plant.srb_equivalent(plant_model(config, dtype, device),
                                              q[None])
        params = params._replace(body_mass=m[0], body_inertia=inertia[0])
    return params, ref.control_from_config(config["control"], config["qp"])


class ProgramTick:
    """``runner.min_step`` of the port, configured from the file."""

    def __init__(self, config: dict, robots: int, device):
        from rl_mpc_locomotion_tpu_torch.control import runner
        from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
        from rl_mpc_locomotion_tpu_torch.models import robots as robots_mod
        from rl_mpc_locomotion_tpu_torch.ops.qp import QPConfig
        c, q = config["control"], config["qp"]
        self.runner, self.robots, self.device = runner, robots, device
        self.params = getattr(robots_mod, config["robot"]["name"] + "_params")(device)
        plant = config.get("plant")
        if plant:
            from rl_mpc_locomotion_tpu_torch.sim import articulated
            self.params = articulated.with_articulated(
                self.params, config["robot"]["name"], armature=plant["armature"],
                srb_match=plant["srb_match"])
        self.cfg = ControlConfig(
            dt=c["dt"], iterations_between_mpc=c["iterations_between_mpc"],
            horizon=c["horizon"], flat_ground=c["flat_ground"],
            alpha=c["alpha"], bonus_swing=c["bonus_swing"],
            qp_divergence_tol=c["qp_divergence_tol"],
            qp=QPConfig(**{k: q[k] for k in QPConfig._fields}))

    def init_state(self):
        return self.runner.init_state(self.params, self.cfg, batch=self.robots,
                                      device=self.device)

    def __call__(self, state, q, qd, body, cmd, solve: bool):
        state, tau, m = self.runner.min_step(self.params, self.cfg, state, q,
                                             qd, body, cmd, solve_gate=solve)
        return state, tau, m


def round_tf32(t):
    """A float32 tensor rounded to TF32 (10 explicit mantissa bits, to
    nearest, ties to even); anything else as it is."""
    if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
        i = t.contiguous().view(torch.int32)
        i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
        return i.view(torch.float32)
    if isinstance(t, (list, tuple)):
        return type(t)(round_tf32(x) for x in t)
    return t


class TF32(torch.overrides.TorchFunctionMode):
    """Every matrix product computed as a TF32 tensor core computes it:
    float32 operands rounded to TF32, products accumulated in float32.
    (PyTorch's ``allow_tf32`` flag leaves cuBLAS free to keep FFMA kernels,
    and it does at these small batched shapes, so the flag alone computes
    nothing in TF32.)"""

    PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                torch.Tensor.__rmatmul__, torch.bmm, torch.Tensor.bmm,
                torch.mm, torch.Tensor.mm, torch.einsum}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            args = round_tf32(args)
        return func(*args, **(kwargs or {}))


class ControlTick:
    """The control: the plain reference in the program's place, in TF32
    (the precision below the configuration's float32 with TF32 off), in
    chunks of robots so that its dense matrices fit."""

    def __init__(self, config: dict, robots: int, device):
        self.params, self.cfg = ref_params(config, torch.float32, device)
        self.robots, self.device = robots, device

    def init_state(self):
        return ref.init_state(self.params, self.cfg, self.robots,
                              torch.float32, self.device)

    def __call__(self, state, q, qd, body, cmd, solve: bool):
        outs = []
        for a in range(0, self.robots, CONTROL_CHUNK):
            pick = picker(torch.arange(a, min(a + CONTROL_CHUNK, self.robots),
                                       device=self.device))
            with TF32():
                outs.append(ref.tick(self.params, self.cfg, pick(state),
                                     pick(q), pick(qd), pick(body), pick(cmd),
                                     solve))
        cat = _cat([o[:2] for o in outs])
        out = {"qp_diverged": torch.cat([o[2]["diverged"] for o in outs]),
               "qp_primal_violation": torch.cat([o[2]["violation"] for o in outs])}
        return cat[0], cat[1], out


def _cat(parts):
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts) if first.dim() else first
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_cat([p[i] for p in parts]) for i in range(len(first))])
    return tuple(_cat([p[i] for p in parts]) for i in range(len(first)))


def make_tick(config: dict, robots: int, device, impl: str):
    if impl == "program":
        return ProgramTick(config, robots, device)
    if impl == "control_tf32":
        return ControlTick(config, robots, device)
    raise ValueError(f"unknown impl {impl!r}")
