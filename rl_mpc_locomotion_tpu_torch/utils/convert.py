"""State and parameters carried between the JAX package and the port.

The ``*_from_numpy`` functions take the JAX package's ``RobotParams`` (with
its ``ArticulatedParams``, when attached) / ``ControlState`` / ``QPState`` / ``PhysState`` / ``EnvState`` / ``Terrain``
and domain-randomisation draws as nested tuples (or dicts keyed by field
name) of numpy arrays — what ``jax.tree.map(np.asarray, ...)`` gives — and
return the port's containers on ``device``. A container of one robot gets a
leading batch axis of length ``batch``; one that already carries a batch
axis keeps it. The ``*_to_numpy`` functions go back: nested tuples of numpy
arrays with the batch axis kept. ``EnvState``'s PRNG key has no counterpart
in the port (its env takes a ``torch.Generator``) and is dropped.

The policy: ``actor_critic_from_flax`` builds the port's ``ActorCritic``
from the flax parameters of the JAX package's (``Dense_i`` kernels
``(in, out)`` become ``nn.Linear`` weights ``(out, in)``);
``flax_params_from_npz`` reads such a tree from the committed
``weights/<run>/model_<i>.npz`` (the trained checkpoints under
``artifacts/``, carried across once, since orbax does not run here);
``actor_critic_to_numpy`` goes back, and ``adam_state_from_optax`` takes
optax's ``scale_by_adam`` state (count, mu, nu) into the port's
``AdamState``. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..control.types import (ControlState, EstimatorState, FSMStateData,
                             LocomotionState)
from ..models.actor_critic import ActorCritic
from ..models.robots import PARAM_RANKS, RobotParams
from ..ops.qp import QPState
from ..rl.ppo import AdamState
from ..sim.articulated import ART_RANKS, ArticulatedParams
from ..sim.env import EnvState
from ..sim.physics import PhysState
from ..sim.terrain import Terrain

# per-robot rank of every field (without a batch axis)
_QP_RANKS = dict(x=1, z=1, y=1, rho_mult=0)
_EST_RANKS = dict(contact_phase=1, foot_contact_history=2,
                  ground_normal_yaw=1, ground_normal_world=1, com_z=0)
_LOCO_RANKS = dict(iteration_counter=0, first_run=0, first_swing=1,
                   swing_time_remaining=1, p0=2, pf=2, f_ff=2,
                   swing_memory=3)
_PHYS_RANKS = dict(pos=1, quat=1, v=1, omega=1, q=1, qd=1, anchor=2,
                   contact=1, f_leg=2)
_ENV_RANKS = dict(commands=1, actions=1, torques=1, progress=0,
                  global_tick=0)
_FSM_RANKS = dict(state=0, op_mode=0, next_state=0, rc_flag=0,
                  rc_state_iter=0, rc_motion_start=0, rc_initial_jpos=2,
                  locomotion_unsafe=0)


def _fields(obj, names):
    """Field values of a tuple / NamedTuple / dict in ``names`` order."""
    if isinstance(obj, dict):
        return [obj[k] for k in names]
    return list(obj)[:len(names)]


def _tensor(value, device):
    arr = np.array(value)      # a writable copy; keeps rank 0
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return torch.from_numpy(arr).to(device)


def _batched(value, rank, batch, device):
    """A (B, ...) tensor from a per-robot or already batched array."""
    t = _tensor(value, device)
    if t.dim() == rank:
        return t.unsqueeze(0).expand((batch,) + tuple(t.shape)).clone()
    if t.dim() != rank + 1:
        raise ValueError(f"expected rank {rank} or {rank + 1}, got {t.dim()}")
    return t


def _container(cls, obj, ranks, batch, device, **extra):
    vals = _fields(obj, list(ranks))
    kw = {k: _batched(v, r, batch, device)
          for (k, r), v in zip(ranks.items(), vals)}
    return cls(**kw, **extra)


def articulated_params_from_numpy(art, device="cpu") -> ArticulatedParams:
    """ArticulatedParams from numpy fields; shapes are kept, so a stacked
    (B, ...) model stays per-env and a plain one stays shared."""
    return ArticulatedParams(*[_tensor(v, device)
                               for v in _fields(art, list(ART_RANKS))])


def articulated_params_to_numpy(art: ArticulatedParams):
    return tuple(_np(t) for t in art)


def robot_params_from_numpy(params, device="cpu") -> RobotParams:
    """RobotParams from numpy fields; shapes are kept, so stacked (B, ...)
    fields stay per-env and plain fields stay shared. An attached
    articulated model (``art``) is carried across, None stays None."""
    vals = _fields(params, list(PARAM_RANKS))
    art = (params.get("art") if isinstance(params, dict)
           else (list(params) + [None])[len(PARAM_RANKS)])
    return RobotParams(*[_tensor(v, device) for v in vals],
                       art=None if art is None
                       else articulated_params_from_numpy(art, device))


def qp_state_from_numpy(state, batch: int = 1, device="cpu") -> QPState:
    return _container(QPState, state, _QP_RANKS, batch, device)


def control_state_from_numpy(state, batch: int = 1, device="cpu"
                             ) -> ControlState:
    est, loco, fsm = _fields(state, ["est", "loco", "fsm"])
    loco_vals = _fields(loco, list(_LOCO_RANKS) + ["qp_state"])
    qp_state = qp_state_from_numpy(loco_vals[-1], batch, device)
    return ControlState(
        est=_container(EstimatorState, est, _EST_RANKS, batch, device),
        loco=_container(LocomotionState, loco_vals[:-1], _LOCO_RANKS, batch,
                        device, qp_state=qp_state),
        fsm=_container(FSMStateData, fsm, _FSM_RANKS, batch, device))


def _np(t):
    return t.detach().cpu().numpy()


def qp_state_to_numpy(state: QPState):
    return tuple(_np(t) for t in state)


def robot_params_to_numpy(params: RobotParams):
    art = params.art
    return tuple(_np(t) for t in params[:-1]) + (
        None if art is None else articulated_params_to_numpy(art),)


def control_state_to_numpy(state: ControlState):
    loco = tuple(_np(t) for t in state.loco[:-1]) + (
        qp_state_to_numpy(state.loco.qp_state),)
    return (tuple(_np(t) for t in state.est), loco,
            tuple(_np(t) for t in state.fsm))


def phys_state_from_numpy(state, batch: int = 1, device="cpu") -> PhysState:
    return _container(PhysState, state, _PHYS_RANKS, batch, device)


def phys_state_to_numpy(state: PhysState):
    return tuple(_np(t) for t in state)


def terrain_from_numpy(ter, device="cpu") -> Terrain:
    """The shared heightfield, as it is (no batch axis)."""
    return Terrain(*[_tensor(v, device) for v in _fields(ter, Terrain._fields)])


def _rand_rank(target: str) -> int:
    group, field = target.split(".", 1)
    if group == "robot":
        return PARAM_RANKS[field]
    return 1 if group in ("obs", "action") else 0


def rand_from_numpy(rand, batch: int = 1, device="cpu") -> dict:
    """Domain-randomisation values {target: array} of one env or a batch."""
    return {t: _batched(v, _rand_rank(t), batch, device)
            for t, v in rand.items()}


def rand_to_numpy(rand: dict) -> dict:
    return {t: _np(v) for t, v in rand.items()}


def env_state_from_numpy(state, batch: int = 1, device="cpu") -> EnvState:
    """EnvState from the JAX package's; its PRNG key is dropped."""
    phys, ctrl, *rest = _fields(state, list(EnvState._fields))
    kw = {k: _batched(v, r, batch, device)
          for (k, r), v in zip(_ENV_RANKS.items(), rest)}
    return EnvState(phys=phys_state_from_numpy(phys, batch, device),
                    ctrl=control_state_from_numpy(ctrl, batch, device),
                    rand=rand_from_numpy(rest[-1], batch, device), **kw)


def env_state_to_numpy(state: EnvState):
    return ((phys_state_to_numpy(state.phys),
             control_state_to_numpy(state.ctrl))
            + tuple(_np(getattr(state, k)) for k in _ENV_RANKS)
            + (rand_to_numpy(state.rand),))


# ---- the policy --------------------------------------------------------------

def _flax_to_torch(variables, device) -> dict:
    """{port parameter name: tensor} from a flax ActorCritic tree
    ({'params': ...}): the ``Dense_i`` of ``actor``/``critic`` to
    ``<net>.dense.<i>``, kernels transposed to (out, in)."""
    tree = variables["params"]
    out = {"log_std": _tensor(tree["log_std"], device)}
    for net in ("actor", "critic"):
        for name, dense in tree[net].items():
            i = int(name.split("_")[1])
            out[f"{net}.dense.{i}.weight"] = _tensor(
                np.asarray(dense["kernel"]).T, device)
            out[f"{net}.dense.{i}.bias"] = _tensor(dense["bias"], device)
    return out


def flax_params_from_npz(path: str) -> dict:
    """The flax parameter tree ({'params': ...}) from a ``.npz`` whose keys
    are the tree's paths joined by '/' (``params/actor/Dense_0/kernel``),
    as the committed ``weights/<run>/model_<i>.npz`` hold it."""
    tree = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return tree


def actor_critic_from_flax(params_np, device="cpu") -> ActorCritic:
    """The port's ActorCritic with the JAX package's parameters (its
    ``model.init`` / ``TrainState.params`` as numpy)."""
    actor = params_np["params"]["actor"]
    kernels = [np.asarray(actor[f"Dense_{i}"]["kernel"])
               for i in range(len(actor))]
    model = ActorCritic(num_actions=kernels[-1].shape[1],
                        hidden=tuple(k.shape[1] for k in kernels[:-1]),
                        num_obs=kernels[0].shape[0]).to(device)
    model.load_state_dict(_flax_to_torch(params_np, device))
    return model


def actor_critic_to_numpy(model: ActorCritic) -> dict:
    """The flax parameter tree ({'params': ...}) of the port's model."""
    tree = {"log_std": _np(model.log_std)}
    for net in ("actor", "critic"):
        tree[net] = {f"Dense_{i}": {"kernel": _np(layer.weight).T.copy(),
                                    "bias": _np(layer.bias)}
                     for i, layer in enumerate(getattr(model, net).dense)}
    return {"params": tree}


def adam_state_from_optax(opt_state_np, device="cpu") -> AdamState:
    """The port's AdamState from optax's chain state (clip, scale_by_adam,
    scale) or its ``ScaleByAdamState`` alone, as numpy."""
    states = [opt_state_np] if hasattr(opt_state_np, "mu") else [
        s for s in opt_state_np if hasattr(s, "mu")]
    (adam,) = states
    return AdamState(count=_tensor(np.asarray(adam.count, np.int32), device),
                     mu=_flax_to_torch(adam.mu, device),
                     nu=_flax_to_torch(adam.nu, device))
