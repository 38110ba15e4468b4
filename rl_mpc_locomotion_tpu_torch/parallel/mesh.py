"""Device mesh of the port: data parallelism over the env batch.

Counterpart of ``rl_mpc_locomotion_tpu/parallel/mesh.py``, in PyTorch's
idiom: one process a card, ``torch.distributed`` between them, and plain
local tensors. The mesh is a 1-D ``DeviceMesh`` over the world whose one
dimension is named ``ENV_AXIS``; each rank holds its own slice of the env
batch. What JAX's ``shard_map`` does through partition specs is done by
hand: ``shard_env_batch`` takes this rank's rows, ``replicate`` broadcasts
rank 0's values, ``psum_grads`` and ``pmean`` average over the ranks.
DTensor is not used: its coverage of an env step's ops is unverified, and
it would add host dispatch to a loop that is already host-bound.

The JAX mesh spans devices of one program; ``make_mesh`` takes the whole
world (one card a rank), so ``n_devices`` is None or the world size.
"""
from __future__ import annotations

import os
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

ENV_AXIS = "env"


def local_device(rank: int | None = None) -> torch.device:
    """This process's card: ``LOCAL_RANK`` (as ``torchrun`` sets it), else
    the rank modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def make_mesh(n_devices: int | None = None, device_type: str | None = None):
    """A 1-D ``DeviceMesh`` over every rank, its dimension named
    ``ENV_AXIS``: NCCL on the card (``device_type`` None or "cuda"), gloo for
    "cpu". Without a process group it starts one of a single rank (an
    in-memory store, no network), so one card runs the same code as many."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: make_mesh builds a mesh of cards "
                           "unless device_type='cpu' is passed")
    if device_type == "cuda":
        # before the group and the mesh, so that NCCL binds this card
        torch.cuda.set_device(local_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"n_devices {n_devices}: a mesh spans the world "
                         f"({world} ranks, one card each)")
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(ENV_AXIS,))


def axis_group(axis_name: str = ENV_AXIS):
    """The process group of a mesh axis (the world: the mesh is 1-D over
    it). Raises outside a process group, as a JAX collective raises on an
    axis name that no ``shard_map`` binds."""
    if axis_name != ENV_AXIS:
        raise ValueError(f"unknown mesh axis {axis_name!r}; the mesh has "
                         f"one, {ENV_AXIS!r}")
    if not dist.is_initialized():
        raise RuntimeError(f"axis {axis_name!r} is bound only under a "
                           "process group: build the mesh first "
                           "(make_mesh, distributed.global_env_mesh)")
    return dist.group.WORLD


def _shard(x, rank: int, n: int):
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not divide over "
                         f"{n} ranks")
    per = x.shape[0] // n
    return x[rank * per:(rank + 1) * per]


def shard_env_batch(mesh, tree):
    """This rank's slice of the leading (env) axis of every tensor leaf;
    0-d tensors and other leaves pass through."""
    n, rank = mesh.size(), mesh.get_local_rank(ENV_AXIS)
    return pytree.tree_map(lambda x: _shard(x, rank, n), tree)


def replicate(mesh, tree):
    """Rank 0's values of every tensor leaf on every rank (broadcast in
    place); a module's parameters and buffers count as leaves. Returns the
    tree."""
    group = mesh.get_group(ENV_AXIS)
    src = dist.get_global_rank(group, 0)

    def bcast(x):
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                bcast(t)
        elif isinstance(x, torch.Tensor):
            with torch.no_grad():
                dist.broadcast(x, src=src, group=group)
        return x

    pytree.tree_map(bcast, tree,
                    is_leaf=lambda x: isinstance(x, torch.nn.Module))
    return tree


def pmean(tensors: Sequence[torch.Tensor], axis_name: str = ENV_AXIS):
    """The mean over the ranks of each tensor, with one all-reduce of them
    flattened together (one dtype); on the device, no host read."""
    group = axis_group(axis_name)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def psum_grads(grads: dict, axis_name: str = ENV_AXIS) -> dict:
    """Cross-rank gradient reduction: the JAX one is a ``pmean``, so is
    this one, as one all-reduce of the flattened gradient list."""
    return dict(zip(grads, pmean(list(grads.values()), axis_name)))


def shard_map_env(mesh, fn: Callable, state_specs, out_specs):
    """``fn`` on this rank's shards. An argument whose spec is ``ENV_AXIS``
    is cut to this rank's rows (its leading axis must divide by the mesh
    size); one whose spec is None is passed whole (replicated). Outputs stay
    local, nothing is gathered: ``out_specs`` ``ENV_AXIS`` marks this rank's
    rows, None a value that ``fn`` made equal on every rank (``pmean``,
    ``psum_grads``)."""
    for spec in tuple(state_specs) + tuple(out_specs):
        if spec not in (None, ENV_AXIS):
            raise ValueError(f"spec {spec!r}: the mesh has one axis, "
                             f"{ENV_AXIS!r}")

    def local(*args):
        if len(args) != len(state_specs):
            raise TypeError(f"{len(args)} arguments for {len(state_specs)} "
                            "specs")
        out = fn(*[shard_env_batch(mesh, a) if s == ENV_AXIS else a
                   for a, s in zip(args, state_specs)])
        if isinstance(out, tuple) and len(out) != len(out_specs):
            raise TypeError(f"{len(out)} outputs for {len(out_specs)} specs")
        return out

    return local
