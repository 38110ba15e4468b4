"""Multi-process runtime: ``torch.distributed`` and the env mesh over it.

Counterpart of ``rl_mpc_locomotion_tpu/parallel/distributed.py``. One
process a card: ``initialize`` joins the processes into one group (from the
variables ``torchrun`` sets), ``global_env_mesh`` builds the 1-D env mesh
over all of them, and each process steps its own slice of the env batch
(``local_batch_slice``); the gradients and the statistics that feed back
into the update are averaged over the group (``mesh.psum_grads``,
``mesh.pmean``).

    torchrun --nproc-per-node 4 -m rl_mpc_locomotion_tpu_torch.cli train \\
        --multi-device --num-envs 16384
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import local_device, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "nccl") -> None:
    """Join the process group; a no-op for one process.

    The arguments default from ``MASTER_ADDR``:``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets them. NCCL (the
    default) puts this process on its card, ``LOCAL_RANK`` (or the rank
    modulo the cards of the host); "gloo" runs on the CPU."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return
    if backend == "nccl":
        torch.cuda.set_device(local_device(process_id))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_env_mesh(device_type: Optional[str] = None):
    """The 1-D env mesh over every process (one card each; "cpu" for
    gloo)."""
    return make_mesh(device_type=device_type)


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this process's slice of a global env batch."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    assert global_batch % n_proc == 0, (
        f"global batch {global_batch} must divide process count {n_proc}")
    per = global_batch // n_proc
    return rank * per, per


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
