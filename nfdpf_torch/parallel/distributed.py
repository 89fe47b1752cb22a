"""Multi-process bring-up.

Counterpart of ``nfdpf_tpu/parallel/distributed.py``: call ``initialize()``
once per process before building a mesh (``parallel/mesh.py``).  The
processes come from ``torchrun``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``:

    torchrun --nproc-per-node D·P -m nfdpf_torch.main --mesh-data D --mesh-particle P
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def initialize(backend: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, init_method: Optional[str] = None) -> bool:
    """Join the process group described by the arguments, else by torchrun's
    environment (``RANK``, ``WORLD_SIZE``; the rendezvous at
    ``MASTER_ADDR``:``MASTER_PORT``, or ``init_method``).  A no-op returning
    False when neither asks for one (a single process), as the JAX package's
    is without its variables, and when this process already belongs to a
    group (whoever started it ends it); True once it has joined one.

    ``backend``: ``nccl`` (one card per rank) or ``gloo`` (the CPU, or
    several ranks sharing one card: gloo takes CUDA tensors for the
    collectives the port uses, through the host; NCCL refuses two ranks on
    one card).  By default ``nccl`` when every rank of this host
    (``LOCAL_WORLD_SIZE``, else the world) has a card of its own, else
    ``gloo``."""
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if (rank is None and world_size is None) or dist.is_initialized():
        return False
    if rank is None or world_size is None:
        raise ValueError("initialize needs both a rank and a world size "
                         "(arguments, or RANK and WORLD_SIZE)")
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        backend = "nccl" if 0 < local <= torch.cuda.device_count() else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return True


def is_primary() -> bool:
    """True on the process that writes checkpoints, artifacts and logs: rank
    0 of an initialised group, or the only process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def say(*args) -> None:
    """``print`` on the primary rank only."""
    if is_primary():
        print(*args)


def local_device() -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK`` modulo the cards present, so
    that gloo ranks may share one card."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
