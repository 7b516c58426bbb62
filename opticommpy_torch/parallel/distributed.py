"""Process-group initialization on ``torch.distributed``.

Port of ``opticommpy_tpu/parallel/distributed.py``. Where the JAX package
starts the JAX distributed runtime, the port opens one process group: NCCL
with a CUDA device, gloo only when the caller asks for it (``backend="gloo"``
or ``device="cpu"``). The group's address comes from the arguments, from
the usual ``torchrun`` environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), or, in a single process started without either,
from a store of its own: a group of one. Each process drives one device,
``LOCAL_RANK`` (or its rank) modulo the host's CUDA device count.
"""

import os

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "is_multihost", "local_device_count"]


def _backend(backend=None, device=None):
    """The backend the caller asked for, else NCCL on a card; without a card
    and without an explicit CPU request this raises."""
    if backend is not None:
        if backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs CUDA, which is not available: pass "
                               "backend='gloo' or device='cpu' to run on the CPU")
        return backend
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no backend named and CUDA is not available: pass "
                           "backend='gloo' or device='cpu' to run on the CPU")
    return "nccl"


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None, device=None):
    """Open the default process group and return ``(rank, world_size)``.

    ``coordinator_address`` ("host:port", rank 0's store) with
    ``num_processes`` and ``process_id`` name the group explicitly; without
    them the ``torchrun`` environment variables do, and a process started
    without those opens a group of one. A second call returns the open
    group's ``(rank, world_size)`` and changes nothing, as the JAX package's
    does. ``backend``: 'nccl' | 'gloo'; by default NCCL, which needs a card
    (see :func:`_backend`).
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = _backend(backend, device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                  rank=int(process_id))
    elif "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        kw = dict(init_method="env://")
    else:
        kw = dict(store=dist.HashStore(), world_size=1, rank=0)
    if backend == "nccl":
        rank = int(process_id) if process_id is not None else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)
    return dist.get_rank(), dist.get_world_size()


def is_multihost():
    """Whether the open process group spans more than one process."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_device_count(device=None):
    """The devices this host gives the port: its CUDA devices, or 1 (the
    process's own CPU) when the caller asks for the CPU. Without a card and
    without ``device='cpu'`` this raises, as every entry point does."""
    if device is not None and torch.device(device).type == "cpu":
        return 1
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to count the CPU")
    return torch.cuda.device_count()
