"""Device meshes over the ranks of a ``torch.distributed`` process group.

Port of ``opticommpy_tpu/parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with two named dims, as the
JAX package's ``jax.sharding.Mesh`` has:

- ``"data"``: batch parallelism over WDM channels, launch powers or
  Monte-Carlo seeds;
- ``"time"``: sequence parallelism over the signal's time axis, with halos
  exchanged between neighbouring ranks.

Each rank drives one device. :class:`P` and :class:`NamedSharding` keep the
JAX package's spelling of a layout (for each tensor axis, the mesh dim that
splits it); the sharded functions read them and nothing else does.
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from opticommpy_torch.parallel.distributed import init_distributed

__all__ = ["make_mesh", "data_sharding", "P", "NamedSharding"]


class P(tuple):
    """A partition spec: ``P('data', None)`` splits a tensor's axis 0 over
    the mesh dim ``'data'`` and keeps axis 1 whole on every rank."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)


@dataclass(frozen=True)
class NamedSharding:
    """A layout: the mesh and, per tensor axis, the dim that splits it."""

    mesh: DeviceMesh
    spec: P


def _mesh(shape, names, ranks=None, device_type=None):
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over ``ranks`` (the
    group's first ranks by default), opening a group of one first in a
    single process with no group."""
    _, world = init_distributed(device=device_type)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n_used = 1
    for s in shape:
        n_used *= s
    ranks = list(range(world) if ranks is None else ranks)
    if len(ranks) < n_used:
        raise ValueError(f"a {tuple(shape)} mesh needs {n_used} ranks, have {len(ranks)}")
    mesh = torch.tensor(ranks[:n_used], dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(names))


def make_mesh(n_data=None, n_time=1, devices=None, device_type=None):
    """Create a (data, time) mesh over the process group's ranks.

    Parameters
    ----------
    n_data : int, optional
        Size of the batch-parallel dim. Defaults to ``len(devices) // n_time``.
    n_time : int
        Size of the time-parallel (sequence) dim.
    devices : ranks of the process group to use, in mesh order (all, by
        default).
    device_type : 'cuda' or 'cpu'; by default the group's (NCCL: 'cuda').
        Without a group, a single process opens one of its own
        (:func:`~opticommpy_torch.parallel.distributed.init_distributed`),
        which needs a card unless ``device_type='cpu'``.
    """
    _, world = init_distributed(device=device_type)
    devices = list(range(world) if devices is None else devices)
    if n_data is None:
        n_data = len(devices) // n_time
    return _mesh((n_data, n_time), ("data", "time"), devices, device_type)


def data_sharding(mesh, *spec):
    """NamedSharding shortcut: ``data_sharding(mesh, 'data', None)``."""
    return NamedSharding(mesh, P(*spec))
