"""Checkpoint/resume helpers for simulation and DSP state (port of
``opticommpy_tpu/utils/checkpoint.py``).

Any nest of dicts, lists and tuples of tensors (fields, tap tensors,
configs rendered to dicts, scalars) round-trips through one ``.npz`` file
in the JAX package's layout: the leaves in flattening order (dict keys
sorted, lists and tuples in order, ``None`` holding no leaf) as
``leaf_0``, ``leaf_1``, ... and the structure as JSON text in
``__treedef__``. A file of either package loads in the other.
"""

import json
import os

import numpy as np
import torch

from opticommpy_torch.comm.modulation import _host
from opticommpy_torch.utils.rng import default_device

__all__ = ["save_state", "load_state"]


def _flatten(tree):
    """(leaves, structure text in the JAX package's ``PyTreeDef`` form)."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        leaves, parts = [], []
        for key in sorted(tree):
            sub, text = _flatten(tree[key])
            leaves += sub
            parts.append(f"{key!r}: {text}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for item in tree:
            sub, text = _flatten(item)
            leaves += sub
            parts.append(text)
        if isinstance(tree, list):
            return leaves, "[" + ", ".join(parts) + "]"
        return leaves, "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    return [tree], "*"


def _unflatten(like, leaves):
    """``like``'s structure filled with ``leaves`` in flattening order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(item, leaves) for item in like)
    return next(leaves)


def save_state(path, pytree):
    """Serialize a nest of tensors/arrays/scalars to ``path`` (.npz)."""
    leaves, text = _flatten(pytree)
    arrays = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, __treedef__=np.frombuffer(
        json.dumps(f"PyTreeDef({text})").encode(), dtype=np.uint8
    ), **arrays)
    return path


def load_state(path, like=None, device=None):
    """Load a nest saved by :func:`save_state` (of either package).

    The leaves come back as tensors on ``device`` (the CUDA device when none
    is named, see :func:`~opticommpy_torch.utils.rng.default_device`). If
    ``like`` (a nest with the same structure) is given, they are put into
    that structure; otherwise a flat list is returned.
    """
    dev = default_device(device)
    with np.load(path, allow_pickle=False) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=dev) for i in range(n)]
    if like is not None:
        return _unflatten(like, iter(leaves))
    return leaves
