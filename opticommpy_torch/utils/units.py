"""Scalar unit conversions (port of ``opticommpy_tpu/utils/units.py``).

Each function takes a Python number or a tensor and returns the same kind.
"""

import math

import torch

__all__ = ["lin2db", "db2lin", "dbm2w", "w2dbm"]


def _log10(x):
    return torch.log10(x) if isinstance(x, torch.Tensor) else math.log10(x)


def lin2db(x):
    """Convert a linear value to dB: ``10*log10(x)``."""
    return 10.0 * _log10(x)


def db2lin(x):
    """Convert dB to a linear value: ``10**(x/10)``."""
    return 10.0 ** (x / 10.0)


def dbm2w(x):
    """Convert power in dBm to Watts."""
    return 1e-3 * 10.0 ** (x / 10.0)


def w2dbm(x):
    """Convert power in Watts to dBm."""
    return 10.0 * _log10(x / 1e-3)
