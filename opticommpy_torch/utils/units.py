"""Scalar unit conversions and numerically stable helpers (port of
``opticommpy_tpu/utils/units.py``).

Each function takes a Python number or a tensor and returns the same kind.
"""

import math

import torch
from scipy.special import erfinv

from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["lin2db", "db2lin", "dbm2w", "w2dbm", "ber2qfactor", "llr2bit_prob"]


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


def ber2qfactor(ber):
    """Bit error rate to Q factor in dB: ``10*log10(sqrt(2)*erfcinv(2*ber))``
    (reference ``optic/utils.py:312``), with erfcinv(y) = erfinv(1 - y)."""
    if isinstance(ber, torch.Tensor):
        q = math.sqrt(2.0) * torch.special.erfinv(1.0 - 2.0 * ber)
    else:
        q = math.sqrt(2.0) * float(erfinv(1.0 - 2.0 * ber))
    return 10.0 * _log10(q)


def llr2bit_prob(llr):
    """LLRs to bit probabilities P(bit=1) by a stable sigmoid (reference
    ``optic/utils.py:329``): ``llr = log(P(b=0)/P(b=1))``, so
    ``P(b=1) = sigmoid(-llr)``."""
    x = -as_device_tensor(llr)
    z = torch.exp(-torch.abs(x))
    return torch.where(x >= 0, 1.0 / (1.0 + z), z / (1.0 + z))
