"""Symbol sources (port of ``opticommpy_tpu/comm/sources.py``).

The constellation and its probability mass function are the same host
NumPy code; symbol indices are drawn from an explicit ``torch.Generator``.
"""

import numpy as np
import torch

from opticommpy_torch.comm.modulation import (
    apsk_const,
    pam_const,
    psk_const,
    qam_const,
)

__all__ = ["constellation", "draw_symbol_indices", "symbol_pmf"]


def constellation(M, const_type):
    """Raw (un-normalized) constellation points for a source."""
    if const_type == "qam":
        return qam_const(M).reshape(-1)
    elif const_type == "pam":
        return pam_const(M)
    elif const_type == "psk":
        return psk_const(M)
    elif const_type == "apsk":
        return apsk_const(M)
    raise ValueError(
        "Invalid constellation type. Supported: 'qam', 'pam', 'psk', 'apsk'."
    )


def symbol_pmf(M, const_type, dist="uniform", shaping_factor=0.0):
    """Symbol probability mass function: uniform or Maxwell-Boltzmann."""
    const = constellation(M, const_type)
    if dist == "uniform":
        return np.ones(M) / M
    elif dist == "maxwell-boltzmann":
        px = np.exp(-shaping_factor * np.abs(const) ** 2)
        return (px / np.sum(px)).reshape(-1)
    raise ValueError("dist must be 'uniform' or 'maxwell-boltzmann'")


def draw_symbol_indices(generator, px, shape):
    """Indices into a constellation drawn with probabilities ``px``."""
    p = torch.as_tensor(np.asarray(px, np.float64).reshape(-1),
                        device=generator.device)
    n = int(np.prod(shape))
    idx = torch.multinomial(p, n, replacement=True, generator=generator)
    return idx.reshape(shape)
