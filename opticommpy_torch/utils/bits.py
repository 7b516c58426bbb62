"""Bit-array <-> decimal conversions, MSB first (port of
``opticommpy_tpu/utils/bits.py``; reference ``optic/utils.py:200-279``).

Both directions are one broadcast integer operation on int32 tensors. A
tensor keeps its device; any other input goes to the CUDA device
(:func:`opticommpy_torch.utils.rng.as_device_tensor`).
"""

import numpy as np
import torch

from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["dec2bitarray", "bitarray2dec"]


def dec2bitarray(x, bit_width):
    """Non-negative integer(s) to MSB-first bit arrays.

    Returns (bit_width,) int32 for a scalar input, (N, bit_width) otherwise.
    """
    scalar = np.isscalar(x) or getattr(x, "ndim", 0) == 0
    xa = torch.atleast_1d(as_device_tensor(x).to(torch.int32))
    shifts = torch.arange(bit_width - 1, -1, -1, dtype=torch.int32, device=xa.device)
    bits = (xa[:, None] >> shifts[None, :]) & 1
    return bits[0] if scalar else bits


def bitarray2dec(bits):
    """MSB-first bit array(s) to decimal integers (int32).

    A 1-D input gives a scalar; a 2-D input of shape (bit_width, N) converts
    each column, as the reference's ``bitarray2dec(bits.reshape(-1, b).T)``.
    """
    bits = as_device_tensor(bits).to(torch.int32)
    w = bits.shape[0]
    weights = 1 << torch.arange(w - 1, -1, -1, dtype=torch.int32, device=bits.device)
    if bits.ndim == 1:
        return torch.sum(bits * weights, dtype=torch.int32)
    return torch.sum(bits * weights[:, None], dim=0, dtype=torch.int32)
