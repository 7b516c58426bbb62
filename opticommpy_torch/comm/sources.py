"""Bit and symbol sources (port of ``opticommpy_tpu/comm/sources.py``).

The constellation and its probability mass function are the same host
NumPy code; symbol indices and random bits are drawn from an explicit
``torch.Generator``. The PRBS register recurrence is computed on the host
in a few NumPy steps (see :func:`prbs_generator`) and equals the JAX
package's scan bit for bit. :func:`cazac_sequence` takes its phase in
float64 (OptiCommPy's precision), where the JAX package rounds it to
float32.
"""

import numpy as np
import torch

from opticommpy_torch.comm.modulation import (
    apsk_const,
    pam_const,
    psk_const,
    qam_const,
)
from opticommpy_torch.utils.rng import default_device, ensure_generator

__all__ = ["bit_source", "prbs_generator", "symbol_source", "cazac_sequence", "constellation",
           "draw_symbol_indices", "symbol_pmf"]

# LFSR taps per PRBS order (x^a + x^b + 1), as in the reference sources.py:104-113
_PRBS_TAPS = {
    7: (6, 5),
    9: (8, 4),
    11: (10, 8),
    13: (12, 11),
    15: (14, 13),
    23: (22, 17),
    31: (30, 27),
}


def _prbs_bits(order, length, seed):
    """The register's output bits as a NumPy uint8 array.

    Output bit n is bit ``order - 1`` of the register after n shifts, so the
    output sequence u starts with the seed's bits from the top down and then
    obeys u[m] = u[m - 1 - a] ^ u[m - 1 - b]. Squaring the recurrence's
    polynomial over GF(2) gives u[m] = u[m - 2^k (1 + a)] ^ u[m - 2^k (1 + b)]
    for every k, so the sequence is filled in chunks that double in size.
    """
    tap_a, tap_b = _PRBS_TAPS[order]
    lag_a, lag_b = 1 + tap_a, 1 + tap_b
    u = np.zeros(max(length, order), np.uint8)
    u[:order] = (seed >> np.arange(order - 1, -1, -1)) & 1
    n = order
    while n < length:
        k = 1
        while 2 * k * lag_a <= n:
            k *= 2
        end = min(length, n + k * lag_b)
        m = np.arange(n, end)
        u[n:end] = u[m - k * lag_a] ^ u[m - k * lag_b]
        n = end
    return u[:length]


def prbs_generator(order=23, length=None, seed=1, device=None):
    """Pseudo-random binary sequence from an LFSR of the given order.

    Supported orders: 7, 9, 11, 13, 15, 23, 31 (sources.py:75). Returns int32
    bits on ``device`` (the CUDA device when none is named), equal to the
    JAX package's ``lax.scan`` register bit for bit.
    """
    if seed is None:
        seed = 1
    if seed <= 0:
        raise ValueError("Seed must be a positive integer.")
    if order not in _PRBS_TAPS:
        raise ValueError(
            f"PRBS order {order} is not supported. "
            f"Supported orders: {sorted(_PRBS_TAPS)}."
        )
    period = 2**order - 1
    if length is None or length > period:
        length = period
    bits = _prbs_bits(order, int(length), int(seed) & period)
    return torch.as_tensor(bits.astype(np.int32), device=default_device(device))


def bit_source(generator_or_seed, n_bits=1000, mode="random", order=23, device=None):
    """Random or PRBS bit sequence of length ``n_bits`` (sources.py:23), int32.

    ``'random'`` draws from a ``torch.Generator`` (its device is the bits'),
    or from a new generator seeded with an integer on ``device`` (the CUDA
    device when none is named). ``'prbs'`` is deterministic: an integer seed
    > 0 sets the register, anything else starts it at 1 (an all-zero
    register is a fixed point), as in the JAX package.
    """
    if mode == "random":
        gen = ensure_generator(generator_or_seed, device)
        return torch.randint(0, 2, (n_bits,), generator=gen, device=gen.device,
                             dtype=torch.int32)
    elif mode == "prbs":
        seed = (generator_or_seed if isinstance(generator_or_seed, int)
                and generator_or_seed > 0 else 1)
        prbs = prbs_generator(order, min(n_bits, 2**order - 1), seed, device)
        if prbs.shape[0] < n_bits:
            prbs = prbs.repeat(n_bits // prbs.shape[0] + 1)
        return prbs[:n_bits]
    raise ValueError("mode must be 'random' or 'prbs'")


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


def symbol_source(generator_or_seed, n_symbols=1000, M=4, const_type="qam",
                  dist="uniform", shaping_factor=0.0, px=None, device=None):
    """Random symbols drawn from a (possibly shaped) constellation
    (sources.py:137), normalized to unit average energy under ``px``.

    ``generator_or_seed`` is a ``torch.Generator`` (its device is the
    symbols') or an integer seed for a new generator on ``device`` (the CUDA
    device when none is named). complex64, or float32 for PAM, as the JAX
    package returns them.
    """
    gen = ensure_generator(generator_or_seed, device)
    const = constellation(M, const_type)
    if px is None:
        px = symbol_pmf(M, const_type, dist, shaping_factor)
    px = np.asarray(px).reshape(-1)
    const = const / np.sqrt(np.sum(px * np.abs(const) ** 2))
    const = const.astype(np.complex64 if np.iscomplexobj(const) else np.float32)
    idx = draw_symbol_indices(gen, px, (n_symbols,))
    return torch.as_tensor(const, device=gen.device)[idx]


def cazac_sequence(N, M=1, device=None):
    """Zadoff-Chu CAZAC sequence of length N with root M (sources.py:215),
    ``exp(-j*pi*M*n*(n+1)/N)``, complex64 on ``device`` (the CUDA device when
    none is named).

    The integer ``M*n*(n+1)`` is reduced modulo 2N and the phase taken in
    float64, so every element is within a complex64 rounding of the exact
    value at any N.
    """
    if np.gcd(M, N) != 1:
        raise ValueError("The root (M) must be coprime with the sequence length (N).")
    n = np.arange(N, dtype=np.int64)
    k = (n * (n + 1)) % (2 * N) * (M % (2 * N)) % (2 * N)
    seq = np.exp(-1j * np.pi * k / N).astype(np.complex64)
    return torch.as_tensor(seq, device=default_device(device))
