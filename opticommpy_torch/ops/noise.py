"""Noise generation from explicit ``torch.Generator``s.

Port of ``opticommpy_tpu/ops/noise.py``: where the JAX functions take a
``jax.random`` key first, these take a generator, and the draws land on
the generator's device. The phase-noise random walk is a cumulative sum,
taken with :func:`opticommpy_torch.utils.scan.cumsum` so that one seed
gives the same walk on every run on a GPU.
"""

import math

import torch

from opticommpy_torch.utils.scan import cumsum

__all__ = ["gaussian_complex_noise", "gaussian_noise", "phase_noise"]


def gaussian_complex_noise(generator, shape, var=1.0):
    """Circular complex Gaussian noise (complex64) with total variance ``var``."""
    std = math.sqrt(var / 2)
    dev = generator.device
    re = torch.randn(shape, generator=generator, device=dev)
    im = torch.randn(shape, generator=generator, device=dev)
    return torch.complex(std * re, std * im)


def gaussian_noise(generator, shape, var=1.0):
    """Real Gaussian noise (float32) with variance ``var``."""
    return math.sqrt(var) * torch.randn(shape, generator=generator,
                                        device=generator.device)


def phase_noise(generator, lw, n_samples, ts):
    """Random-walk (Wiener) laser phase noise, float32, phi[0] = 0.

    Increment variance is ``2*pi*lw*ts`` (reference core.py:791).
    """
    std = math.sqrt(2 * math.pi * lw * ts)
    incr = std * torch.randn((n_samples - 1,), generator=generator,
                             device=generator.device)
    return torch.cat([torch.zeros(1, device=incr.device), cumsum(incr, 0)])
