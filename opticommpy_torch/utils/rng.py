"""Random-generator helpers (port of ``opticommpy_tpu/utils/rng.py``).

Where the JAX package threads a ``jax.random`` key, the port takes a
``torch.Generator``; the generator's device is the device the draws land
on. The two frameworks give different numbers from the same seed.
"""

import numpy as np
import torch

__all__ = ["ensure_generator", "default_device", "as_device_tensor"]


def default_device(device=None):
    """``device``, or the CUDA device when none is named.

    The port's entry points run on the card unless the caller asks for the
    CPU; without a card and without a named device this raises instead of
    falling back to the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no device named and CUDA is not available: pass device='cpu' "
            "(or a CPU generator) to run on the CPU")
    return torch.device("cuda")


def as_device_tensor(x, device=None):
    """``x`` as a tensor on ``device`` when one is named; otherwise a tensor
    stays on its device and anything else (a NumPy array, a list) goes to
    :func:`default_device`, so only a CPU tensor asks for the CPU."""
    if device is not None:
        return torch.as_tensor(x, device=device)
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=default_device())


def ensure_generator(generator_or_seed, device=None):
    """A ``torch.Generator`` from a generator or an integer seed.

    An integer seed makes a new generator on ``device`` (the CUDA device
    when none is named, see :func:`default_device`); ``None`` means seed 0,
    the JAX package's ``PRNGKey(0)`` default.
    """
    if generator_or_seed is None:
        generator_or_seed = 0
    if isinstance(generator_or_seed, torch.Generator):
        return generator_or_seed
    gen = torch.Generator(device=default_device(device))
    gen.manual_seed(int(generator_or_seed))
    return gen
