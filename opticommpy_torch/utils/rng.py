"""Random-generator helpers (port of ``opticommpy_tpu/utils/rng.py``).

Where the JAX package threads a ``jax.random`` key, the port takes a
``torch.Generator``; the generator's device is the device the draws land
on. The two frameworks give different numbers from the same seed.
"""

import torch

__all__ = ["ensure_generator"]


def ensure_generator(generator_or_seed, device=None):
    """A ``torch.Generator`` from a generator or an integer seed.

    An integer seed makes a new generator on ``device`` (CPU by default);
    ``None`` means seed 0, the JAX package's ``PRNGKey(0)`` default.
    """
    if generator_or_seed is None:
        generator_or_seed = 0
    if isinstance(generator_or_seed, torch.Generator):
        return generator_or_seed
    gen = torch.Generator(device=torch.device(device or "cpu"))
    gen.manual_seed(int(generator_or_seed))
    return gen
