"""opticommpy_torch: the PyTorch/CUDA port of opticommpy_tpu.

Same module tree and public names as the JAX package, on PyTorch tensors:
signals are ``(nSamples,)`` or ``(nSamples, nModes)`` with time on axis 0,
complex64 by default; configs are the same frozen dataclasses; random draws
take a ``torch.Generator`` where the JAX package takes a key. The hot
recurrences run on kernels written by hand for the H100 (``csrc/``).
The JAX package stays the reference.
"""

__version__ = "0.1.0"

from opticommpy_torch import comm, dsp, models, ops, parallel, utils  # noqa: F401
