"""Hand-written Hopper kernels (``../csrc``) with their plain PyTorch versions.

- :mod:`bps` — blind phase search (replaces ``kernels/bps_pallas.py``).
- :mod:`mimo_eq` — the N x N adaptive equalizer recurrence, for one signal
  or a batch (replaces both kernels of ``kernels/mimo_pallas.py``).
- :mod:`rls` — the RLS / DD-RLS recurrence, batched with the quantized
  slicer or single with the argmin slicer (replaces both kernels of
  ``kernels/rls_pallas.py``).

A wrapper runs the plain version for a CPU tensor, and the kernel, or
raises, for a CUDA tensor. The kernels are built with nvcc on first use
(:mod:`._build`).
"""
