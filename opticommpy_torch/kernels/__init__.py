"""Hand-written Hopper kernels (``../csrc``) with their plain PyTorch versions.

- :mod:`bps` — blind phase search (replaces ``kernels/bps_pallas.py``).
- :mod:`mimo_eq` — the N x N adaptive equalizer recurrence (replaces the
  single-signal kernel of ``kernels/mimo_pallas.py``).

A wrapper runs the plain version for a CPU tensor, and the kernel, or
raises, for a CUDA tensor. The kernels are built with nvcc on first use
(:mod:`._build`).
"""
