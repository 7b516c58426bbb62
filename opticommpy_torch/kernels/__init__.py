"""Hand-written Hopper kernels (``../csrc``) with their plain PyTorch versions.

- :mod:`bps` — blind phase search (replaces ``kernels/bps_pallas.py``).
- :mod:`mimo_eq` — the N x N adaptive equalizer recurrence, for one signal
  or a batch (replaces both kernels of ``kernels/mimo_pallas.py``).
- :mod:`rls` — the RLS / DD-RLS recurrence, batched with the quantized
  slicer or single with the argmin slicer (replaces both kernels of
  ``kernels/rls_pallas.py``).
- :mod:`gardner` — the Gardner clock-recovery loop, all modes in one launch
  (replaces ``kernels/gardner_pallas.py``).
- :mod:`ddpll` — the decision-directed PLL over packed columns (replaces
  ``kernels/ddpll_pallas.py``).
- :mod:`ldpc` — the LDPC check update over the slot axis (replaces
  ``kernels/ldpc_pallas.py``).
- :mod:`qc` — one fused step of the quasi-cyclic DVB-S2 decoder: the
  check-column update and the variable totals (replaces both kernels of
  ``kernels/qc_pallas.py``).
- :mod:`qc_mega` — the whole DVB-S2 decode in one launch, flooding or
  layered (replaces ``kernels/qc_mega.py``).
- :mod:`lift` — one flooding iteration of the 802.11n / AR4JA
  lifted-circulant decoder (replaces ``kernels/lift_pallas.py``).
- :mod:`dfe` — the DFE / FFE LMS recurrence over a batch of signals, with
  the real instance for PAM (replaces ``kernels/dfe_pallas.py``).
- :mod:`volterra` — the 2nd/3rd-order Volterra LMS recurrence, one warp
  per signal (replaces ``kernels/volterra_pallas.py``).
- :mod:`unwrap` — phase unwrapping by whole turns with the derotation
  fused in (no Pallas counterpart: the JAX package uses ``jnp.unwrap``).

A wrapper runs the plain version for a CPU tensor, and the kernel, or
raises, for a CUDA tensor. The kernels are built with nvcc on first use
(:mod:`._build`).
"""

from opticommpy_torch.kernels.bps import bps_kernel  # noqa: F401,E402
from opticommpy_torch.kernels.ddpll import ddpll_kernel  # noqa: F401,E402
from opticommpy_torch.kernels.gardner import gardner_kernel  # noqa: F401,E402
from opticommpy_torch.kernels.mimo_eq import mimo_eq_kernel, mimo_lms_kernel  # noqa: F401,E402
from opticommpy_torch.kernels.rls import mimo_rls_kernel  # noqa: F401,E402
