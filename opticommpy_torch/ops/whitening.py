"""Whitening-filter estimation: autocorrelation + Levinson-Durbin.

Port of ``opticommpy_tpu/ops/whitening.py`` (reference ``optic/dsp/
core.py:1142-1254``): the unbiased autocorrelation as one reduction per lag,
and the Levinson recursion, sequential in the filter order (small and
static), as a loop over the order on tensors with the JAX package's masked
updates. The whitening filter is what an MLSE receiver
(:func:`opticommpy_torch.comm.modulation.mlse`) puts in front of the trellis.
"""

import torch

from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["autocorr", "levinson", "estimate_whitening_filter"]


def autocorr(x, n_taps):
    """Unbiased autocorrelation estimates r[0..n_taps-1] (core.py:1193):
    ``r[k] = sum_{n=k}^{N-1} x[n] conj(x[n-k]) / (N - k)``.

    ``x`` is (N,); a tensor keeps its device, any other input goes to the
    CUDA device. Returns (n_taps,) in the input's dtype (float32 for a
    float64 NumPy input, as ``jnp.asarray`` makes it).
    """
    x = as_device_tensor(x)
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    elif x.dtype == torch.complex128:
        x = x.to(torch.complex64)
    n = x.shape[0]
    xc = x.conj() if x.is_complex() else x
    return torch.stack([torch.sum(x[k:] * xc[:n - k]) / (n - k) for k in range(n_taps)])


def levinson(r, n_taps):
    """Levinson-Durbin solve of the Toeplitz system (core.py:1142).

    Returns whitening-filter coefficients ``a`` (n_taps,) with a[0] = 1, on
    the device of ``r``: for order i = 1..n_taps-1, ``k = -(r[i] + sum_{1
    <= j < i} a[j] r[i-j]) / e``, ``a[j] += k conj(a[i-j])`` for 1 <= j < i,
    ``a[i] = k`` and ``e *= 1 - |k|^2``, starting from ``e = r[0]``.
    """
    r = as_device_tensor(r)
    idx = torch.arange(n_taps, device=r.device)
    a = torch.zeros(n_taps, dtype=r.dtype, device=r.device)
    a[0] = 1.0
    e = r[0]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    for i in range(1, n_taps):
        mask = (idx >= 1) & (idx < i)
        rev = torch.clamp(i - idx, 0, n_taps - 1)
        acc = torch.sum(torch.where(mask, a * r[rev], zero))
        k = -(r[i] + acc) / e
        a_flip = a[rev].conj() if a.is_complex() else a[rev]
        a = torch.where(mask, a + k * a_flip, a)
        a[i] = k
        e = e * (1 - torch.abs(k) ** 2)
    return a


def estimate_whitening_filter(x, n_taps):
    """Whitening filter via autocorrelation + Levinson (core.py:1230), on
    the device of ``x`` (a NumPy input goes to the CUDA device)."""
    return levinson(autocorr(x, n_taps), n_taps)
