"""Filtering primitives: FFT FIR, overlap-save block convolution, tap design.

Port of ``opticommpy_tpu/ops/filtering.py``. The convolutions run on
``torch.fft`` (cuFFT on the card) in complex64, as the JAX package does;
tap design (:func:`rrc_taps`, :func:`rc_taps`, :func:`pulse_shape`,
:func:`lowpass_fir`) is the same host NumPy code.
"""

import numpy as np
import torch

from opticommpy_torch.utils.rng import as_device_tensor

__all__ = [
    "fir_filter",
    "overlap_save",
    "rrc_taps",
    "rc_taps",
    "pulse_shape",
    "lowpass_fir",
]


def _next_pow2(n):
    return 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))


def _as_tensor(x, device=None):
    """A tensor on ``device``; float64 NumPy input becomes float32, complex128
    complex64, as ``jnp.asarray`` makes them with x64 off."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.float64:
            x = x.astype(np.float32)
        elif x.dtype == np.complex128:
            x = x.astype(np.complex64)
    return torch.as_tensor(x, device=device)


def fir_filter(h, x):
    """FIR-filter ``x`` with taps ``h`` (mode='same', delay-compensated).

    ``x`` is (N,) or (N, nModes); filtering runs along axis 0 for every mode
    at once by one FFT convolution of next-power-of-two length. Returns
    complex64 if ``x`` or ``h`` is complex, else float32.
    """
    x = as_device_tensor(x)
    h = _as_tensor(h, x.device)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    y = _fft_conv_same(h, x, x.is_complex() or h.is_complex())
    return y[:, 0] if squeeze else y


def _fft_conv_same(h, x, is_complex):
    """Linear convolution of (N, modes) ``x`` with (K,) ``h`` by one FFT of
    next-power-of-two length, 'same' output (start ``(K-1)//2``); the real
    part unless ``is_complex``."""
    n, k = x.shape[0], h.shape[0]
    nfft = _next_pow2(n + k - 1)
    X = torch.fft.fft(x.to(torch.complex64), n=nfft, dim=0)
    H = torch.fft.fft(h.to(torch.complex64), n=nfft)
    start = (k - 1) // 2
    y = torch.fft.ifft(X * H[:, None], dim=0)[start:start + n]
    return y if is_complex else y.real


def overlap_save(x, h, nfft=None, freq_domain_filter=False):
    """Blockwise frequency-domain convolution (overlap-and-save).

    'same'-style output compensated for the filter delay; if the input is
    real the real part is returned. ``h`` is an impulse response, or a
    frequency response centered at DC if ``freq_domain_filter=True``.
    ``nfft`` defaults to the next power of two of max(N, K).
    """
    x = as_device_tensor(x)
    h = _as_tensor(h, x.device)
    k = h.shape[0]
    if nfft is None:
        nfft = _next_pow2(max(x.shape[0], k))
    if nfft < k:
        raise ValueError("FFT size is smaller than filter length")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    real_in = not x.is_complex()
    sig_len, n_modes = x.shape
    d_delay = k // 2 if freq_domain_filter else (k - 1) // 2
    block = nfft - k + 1
    discard = k - 1
    if freq_domain_filter:
        ht = torch.fft.fftshift(torch.fft.ifft(h.to(torch.complex64)))
    else:
        ht = h.to(torch.complex64)
    H = torch.fft.fft(ht, n=nfft)
    num_blocks = int(np.ceil((sig_len + k - 1) / block))
    pad_len = num_blocks * block + discard - sig_len
    xp = torch.zeros((discard + sig_len + pad_len + d_delay, n_modes),
                     dtype=torch.complex64, device=x.device)
    xp[discard:discard + sig_len] = x
    blocks = xp.unfold(0, nfft, block)[:num_blocks]  # (blocks, modes, nfft)
    Y = torch.fft.ifft(torch.fft.fft(blocks, dim=-1) * H, dim=-1)
    y = Y[:, :, discard:].permute(0, 2, 1).reshape(num_blocks * block, n_modes)
    y = y[d_delay:d_delay + sig_len]
    if real_in:
        y = y.real
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# Filter design (host-side NumPy: offline, produces constant tap arrays)
# ---------------------------------------------------------------------------


def rrc_taps(t, alpha, Ts):
    """Root-raised-cosine taps on time grid ``t`` (reference core.py:128).

    Singularities at t=0 and |t|=Ts/(4*alpha) are handled with their analytic
    limits over a small tolerance window (the reference relies on exact float
    equality, which only works for grids that hit the points exactly).
    """
    t = np.asarray(t, dtype=np.float64)
    eps = 1e-9 * Ts
    t_abs = np.abs(t)
    t_sing = Ts / (4 * alpha) if alpha > 0 else np.inf

    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = np.pi * t / Ts
        t2 = 4 * alpha * t / Ts
        num = np.sin(t1 * (1 - alpha)) + 4 * alpha * t / Ts * np.cos(t1 * (1 + alpha))
        den = np.pi * t * (1 - t2**2)
        general = (1 / Ts) * num / den

    at_zero = (1 / Ts) * (1 + alpha * (4 / np.pi - 1))
    term1 = (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha)) if alpha > 0 else 0.0
    term2 = (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)) if alpha > 0 else 0.0
    at_sing = (alpha / (Ts * np.sqrt(2))) * (term1 + term2)

    out = np.where(t_abs < eps, at_zero, general)
    out = np.where(np.abs(t_abs - t_sing) < eps, at_sing, out)
    return out


def rc_taps(t, alpha, Ts):
    """Raised-cosine taps on time grid ``t`` (reference core.py:176)."""
    t = np.asarray(t, dtype=np.float64)
    eps = 1e-9 * Ts
    t_sing = Ts / (2 * alpha) if alpha > 0 else np.inf
    with np.errstate(divide="ignore", invalid="ignore"):
        general = (
            (1 / Ts)
            * np.sinc(t / Ts)
            * np.cos(np.pi * alpha * t / Ts)
            / (1 - 4 * alpha**2 * t**2 / Ts**2)
        )
    at_sing = np.pi / (4 * Ts) * np.sinc(1 / (2 * alpha)) if alpha > 0 else 0.0
    return np.where(np.abs(np.abs(t) - t_sing) < eps, at_sing, general)


def pulse_shape(pulse_type="rrc", sps=2, n_taps=256, rolloff=0.1):
    """Generate a normalized pulse-shaping filter (reference core.py:217).

    Supported: 'rect', 'nrz', 'rrc', 'rc', 'duobinary'. Taps are normalized to
    unit sum, matching the reference.
    """
    if pulse_type == "rect":
        pulse = np.concatenate(
            (np.zeros(sps // 2), np.ones(sps), np.zeros(sps // 2))
        )
    elif pulse_type == "nrz":
        t = np.linspace(-2, 2, sps)
        te = 1.0
        pulse = np.convolve(
            np.ones(sps),
            2 / (np.sqrt(np.pi) * te) * np.exp(-(t**2) / te),
            mode="full",
        )
    elif pulse_type == "rrc":
        t = np.linspace(-(n_taps // 2), n_taps // 2, n_taps) * (1 / sps)
        pulse = rrc_taps(t, rolloff, 1)
    elif pulse_type == "rc":
        t = np.linspace(-(n_taps // 2), n_taps // 2, n_taps) * (1 / sps)
        pulse = rc_taps(t, rolloff, 1)
    elif pulse_type == "duobinary":
        t = np.linspace(
            -(n_taps // 2) - sps // 2, n_taps // 2 + sps // 2, n_taps
        ) * (1 / sps)
        pulse = np.sinc(t)
        pulse = pulse + np.roll(pulse, sps)
    else:
        raise ValueError(f"unknown pulse type: {pulse_type}")
    return pulse / np.sum(pulse)


def lowpass_fir(fc, fs, n_taps, filter_type="rect"):
    """Lowpass FIR design by windowed sinc or Gaussian (reference core.py:352)."""
    fu = fc / fs
    d = (n_taps - 1) / 2
    n = np.arange(n_taps)
    if filter_type == "rect":
        h = (2 * fu) * np.sinc(2 * fu * (n - d))
    elif filter_type == "gauss":
        h = (
            np.sqrt(2 * np.pi / np.log(2))
            * fu
            * np.exp(-(2 / np.log(2)) * (np.pi * fu * (n - d)) ** 2)
        )
    else:
        raise ValueError(f"unknown filter type: {filter_type}")
    return h / np.sum(h)
