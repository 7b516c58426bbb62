"""Clock and timing recovery: the Gardner loop and feedforward retiming.

Port of ``opticommpy_tpu/dsp/clock_recovery.py``:

- :func:`gardner_clock_recovery` — Gardner timing-error detector, PI loop
  filter and cubic Farrow NCO with sample skip/stuff (reference
  clockRecovery.py:85). ``backend='scan'`` runs the reference's per-sample
  loop in plain PyTorch on any device; ``backend='pallas'`` runs the same
  loop on the Hopper kernel (``kernels/gardner.py``, K6) for a CUDA tensor,
  and its plain version for a CPU tensor.
- :func:`ffw_clock_recovery` — feedforward retiming: per-block band-edge
  spectral-line timing estimates, a linear or piecewise-linear drift fit,
  then cubic resampling of every output sample at once (no recurrence, so
  no kernel).
- :func:`calc_clock_drift` — host-side drift estimate from the NCO timing
  (SciPy ``find_peaks``).
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
from scipy.signal import find_peaks

from opticommpy_torch.kernels import gardner
from opticommpy_torch.utils.rng import as_device_tensor
from opticommpy_torch.utils.scan import cumsum

__all__ = [
    "ClockRecoveryConfig",
    "FFWClockRecoveryConfig",
    "gardner_ted",
    "gardner_ted_nyquist",
    "interpolator",
    "gardner_clock_recovery",
    "ffw_clock_recovery",
    "calc_clock_drift",
]


@dataclass(frozen=True)
class ClockRecoveryConfig:
    """Gardner clock recovery parameters (clockRecovery.py:108-114 defaults)."""

    kp: float = 1e-3
    ki: float = 1e-6
    isNyquist: bool = True
    lpad: int = 1
    maxPPM: float = 500.0


def gardner_ted(x):
    """Gardner timing error on a 3-sample segment (clockRecovery.py:24)."""
    x = as_device_tensor(x)
    return torch.real(torch.conj(x[1]) * (x[2] - x[0]))


def gardner_ted_nyquist(x):
    """Modified Gardner TED for Nyquist pulses (clockRecovery.py:42)."""
    x = as_device_tensor(x)
    return torch.abs(x[1]) ** 2 * (torch.abs(x[0]) ** 2 - torch.abs(x[2]) ** 2)


def interpolator(x, t):
    """Cubic Farrow interpolation over a 4-sample segment (clockRecovery.py:60)."""
    x = as_device_tensor(x)
    t3 = t * t * t
    t2 = t * t
    return (x[0] * (-1 / 6 * t3 + 1 / 6 * t)
            + x[1] * (1 / 2 * t3 + 1 / 2 * t2 - t)
            + x[2] * (-1 / 2 * t3 - t2 + 1 / 2 * t + 1)
            + x[3] * (1 / 6 * t3 + 1 / 2 * t2 + 1 / 3 * t))


def gardner_clock_recovery(sig, config: ClockRecoveryConfig = ClockRecoveryConfig(),
                           return_timing=False, backend="scan", static_out=False):
    """Gardner clock recovery with PI loop filter and NCO (clockRecovery.py:85).

    Input at 2 samples/symbol, output retimed at 2 samples/symbol; returns
    the recovered signal (and the NCO timing values if ``return_timing``).
    ``backend='pallas'`` runs the loop on the Hopper kernel for a CUDA
    tensor; any other backend runs the reference's per-sample loop.

    ``static_out=True`` keeps the output at ``n_out = (1 - maxPPM/1e6) *
    n_in`` samples; otherwise it is cut to the last sample the NCO reached
    in any mode (a host sync).
    """
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    sig = torch.cat([sig.to(torch.complex64),
                     sig.new_zeros((config.lpad, sig.shape[1]), dtype=torch.complex64)])
    n_in = sig.shape[0]
    n_out = int((1 - config.maxPPM / 1e6) * n_in)
    run = gardner.gardner_records if backend == "pallas" else gardner.gardner_plain
    eo, tv, n_fin = run(sig, config.kp, config.ki, config.isNyquist, n_out)
    if not static_out:
        last_n = int(n_fin.max())  # host sync: data-dependent crop
        eo, tv = eo[:last_n], tv[:last_n]
    if squeeze:
        eo, tv = eo[:, 0], tv[:, 0]
    return (eo, tv) if return_timing else eo


@dataclass(frozen=True)
class FFWClockRecoveryConfig:
    """Feedforward (block-parallel) clock recovery parameters.

    ``blockLen`` samples per timing-estimation block (the mod-1-symbol
    unwrap tracks |ppm| < 0.5 * sps / blockLen * 1e6); ``maxPPM`` sets the
    static output length as in Gardner; ``rollOff`` the spectral window;
    ``fit`` is 'linear' (a constant clock offset) or 'pwl' (tracking).
    """

    blockLen: int = 2048
    maxPPM: float = 500.0
    rollOff: float = 0.1
    fit: str = "linear"
    sps: int = 2


def _ffw_timing_estimate(x, L, W, sps=2):
    """Per-block band-edge timing ``tau`` (symbols, unwrapped mod one symbol)
    and the estimator magnitudes ``|A_b|`` (fit weights)."""
    nb = x.shape[0] // L
    X = torch.fft.fft(x[: nb * L].reshape(nb, L, -1), dim=1)
    Xs = torch.roll(X, L // sps, dims=1)
    c = L // (2 * sps)
    A = torch.sum(X[:, c - W:c + W] * torch.conj(Xs[:, c - W:c + W]), dim=(1, 2))
    eps = -torch.angle(A) / (2 * math.pi)  # symbols, in [-0.5, 0.5)
    d = torch.remainder(eps[1:] - eps[:-1] + 0.5, 1.0) - 0.5
    tau = torch.cat([eps[:1], eps[0] + cumsum(d, dim=0)])
    return tau, torch.abs(A)


def _resample_cubic(x, off):
    """``y[i] = x(i + off[i])`` by cubic Lagrange interpolation on the nodes
    {-1, 0, 1, 2}: ``y[i] = sum_tap c_tap * x[base_i - 1 + tap]``, summed in
    tap order (the JAX package's slice-sum form adds the same terms and
    exact zeros)."""
    n_in = x.shape[0]
    off_fl = torch.floor(off)
    i_out = torch.arange(off.shape[0], device=x.device)
    base = torch.clamp(i_out + off_fl.long(), 1, n_in - 3)
    f = off - off_fl
    coefs = (-f * (f - 1) * (f - 2) / 6,
             (f + 1) * (f - 1) * (f - 2) / 2,
             -f * (f + 1) * (f - 2) / 2,
             f * (f + 1) * (f - 1) / 6)
    y = None
    for tap, c in enumerate(coefs):
        term = c[:, None] * x[base - 1 + tap]
        y = term if y is None else y + term
    return y


def ffw_clock_recovery(sig, config: FFWClockRecoveryConfig = FFWClockRecoveryConfig(),
                       return_est=False):
    """Feedforward block-parallel clock recovery (no recurrence).

    Per-block band-edge timing estimates (joint over modes: one ADC clock),
    mod-1-symbol unwrap, an |A|-weighted linear fit (``fit='linear'``) or a
    smoothed piecewise-linear trajectory (``fit='pwl'``), then cubic
    resampling of all modes on the corrected grid. The output keeps the
    static length ``(1 - maxPPM/1e6) * n_in``. Returns the retimed signal,
    plus ``(ppm_est, tau_blocks)`` if ``return_est``.
    """
    cfg = config
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    n_in = sig.shape[0]
    L, sps = cfg.blockLen, cfg.sps
    if n_in < 2 * L:
        raise ValueError(f"need >= {2 * L} samples for {L}-sample blocks")
    W = max(8, int(cfg.rollOff * L / (2 * sps)) + 32)
    W = min(W, L // (2 * sps))
    tau, w = _ffw_timing_estimate(sig, L, W, sps)
    nb = tau.shape[0]
    f32 = dict(dtype=torch.float32, device=sig.device)

    idx = torch.arange(nb, **f32)
    sw = torch.sum(w)
    sx = torch.sum(w * idx)
    sy = torch.sum(w * tau)
    sxx = torch.sum(w * idx * idx)
    sxy = torch.sum(w * idx * tau)
    slope = (sw * sxy - sx * sy) / (sw * sxx - sx * sx)
    max_slope = cfg.maxPPM * 1e-6 * L / sps
    slope = torch.clamp(slope, -max_slope, max_slope)
    intercept = (sy - slope * sx) / sw
    delta = slope * sps / L  # fractional clock offset (samples/sample)
    ppm_est = delta * 1e6

    n_out = int((1 - cfg.maxPPM / 1e6) * n_in)
    i = torch.arange(n_out, **f32)
    if cfg.fit == "linear":
        phi = intercept * sps - delta * (L / 2)
        phi = torch.remainder(phi + sps / 2, sps) - sps / 2
        off = i * delta + phi
    elif cfg.fit == "pwl":
        kern = torch.tensor([1.0, 2.0, 3.0, 2.0, 1.0], **f32) / 9.0
        tp = torch.cat([tau[:1], tau[:1], tau, tau[-1:], tau[-1:]])
        tau_s = sum(kern[j] * tp[j:j + nb] for j in range(5))
        phi0 = tau_s[0] * sps
        phi0_w = torch.remainder(phi0 + sps / 2, sps) - sps / 2
        tau_s = tau_s - tau_s[0]
        pos = (i - L / 2) / L
        k = torch.clamp(torch.floor(pos).long(), 0, nb - 2)
        fr = torch.clamp(pos - k, min=0.0)
        tau_i = tau_s[k] * (1 - fr) + tau_s[k + 1] * fr
        off = sps * tau_i + phi0_w
    else:
        raise ValueError(f"unknown fit mode {cfg.fit!r}")
    y = _resample_cubic(sig, off)
    if squeeze:
        y = y[:, 0]
    return (y, (ppm_est, tau)) if return_est else y


def calc_clock_drift(t_nco_values):
    """Clock drift estimate in ppm from NCO timing values (clockRecovery.py:194).

    Host-side analysis (find_peaks on the wrap events of the timing error).
    """
    if isinstance(t_nco_values, torch.Tensor):
        t_nco_values = t_nco_values.detach().cpu().numpy()
    t = np.asarray(t_nco_values)
    if t.ndim == 1:
        t = t[:, None]
    timing_err = t - np.mean(t, axis=0, keepdims=True)
    ppm = np.zeros(t.shape[1])
    for k in range(t.shape[1]):
        peaks, _ = find_peaks(np.abs(np.diff(timing_err[:, k])), height=0.5)
        if len(peaks) < 2:
            ppm[k] = 0.0
            continue
        mean_period = np.mean(np.diff(peaks))
        ppm[k] = np.sign(np.mean(t[:, k])) * (1 / mean_period) * 1e6
    return ppm
