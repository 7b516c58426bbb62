"""Signal conditioning primitives: power/normalization, resampling, sync.

Port of ``opticommpy_tpu/ops/signal.py``. Signals are (N,) or (N, modes)
tensors with time on axis 0; every function works on all modes at once
and keeps the input's device.
"""

import cmath
import math

import numpy as np
import torch

from opticommpy_torch.ops.filtering import fir_filter, lowpass_fir
from opticommpy_torch.utils.rng import as_device_tensor
from opticommpy_torch.utils.scan import cumsum

__all__ = [
    "sig_pow",
    "signal_power",
    "pnorm",
    "anorm",
    "upsample",
    "quantizer",
    "clock_sampling_interp",
    "decimate",
    "resample",
    "finddelay",
    "symbol_sync",
    "moving_average",
    "delay_signal",
    "iq_mixing",
    "freq_shift",
    "carrier_phase",
]


def fftfreq(n, d=1.0, dtype=torch.float32, device=None):
    """``jnp.fft.fftfreq``: integer bins divided by ``n*d`` in ``dtype``.

    ``torch.fft.fftfreq`` multiplies by the reciprocal instead, which rounds
    differently; the port keeps the JAX package's grid.
    """
    k = torch.cat([torch.arange(0, (n - 1) // 2 + 1, device=device),
                   torch.arange(-(n // 2), 0, device=device)]).to(dtype)
    return k / torch.tensor(d * n, dtype=dtype, device=device)


def _power(x):
    return (x * x.conj()).real if x.is_complex() else x * x


def sig_pow(x):
    """Average power ``mean(|x|^2)`` over all elements (core.py:50)."""
    return torch.mean(torch.abs(as_device_tensor(x)) ** 2)


def signal_power(x):
    """Total power: sum over modes of the per-mode average power (core.py:69)."""
    x = as_device_tensor(x)
    if x.ndim == 1:
        x = x[:, None]
    return torch.sum(torch.mean(_power(x), dim=0))


def pnorm(x):
    """Normalize ``x`` to unit average power (global mean, core.py:701)."""
    x = as_device_tensor(x)
    return x / torch.sqrt(torch.mean(_power(x)))


def tree_sum(p):
    """Pairwise sum over the last dimension, zero-padded to a power of two:
    s[i] += s[i + h] for h = P/2, ..., 1. The order is fixed, so a row's
    sum is the same in any batch and on any device."""
    n = p.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        p = torch.cat([p, p.new_zeros(p.shape[:-1] + (width - n,))], dim=-1)
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def row_mean(x):
    """Mean over the last dimension by :func:`tree_sum` (batch-invariant).
    The divisor is a device tensor: a true division on CUDA as on the CPU
    (a Python-scalar divisor may become a product by its reciprocal). It is
    filled on the device: a copy from the host would wait for the stream."""
    return tree_sum(x) / torch.full((), float(x.shape[-1]), device=x.device)


def pnorm_rows(x):
    """:func:`pnorm` of each row (last dimension) on its own, in one pass
    over the batch; a row's result does not depend on the batch."""
    return x / torch.sqrt(row_mean(_power(x)))[..., None]


def anorm(x):
    """Normalize ``x`` to unit peak amplitude (core.py:720)."""
    x = as_device_tensor(x)
    return x / torch.amax(torch.abs(x))


def upsample(x, factor):
    """Insert ``factor-1`` zeros between samples along axis 0 (core.py:395)."""
    x = as_device_tensor(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n, m = x.shape
    up = torch.zeros((n, factor, m), dtype=x.dtype, device=x.device)
    up[:, 0, :] = x
    up = up.reshape(n * factor, m)
    return up[:, 0] if squeeze else up


def quantizer(x, n_bits=16, max_v=1.0, min_v=-1.0):
    """Uniform quantizer with 2**n_bits levels spanning [min_v, max_v]
    (core.py:317), float32: the level index is ``(x - min_v) / delta``
    rounded half to even and clipped. The division is a product by the
    float32 reciprocal of ``delta``, the arithmetic XLA gives the JAX
    package's division by a scalar, so near-ties round to the same level.
    ``max_v`` and ``min_v`` may be 0-dim tensors."""
    x = as_device_tensor(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    max_v = torch.as_tensor(max_v).to(**f32)
    min_v = torch.as_tensor(min_v).to(**f32)
    top = torch.full((), float(2**n_bits - 1), **f32)
    delta = (max_v - min_v) / top
    inv = torch.ones((), **f32) / delta
    idx = torch.clamp(torch.round((x - min_v) * inv), min=0.0, max=float(2**n_bits - 1))
    return (min_v + idx * delta).to(torch.float32)


def _interp_columns(t_out, t_in, x):
    """``jnp.interp(t_out, t_in, col)`` for every column of real (N, M) ``x``:
    linear interpolation with the end values held outside ``t_in``."""
    n = t_in.shape[0]
    i = torch.clamp(torch.searchsorted(t_in, t_out, right=True), 1, n - 1)
    df = x[i] - x[i - 1]
    dx = (t_in[i] - t_in[i - 1])[:, None]
    delta = (t_out - t_in[i - 1])[:, None]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, x[i - 1], x[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where((t_out < t_in[0])[:, None], x[:1], f)
    return torch.where((t_out > t_in[-1])[:, None], x[-1:], f)


def _interp_extrap(x, xp, fp):
    """``np.interp(x, xp, fp)`` for increasing ``xp``, but continued linearly
    beyond both ends through the first and the last two points (the JAX
    package's OFDM channel estimate and EDFA noise profile); one point is
    held everywhere."""
    n = xp.numel()
    if n < 2:
        return fp[:1].expand(x.shape)
    j = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, n - 2)
    return fp[j] + (fp[j + 1] - fp[j]) / (xp[j + 1] - xp[j]) * (x - xp[j])


def clock_sampling_interp(x, in_fs, out_fs, jitter_rms=0.0, generator=None):
    """Linear-interpolation resampling to a new clock (core.py:272).

    The time axes are float32, ``arange * Ts`` as the JAX package computes
    them. Sampling-clock jitter (``jitter_rms`` seconds) is drawn from the
    explicit ``generator`` and moved to the signal's device; asking for
    jitter without a generator raises, as the JAX package does without a
    key.
    """
    x = as_device_tensor(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n = x.shape[0]
    in_ts = 1.0 / in_fs
    out_ts = 1.0 / out_fs
    n_out = int(np.ceil(n * in_ts / out_ts - 1e-12))
    f32 = dict(dtype=torch.float32, device=x.device)
    t_in = torch.arange(n, **f32) * torch.tensor(in_ts, **f32)
    t_out = torch.arange(n_out, **f32) * torch.tensor(out_ts, **f32)
    if jitter_rms > 0:
        if generator is None:
            raise ValueError("jitter requested but no generator provided")
        draw = torch.randn(n_out, generator=generator, device=generator.device)
        t_out = t_out + torch.tensor(jitter_rms, **f32) * draw.to(x.device)
    if x.is_complex():
        y = torch.complex(_interp_columns(t_out, t_in, x.real),
                          _interp_columns(t_out, t_in, x.imag)).to(x.dtype)
    else:
        y = _interp_columns(t_out, t_in, x).to(x.dtype)
    return y[:, 0] if squeeze else y


def _roll_columns(x, shifts):
    """Roll column k of (N, M) ``x`` by ``-shifts[k]`` (``jnp.roll(col, -d)``)."""
    n = x.shape[0]
    idx = (torch.arange(n, device=x.device)[:, None]
           + shifts.to(x.device)[None, :]) % n
    return torch.gather(x, 0, idx)


def decimate(x, sps_in, sps_out=1):
    """Decimate with max-variance sampling-phase selection (core.py:435).

    For each mode, picks the sampling phase with maximum variance, rolls the
    signal there, then keeps every ``sps_in // sps_out``-th sample.
    """
    x = as_device_tensor(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    dec = sps_in // sps_out
    n, m = x.shape
    n_sym = n // sps_in
    blocks = x[: n_sym * sps_in].reshape(n_sym, sps_in, m)
    centered = blocks - blocks.mean(dim=0, keepdim=True)
    phase_var = _power(centered).mean(dim=0)  # (sps_in, m)
    delays = torch.argmax(phase_var, dim=0)
    y = _roll_columns(x, delays)[::dec, :]
    return y[:, 0] if squeeze else y


def resample(x, in_fs, out_fs, n_taps=501):
    """Rational/arbitrary resampling with anti-aliasing FIRs (core.py:494)."""
    x = as_device_tensor(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if out_fs < in_fs:
        x = fir_filter(lowpass_fir(out_fs / 2, in_fs, min(x.shape[0], n_taps)), x)
    y = clock_sampling_interp(x, in_fs, out_fs)
    if out_fs > in_fs:
        y = fir_filter(lowpass_fir(in_fs / 2, out_fs, min(y.shape[0], n_taps)), y)
    return y[:, 0] if squeeze else y


def _xcorr_full(a, v):
    """np.correlate(a, v, mode='full') via FFT: length len(a)+len(v)-1."""
    n, m = a.shape[0], v.shape[0]
    nfft = 1 << int(math.ceil(math.log2(n + m - 1)))
    A = torch.fft.fft(a, n=nfft)
    V = torch.fft.fft(torch.flip(v, [0]).conj(), n=nfft)
    c = torch.fft.ifft(A * V)[: n + m - 1]
    if not (a.is_complex() or v.is_complex()):
        c = c.real
    return c


def finddelay(x, y):
    """Delay between x and y via FFT cross-correlation argmax (core.py:678)."""
    x = as_device_tensor(x)
    y = torch.as_tensor(y).to(x.device)
    xcorr = torch.abs(_xcorr_full(x, y))
    return torch.argmax(xcorr) - x.shape[0] + 1


def _imag(x):
    """``jnp.imag``: the imaginary part, zeros for a real tensor."""
    return x.imag if x.is_complex() else torch.zeros_like(x)


def _peak(c):
    """The value of ``c`` at its first largest magnitude."""
    return c[torch.argmax(torch.abs(c))]


def symbol_sync(rx, tx, sps, mode="amp"):
    """Align the transmitted sequence to the received one (core.py:552).

    Decimates ``rx`` to 1 SpS, resolves mode swaps from the cross-correlation
    of centered amplitudes ('amp') or of real parts, with the pi/2 rotation
    and the conjugation resolved from the signs of the peaks ('real'), then
    rolls out the per-mode delays. Modes are visited in the JAX package's
    order and argmaxes take the first of equal maxima, so ties resolve the
    same way. Returns the synchronized transmit sequence.
    """
    rx = as_device_tensor(rx)
    tx = torch.as_tensor(tx).to(rx.device)
    squeeze = rx.ndim == 1
    if squeeze:
        rx = rx[:, None]
    if tx.ndim == 1:
        tx = tx[:, None]
    n_modes = rx.shape[1]
    if sps > 1:
        rx = decimate(rx, sps, 1)

    def centered_abs(z):
        a = torch.abs(z)
        return a - a.mean(dim=0, keepdim=True)

    if mode == "amp":
        atx, arx = centered_abs(tx), centered_abs(rx)
        corr = torch.stack([
            torch.stack([torch.max(torch.abs(_xcorr_full(atx[:, m], arx[:, n])))
                         for n in range(n_modes)])
            for m in range(n_modes)])
        swap = torch.argmax(corr, dim=0)
        tx = tx[:, swap]
        atx = centered_abs(tx)
        delays = torch.stack([
            torch.argmax(torch.abs(_xcorr_full(atx[:, k], arx[:, k])))
            - tx.shape[0] + 1 for k in range(n_modes)])
    elif mode == "real":
        one = torch.ones((), dtype=torch.complex64, device=rx.device)
        peaks, rots = [], []
        for m in range(n_modes):
            for n in range(n_modes):
                crr = _peak(_xcorr_full(tx[:, m].real, rx[:, n].real))
                cir = _peak(_xcorr_full(_imag(tx[:, m]), rx[:, n].real))
                rot = torch.where(torch.abs(crr) > torch.abs(cir),
                                  torch.where(crr > 0, one, -one),
                                  torch.where(cir > 0, -1j * one, 1j * one))
                peaks.append(torch.maximum(torch.abs(crr), torch.abs(cir)))
                rots.append(rot)
        peaks = torch.stack(peaks).reshape(n_modes, n_modes)
        rots = torch.stack(rots).reshape(n_modes, n_modes)
        swap = torch.argmax(peaks, dim=0)
        tx = tx[:, swap] * rots[swap, torch.arange(n_modes, device=rx.device)][None, :]
        delays, cols = [], []
        for k in range(n_modes):
            col = tx[:, k]
            delays.append(torch.argmax(torch.abs(_xcorr_full(col.real, rx[:, k].real)))
                          - tx.shape[0] + 1)
            cii = _peak(_xcorr_full(col.imag, _imag(rx[:, k])))
            cols.append(torch.where(cii < 0, col.conj(), col))
        tx = torch.stack(cols, dim=1)
        delays = torch.stack(delays)
    else:
        raise ValueError("mode must be 'amp' or 'real'")
    tx = _roll_columns(tx, delays)
    return tx[:, 0] if squeeze else tx


def moving_average(x, window):
    """Sliding-window moving average with edge zero-padding (core.py:829),
    as a cumulative-sum difference like the JAX package's."""
    x = as_device_tensor(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    pad = window // 2
    xp = torch.cat([x.new_zeros((pad, x.shape[1])), x, x.new_zeros((pad, x.shape[1]))])
    c = torch.cat([x.new_zeros((1, x.shape[1])), cumsum(xp, dim=0)])
    y = ((c[window:] - c[:-window]) / window)[: x.shape[0]].to(x.dtype)
    return y[:, 0] if squeeze else y


def delay_signal(sig, delay, fs=1.0):
    """Apply a (possibly fractional) time delay via an FFT phase ramp.

    The signal is zero-padded by ceil(|delay*fs|)+1 to avoid circular wrap,
    delayed with ``exp(-j*2*pi*f*delay)`` and cropped back (core.py:880).
    """
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    n = sig.shape[0]
    pad_len = int(math.ceil(abs(delay * fs))) + 1
    real_in = not sig.is_complex()
    xp = torch.cat([sig, torch.zeros((pad_len, sig.shape[1]), dtype=sig.dtype,
                                     device=sig.device)])
    real_dtype = torch.float64 if sig.dtype in (torch.float64,
                                                torch.complex128) else torch.float32
    freq = fftfreq(xp.shape[0], 1.0 / fs, real_dtype, sig.device)
    ramp = torch.exp(-1j * ((2 * math.pi * delay) * freq))
    y = torch.fft.ifft(torch.fft.fft(xp, dim=0) * ramp[:, None], dim=0)[:n]
    y = y.real if real_in else y.to(sig.dtype)
    return y[:, 0] if squeeze else y


def iq_mixing(sig, fs, amp_imb_db=0.0, phase_imb=0.0, time_skew=0.0):
    """Apply IQ amplitude/phase imbalance and IQ time skew (core.py:925)."""
    sig = as_device_tensor(sig)
    eps = 10 ** (amp_imb_db / 20) - 1
    k1 = ((1 - eps) * cmath.exp(1j * phase_imb / 2) / 2
          + (1 + eps) * cmath.exp(-1j * phase_imb / 2) / 2)
    k2 = ((1 - eps) * cmath.exp(-1j * phase_imb / 2) / 2
          - (1 + eps) * cmath.exp(1j * phase_imb / 2) / 2)
    mixed = k1 * sig + k2 * sig.conj()
    if time_skew == 0.0:
        return mixed
    delay = time_skew / 2
    s_i = delay_signal(mixed.real, -delay, fs)
    s_q = delay_signal(mixed.imag, delay, fs)
    return torch.complex(s_i, s_q)


def carrier_phase(n, freq, fs, device=None):
    """The phase ``2*pi*freq*k/fs`` of a carrier at the samples ``k < n``,
    exact to one float32 rounding: the turns ``k*freq/fs`` are reduced to
    [-1/2, 1/2] in float64, multiplied by ``2*pi`` and rounded once to
    float32. (A float32 ramp ``2*pi*freq*t`` reaches ~2.4e6 rad over 2^20
    samples at 187.5 GHz and keeps ~0.25 rad of it.) ``freq`` is a number,
    giving (n,), or a sequence of frequencies, giving (len(freq), n)."""
    f = torch.as_tensor(np.asarray(freq, dtype=np.float64) / fs, device=device)
    k = torch.arange(n, dtype=torch.float64, device=device)
    turns = f[..., None] * k
    return ((2 * math.pi) * (turns - torch.round(turns))).to(torch.float32)


def freq_shift(x, delta_f, fs):
    """Shift the signal spectrum by ``delta_f`` Hz (core.py:1049): ``x *
    exp(j*2*pi*delta_f*t)`` with ``t = arange(N) / fs`` and the phase in
    float32, as the JAX package computes them."""
    x = as_device_tensor(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    t = torch.arange(x.shape[0], **f32) / torch.full((), fs, **f32)
    ph = torch.exp(1j * (float(2 * math.pi * delta_f) * t))
    if x.ndim > 1:
        ph = ph[:, None]
    return x * ph
