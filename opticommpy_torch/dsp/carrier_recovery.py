"""Carrier phase and frequency recovery: BPS, DD-PLL, Viterbi & Viterbi,
4th-power FOE.

Port of ``opticommpy_tpu/dsp/carrier_recovery.py``, plus :func:`unwrap`, the
counterpart of ``jnp.unwrap`` that torch lacks, and :func:`unwrap_derotate`,
the receivers' unwrap of the 4th-power phase and derotation in one call.
Both run on the Hopper kernel K15 (``kernels/unwrap.py``) for a CUDA
tensor and as its plain twin's PyTorch ops for a CPU tensor.
:func:`ddpll` is the reference's per-symbol PLL rule on any device;
``cpr(alg="ddpll-pallas")`` runs the DD-PLL on the Hopper kernel
(``kernels/ddpll.py``, K7) for a CUDA tensor, and ``alg="bps-pallas"`` BPS
on K1.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.comm.modulation import gray_mapping
from opticommpy_torch.comm.sources import symbol_pmf
from opticommpy_torch.kernels.unwrap import unwrap_derotate_kernel, unwrap_derotate_plain
from opticommpy_torch.ops.signal import fftfreq, moving_average, pnorm
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["CPRConfig", "cpr", "bps", "ddpll", "viterbi", "fourth_power_foe",
           "residual_linewidth", "unwrap", "unwrap_derotate"]


@dataclass(frozen=True)
class CPRConfig:
    """Carrier phase recovery parameters (carrierRecovery.py:96-108 defaults)."""

    alg: str = "bps"  # 'bps' | 'ddpll' | 'viterbi'
    M: int = 4
    constType: str = "qam"
    shapingFactor: float = 0.0
    B: int = 64  # BPS test phases
    N: int = 35  # moving-average window
    Kv: float = 0.1
    tau1: float = 1 / (2 * np.pi * 10e6)
    tau2: float = 1 / (2 * np.pi * 10e6)
    Ts: float = 1 / 32e9
    runFOE: bool = True


def _rows(x):
    """``x`` as contiguous (N, C) columns, N its first dimension."""
    return x.reshape(x.shape[0], math.prod(x.shape[1:])).contiguous()


def unwrap(p, dim=0, period=2 * math.pi):
    """``jnp.unwrap`` along ``dim``: remove jumps larger than period/2.

    Each step's correction is taken as whole periods and summed exactly,
    with one rounding per output: on K15
    (:func:`~opticommpy_torch.kernels.unwrap.unwrap_derotate_kernel`, with
    ``m = 1``) for a CUDA tensor, which has to be float32, and in PyTorch
    ops (:func:`~opticommpy_torch.kernels.unwrap.unwrap_derotate_plain`)
    for a CPU tensor.
    """
    p = as_device_tensor(p)
    if not p.is_cuda:
        return unwrap_derotate_plain(p, None, 1.0, period, dim)[0]
    x = p.movedim(dim, 0)
    theta = unwrap_derotate_kernel(_rows(x), m=1.0, period=period)[0]
    return theta.reshape(x.shape).movedim(0, dim)


def unwrap_derotate(phases, y, m=4, period=2 * math.pi):
    """``(y * exp(1j * theta), theta)`` with ``theta = unwrap(m * phases,
    period=period) / m`` along dim 0: the carrier phase of an M-th power
    estimator unwrapped and taken off the symbols ``y`` of its shape.

    For CUDA tensors, float32 ``phases`` and complex64 ``y``, one call of
    K15 does both in one pass; CPU tensors take the same rule in PyTorch
    ops.
    """
    phases = as_device_tensor(phases)
    y = torch.as_tensor(y).to(phases.device)
    if y.shape != phases.shape:
        raise ValueError(f"unwrap_derotate: y {tuple(y.shape)} is not of the phases' shape "
                         f"{tuple(phases.shape)}")
    if not phases.is_cuda:
        theta, out = unwrap_derotate_plain(phases, y, m, period)
        return out, theta
    theta, out = unwrap_derotate_kernel(_rows(phases), _rows(y), m=m, period=period)
    return out.reshape(y.shape), theta.reshape(phases.shape)


def bps(sig, n_half, const_symb, n_phases):
    """Blind phase search (Pfau et al. 2009; reference carrierRecovery.py:172).

    The broadcast formulation: the minimum constellation distance for every
    (symbol, mode, test phase), zero-padded at the edges, summed over a
    (2*n_half+1)-symbol window term by term. Returns (N, modes) phases in
    [0, pi/2). :func:`opticommpy_torch.kernels.bps.bps_kernel` is the fused
    kernel version.
    """
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    n = sig.shape[0]
    const = torch.as_tensor(const_symb).to(sig.device, torch.complex64)
    phases = torch.arange(n_phases, dtype=torch.float32,
                          device=sig.device) * (math.pi / 2) / n_phases
    rot = torch.exp(1j * phases)
    z = sig[:, :, None] * rot[None, None, :]  # (N, modes, B)
    dmin = torch.full(z.shape, math.inf, dtype=torch.float32, device=sig.device)
    for i in range(const.shape[0]):
        dmin = torch.minimum(dmin, torch.abs(z - const[i]) ** 2)
    pad = torch.nn.functional.pad(dmin, (0, 0, 0, 0, n_half, n_half))
    sums = torch.zeros_like(dmin)
    for j in range(2 * n_half + 1):
        sums = sums + pad[j:j + n]
    est = phases[torch.argmin(sums, dim=-1)]
    return est[:, 0] if squeeze else est


def ddpll(sig, ts, kv, tau1, tau2, const_symb, symb_tx=None, pilot_ind=None):
    """Decision-directed PLL with 2nd-order loop filter (carrierRecovery.py:226).

    The reference rule: per symbol, ``eo = x e^{j phi}``, the nearest
    constellation point by ``argmin |eo - c|`` (or the known symbol on a
    ``pilot_ind`` row), ``u_d = Im(eo conj(target))``, the loop filter and
    ``phi <- phi - kv u_f``; all columns at once. The loop coefficients are
    computed in float32, as the JAX package's jitted function computes them.
    Returns the phase before each update, (N,) or (N, modes).

    The rotation and the products are written out in real float32
    operations, so every column's result is the same whether it runs alone
    or beside others (complex ``exp`` and products are vectorized by width
    on the CPU). This is also the plain version of the K7 kernel
    (``kernels/ddpll.py``), whose packed columns are bit-identical per signal.
    """
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    dev = sig.device
    n = sig.shape[0]
    const = torch.as_tensor(const_symb).to(dev, torch.complex64)
    ref = (torch.zeros_like(sig) if symb_tx is None
           else torch.as_tensor(symb_tx).to(dev, sig.dtype))
    if ref.ndim == 1:
        ref = ref[:, None]
    is_pilot = [False] * n
    for i in np.atleast_1d(np.asarray(pilot_ind if pilot_ind is not None else [], int)):
        is_pilot[int(i)] = True
    f32 = dict(dtype=torch.float32, device=dev)
    ts, kv, tau1, tau2 = (torch.tensor(v, **f32) for v in (ts, kv, tau1, tau2))
    cot = 1 / torch.tan(ts / (2 * tau2))
    a1 = ts / (2 * tau1) * (1 - cot)
    a2 = ts / (2 * tau1) * (1 + cot)
    x_re, x_im = sig.real.to(torch.float32), sig.imag.to(torch.float32)
    r_re, r_im = ref.real.to(torch.float32), ref.imag.to(torch.float32)
    c_re, c_im = const.real, const.imag
    phi = torch.zeros(sig.shape[1], **f32)
    u_f = torch.zeros_like(phi)
    u_d = torch.zeros_like(phi)
    out = torch.empty((n, sig.shape[1]), **f32)
    for k in range(n):
        u_d1 = u_d
        cs, sn = torch.cos(phi), torch.sin(phi)
        eo_re = x_re[k] * cs - x_im[k] * sn
        eo_im = x_re[k] * sn + x_im[k] * cs
        if is_pilot[k]:
            t_re, t_im = r_re[k], r_im[k]
        else:
            dr, di = eo_re[:, None] - c_re, eo_im[:, None] - c_im
            ind = torch.argmin(dr * dr + di * di, dim=1)
            t_re, t_im = c_re[ind], c_im[ind]
        u_d = eo_im * t_re - eo_re * t_im
        u_f = u_f + a1 * u_d1 + a2 * u_d
        out[k] = phi
        phi = phi - kv * u_f
    return out[:, 0] if squeeze else out


def _integer_pow(x, p):
    """``x ** p`` by repeated squaring, in the order of ``lax.integer_pow``."""
    acc = None
    while p > 0:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p > 0:
            x = x * x
    return acc


def viterbi(sig, n_win=35, m_power=4):
    """Viterbi & Viterbi M-th power phase estimation (carrierRecovery.py:303)."""
    sig = as_device_tensor(sig)
    ma = moving_average(_integer_pow(sig, m_power), n_win)
    return (-unwrap(torch.angle(ma) / m_power, dim=0, period=2 * math.pi / m_power)
            - math.pi / 4)


def fourth_power_foe(sig, fs, m_power=4):
    """M-th power frequency offset estimation + compensation (carrierRecovery.py:331).

    Returns (compensated signal, estimated offsets per mode).
    """
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    n = sig.shape[0]
    f = fftfreq(n, 1.0, torch.float32, sig.device) * fs
    spec = torch.abs(torch.fft.fft(_integer_pow(sig, m_power), dim=0))
    fo = f[torch.argmax(spec, dim=0)] / m_power  # (modes,)
    t = torch.arange(n, dtype=torch.float32, device=sig.device)[:, None] / fs
    out = sig * torch.exp(1j * ((-2 * math.pi * fo)[None, :] * t))
    if squeeze:
        return out[:, 0], fo[0]
    return out, fo


def residual_linewidth(phase_est, Ts):
    """Residual phase-noise linewidth after CPR, in Hz (carrierRecovery.py:154-162)."""
    phase_est = as_device_tensor(phase_est)
    if phase_est.ndim == 1:
        phase_est = phase_est[:, None]
    discard = phase_est.shape[0] // 4
    d = torch.diff(phase_est[discard:-discard], dim=0)
    sigma2 = torch.mean(torch.var(d, dim=0, unbiased=False))
    return sigma2 / (2 * math.pi * Ts)


def cpr(sig, config: CPRConfig = CPRConfig(), symb_tx=None, pilot_ind=None,
        return_phases=False, return_linewidth=False):
    """Carrier phase recovery dispatcher (reference carrierRecovery.py:37).

    Optionally runs 4th-power FOE first, then the selected algorithm ('bps',
    'bps-pallas' on K1, 'ddpll', 'ddpll-pallas' on K7, 'viterbi'), unwraps
    the 4x phase, and derotates. ``return_linewidth=True`` appends the
    :func:`residual_linewidth` estimate [Hz].
    """
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    const = gray_mapping(config.M, config.constType)
    px = symbol_pmf(config.M, config.constType,
                    "maxwell-boltzmann" if config.shapingFactor else "uniform",
                    config.shapingFactor)
    const = (const / np.sqrt(np.sum(np.abs(const) ** 2 * px))).astype(np.complex64)

    if config.runFOE:
        m_foe = config.M if config.constType in ("psk", "apsk") else 4
        sig, _ = fourth_power_foe(sig, 1 / config.Ts, m_foe)
        sig = pnorm(sig)
    if config.alg == "bps":
        phase_est = bps(sig, config.N // 2, torch.as_tensor(const), config.B)
    elif config.alg == "bps-pallas":
        from opticommpy_torch.kernels.bps import bps_kernel

        phase_est = bps_kernel(sig, config.N // 2, torch.as_tensor(const), config.B)
    elif config.alg == "ddpll":
        phase_est = ddpll(sig, config.Ts, config.Kv, config.tau1, config.tau2,
                          torch.as_tensor(const), symb_tx, pilot_ind)
    elif config.alg == "ddpll-pallas":
        from opticommpy_torch.kernels.ddpll import ddpll_kernel

        phase_est = ddpll_kernel(sig, config.Ts, config.Kv, config.tau1, config.tau2,
                                 const, symb_tx, pilot_ind)
    elif config.alg == "viterbi":
        if config.constType == "psk":
            phase_est = viterbi(sig, config.N, config.M) + math.pi / 4
        else:
            phase_est = viterbi(sig, config.N)
    else:
        raise ValueError("CPR algorithm incorrectly specified.")
    phase_est = unwrap(4 * phase_est, dim=0) / 4
    out = pnorm(sig * torch.exp(1j * phase_est))
    lw = residual_linewidth(phase_est, config.Ts) if return_linewidth else None
    if squeeze:
        out = out[:, 0]
        phase_est = phase_est[:, 0]
    ret = (out,)
    if return_phases:
        ret += (phase_est,)
    if return_linewidth:
        ret += (lw,)
    return ret if len(ret) > 1 else out
