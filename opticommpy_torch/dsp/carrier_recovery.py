"""Carrier phase and frequency recovery: BPS and 4th-power FOE.

Port of ``opticommpy_tpu/dsp/carrier_recovery.py`` (the part the coherent
main path uses), plus :func:`unwrap`, the counterpart of ``jnp.unwrap``
that torch lacks.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.comm.modulation import gray_mapping
from opticommpy_torch.comm.sources import symbol_pmf
from opticommpy_torch.ops.signal import fftfreq, pnorm
from opticommpy_torch.utils.scan import cumsum

__all__ = ["CPRConfig", "cpr", "bps", "fourth_power_foe", "residual_linewidth",
           "unwrap"]


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


def unwrap(p, dim=0, period=2 * math.pi):
    """``jnp.unwrap`` along ``dim``: remove jumps larger than period/2."""
    p = torch.as_tensor(p)
    if p.shape[dim] == 0:
        return p
    interval = torch.tensor(period / 2, dtype=p.dtype, device=p.device)
    period_t = torch.tensor(period, dtype=p.dtype, device=p.device)
    dd = torch.diff(p, dim=dim)
    ddmod = torch.remainder(dd + interval, period_t) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    ph_correct = torch.where(torch.abs(dd) < interval, 0.0, ddmod - dd)
    rest = p.narrow(dim, 1, p.shape[dim] - 1) + cumsum(ph_correct, dim=dim)
    return torch.cat([p.narrow(dim, 0, 1), rest], dim=dim)


def bps(sig, n_half, const_symb, n_phases):
    """Blind phase search (Pfau et al. 2009; reference carrierRecovery.py:172).

    The broadcast formulation: the minimum constellation distance for every
    (symbol, mode, test phase), zero-padded at the edges, summed over a
    (2*n_half+1)-symbol window term by term. Returns (N, modes) phases in
    [0, pi/2). :func:`opticommpy_torch.kernels.bps.bps_kernel` is the fused
    kernel version.
    """
    sig = torch.as_tensor(sig)
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


def fourth_power_foe(sig, fs, m_power=4):
    """M-th power frequency offset estimation + compensation (carrierRecovery.py:331).

    Returns (compensated signal, estimated offsets per mode).
    """
    sig = torch.as_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    n = sig.shape[0]
    f = fftfreq(n, 1.0, torch.float32, sig.device) * fs
    if m_power == 4:
        sq = sig * sig
        powered = sq * sq  # the squaring order of lax.integer_pow
    else:
        powered = sig ** m_power
    spec = torch.abs(torch.fft.fft(powered, dim=0))
    fo = f[torch.argmax(spec, dim=0)] / m_power  # (modes,)
    t = torch.arange(n, dtype=torch.float32, device=sig.device)[:, None] / fs
    out = sig * torch.exp(1j * ((-2 * math.pi * fo)[None, :] * t))
    if squeeze:
        return out[:, 0], fo[0]
    return out, fo


def residual_linewidth(phase_est, Ts):
    """Residual phase-noise linewidth after CPR, in Hz (carrierRecovery.py:154-162)."""
    phase_est = torch.as_tensor(phase_est)
    if phase_est.ndim == 1:
        phase_est = phase_est[:, None]
    discard = phase_est.shape[0] // 4
    d = torch.diff(phase_est[discard:-discard], dim=0)
    sigma2 = torch.mean(torch.var(d, dim=0, unbiased=False))
    return sigma2 / (2 * math.pi * Ts)


def cpr(sig, config: CPRConfig = CPRConfig(), symb_tx=None, pilot_ind=None,
        return_phases=False, return_linewidth=False):
    """Carrier phase recovery dispatcher (reference carrierRecovery.py:37).

    Optionally runs 4th-power FOE first, then BPS ('bps', or 'bps-pallas'
    for the fused kernel), unwraps the 4x phase, and derotates.
    """
    if config.alg not in ("bps", "bps-pallas"):
        raise NotImplementedError(
            f"cpr alg={config.alg!r} is not ported yet (ROADMAP.md queue 1, "
            "item 9); 'bps' and 'bps-pallas' are")
    sig = torch.as_tensor(sig)
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
    else:
        from opticommpy_torch.kernels.bps import bps_kernel

        phase_est = bps_kernel(sig, config.N // 2, torch.as_tensor(const), config.B)
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
