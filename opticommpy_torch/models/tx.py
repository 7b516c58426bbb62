"""Optical transmitters: the WDM pol-mux coherent Tx and the PAM IM-DD Tx.

Port of ``opticommpy_tpu/models/tx.py`` (:func:`simple_wdm_tx`,
:func:`pam_transmitter`, :func:`set_power_for_par_ssfm`). The whole (nChannels, nPolModes) grid of signals
is shaped, modulated, shifted onto the WDM grid and summed as batched
tensor ops. Each Tx is split into its random draws (:func:`wdm_tx_draw`,
:func:`pam_tx_draw`) and a deterministic build (:func:`wdm_tx_build`,
:func:`pam_tx_build`), so that a test can feed the JAX package's symbols
through the port.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.comm.modulation import gray_mapping
from opticommpy_torch.comm.sources import draw_symbol_indices, symbol_pmf
from opticommpy_torch.models.config import IQMConfig, MZMConfig
from opticommpy_torch.models.devices import iqm, mzm
from opticommpy_torch.ops.filtering import fir_filter, pulse_shape
from opticommpy_torch.ops.noise import phase_noise
from opticommpy_torch.ops.signal import carrier_phase, signal_power, upsample
from opticommpy_torch.utils.rng import as_device_tensor, ensure_generator
from opticommpy_torch.utils.units import dbm2w

__all__ = ["WDMTxConfig", "PAMTxConfig", "simple_wdm_tx", "wdm_freq_grid", "wdm_tx_draw",
           "wdm_tx_build", "pam_transmitter", "pam_tx_draw", "pam_tx_build",
           "set_power_for_par_ssfm"]


@dataclass(frozen=True)
class WDMTxConfig:
    """WDM transmitter parameters (reference tx.py:42 defaults)."""

    M: int = 16
    constType: str = "qam"
    Rs: float = 32e9
    SpS: int = 16
    probDist: str = "uniform"
    shapingFactor: float = 0.0
    nBits: int = 60000
    pulseType: str = "rrc"
    nFilterTaps: int = 1024
    pulseRollOff: float = 0.01
    mzmScale: float = 0.5
    powerPerChannel: tuple = (-3.0,)  # dBm; scalar broadcast if len==1
    nChannels: int = 5
    Fc: float = 193.1e12
    laserLinewidth: float = 0.0
    wdmGridSpacing: float = 50e9
    nPolModes: int = 1

    @property
    def Fs(self):
        return self.Rs * self.SpS

    @property
    def nSymbols(self):
        return int(self.nBits / np.log2(self.M))


@dataclass(frozen=True)
class PAMTxConfig:
    """PAM transmitter parameters (reference tx.py:231 defaults)."""

    M: int = 4
    Rs: float = 32e9
    SpS: int = 16
    probDist: str = "uniform"
    shapingFactor: float = 0.0
    nBits: int = 40000
    pulseType: str = "nrz"
    nFilterTaps: int = 256
    pulseRollOff: float = 0.01
    mzmVpi: float = 3.0
    mzmVb: float = 1.5
    mzmER: float = 80.0
    mzmScale: float = 0.25
    nPolModes: int = 1
    power: float = -3.0  # dBm

    @property
    def Fs(self):
        return self.Rs * self.SpS

    @property
    def nSymbols(self):
        return int(self.nBits / np.log2(self.M))


def wdm_freq_grid(n_channels, spacing):
    """Center frequencies of the WDM channels relative to Fc (tx.py:140-146)."""
    grid = (
        np.arange(-np.floor(n_channels / 2), np.floor(n_channels / 2) + 1) * spacing
    )
    if n_channels % 2 == 0:
        grid = grid[:n_channels] + spacing / 2
    return grid[:n_channels]


def _constellation(cfg):
    """Constellation normalized to unit energy under the pmf, and the pmf."""
    const = gray_mapping(cfg.M, cfg.constType)
    px = symbol_pmf(cfg.M, cfg.constType, cfg.probDist, cfg.shapingFactor)
    return const / np.sqrt(np.sum(px * np.abs(const) ** 2)), px


def wdm_tx_draw(generator, config: WDMTxConfig = WDMTxConfig()):
    """The Tx's random draws on the generator's device.

    Returns the symbols (nCh, nPol, nSym) complex64 and one carrier phase
    noise realization per channel, (nCh, nSamples) float32.
    """
    cfg = config
    const, px = _constellation(cfg)
    n_ch, n_pol, n_sym = cfg.nChannels, cfg.nPolModes, cfg.nSymbols
    idx = draw_symbol_indices(generator, px, (n_ch, n_pol, n_sym))
    symbols = torch.as_tensor(const.astype(np.complex64),
                              device=generator.device)[idx]
    pn = torch.stack([phase_noise(generator, cfg.laserLinewidth,
                                  n_sym * cfg.SpS, 1 / cfg.Fs)
                      for _ in range(n_ch)])
    return symbols, pn


def wdm_tx_build(symbols, pn, config: WDMTxConfig = WDMTxConfig()):
    """Deterministic part of the Tx from its draws.

    Per channel x polarization: upsample -> pulse shaping -> IQ modulation
    of the phase-noisy carrier -> power setting -> frequency shift onto the
    WDM grid; channels are summed per polarization.

    Returns (sig_wdm (nSamples, nPolModes) complex64, symb_wdm (nSymbols,
    nPolModes, nChannels), freq_grid (nChannels,) numpy offsets [Hz]).
    """
    cfg = config
    n_ch, n_pol, n_sym = symbols.shape
    dev = symbols.device
    n_samples = n_sym * cfg.SpS
    freq_grid = wdm_freq_grid(n_ch, cfg.wdmGridSpacing)
    p_ch = np.asarray(cfg.powerPerChannel, dtype=np.float64).reshape(-1)
    if p_ch.size == 1:
        p_ch = np.full(n_ch, p_ch[0])
    if p_ch.size != n_ch:
        raise ValueError("powerPerChannel length does not match nChannels")
    p_ch_w = torch.as_tensor((10 ** (p_ch / 10) * 1e-3).astype(np.float32),
                             device=dev)

    pulse = pulse_shape(cfg.pulseType, cfg.SpS, cfg.nFilterTaps, cfg.pulseRollOff)
    cols = symbols.reshape(n_ch * n_pol, n_sym).T  # (nSym, nCh*nPol)
    sig = fir_filter(pulse, upsample(cols, cfg.SpS))  # (nSamples, nCh*nPol)
    sig = sig / torch.amax(torch.abs(sig), dim=0, keepdim=True)
    sig = sig.T.reshape(n_ch, n_pol, n_samples)

    sig_lo = torch.exp(1j * pn.to(dev))[:, None, :]  # (nCh, 1, nSamples)
    sig_ch = iqm(sig_lo.expand(sig.shape), cfg.mzmScale * sig, IQMConfig())

    power = (sig_ch * sig_ch.conj()).real.mean(dim=-1, keepdim=True)
    sig_ch = sig_ch / torch.sqrt(power)
    sig_ch = sig_ch * torch.sqrt(p_ch_w[:, None, None] / n_pol)

    # exact carrier phases (ops.signal.carrier_phase); the JAX package forms
    # 2*pi*f*t in float32, which keeps ~0.25 rad at +-187.5 GHz over 2^20 samples
    shift = torch.exp(1j * carrier_phase(n_samples, freq_grid, cfg.Fs, dev))
    sig_wdm = torch.sum(sig_ch * shift[:, None, :], dim=0).T  # (nSamples, nPol)
    return sig_wdm, symbols.permute(2, 1, 0), freq_grid


def simple_wdm_tx(generator_or_seed, config: WDMTxConfig = WDMTxConfig(),
                  device=None):
    """Multi-channel WDM pol-mux transmitter (reference tx.py:42).

    ``generator_or_seed`` is a ``torch.Generator`` (its device is the Tx's)
    or an integer seed for a new generator on ``device`` (the CUDA device
    when none is named; without CUDA that raises). Returns
    (sig_wdm (nSamples, nPolModes), symb_wdm (nSymbols, nPolModes,
    nChannels), freq_grid (nChannels,) numpy offsets [Hz]).
    """
    gen = ensure_generator(generator_or_seed, device)
    symbols, pn = wdm_tx_draw(gen, config)
    return wdm_tx_build(symbols, pn, config)


def _pam_constellation(cfg):
    const = gray_mapping(cfg.M, "pam")
    px = symbol_pmf(cfg.M, "pam", cfg.probDist, cfg.shapingFactor)
    return const / np.sqrt(np.sum(px * np.abs(const) ** 2)), px


def pam_tx_draw(generator, config: PAMTxConfig = PAMTxConfig()):
    """The PAM Tx's random draw on the generator's device: the symbols
    (nSymbols, nPolModes) float32."""
    cfg = config
    const, px = _pam_constellation(cfg)
    idx = draw_symbol_indices(generator, px, (cfg.nSymbols, cfg.nPolModes))
    return torch.as_tensor(const.astype(np.float32), device=generator.device)[idx]


def pam_tx_build(symbols, config: PAMTxConfig = PAMTxConfig()):
    """Deterministic part of the PAM Tx for (nSymbols, C) real ``symbols``,
    each column its own signal: upsample -> pulse shaping -> scaling to
    Vpi at the column's peak -> MZM -> launch power per column.

    Returns the optical field (nSamples, C) complex64.
    """
    cfg = config
    pulse = pulse_shape(cfg.pulseType, cfg.SpS, cfg.nFilterTaps, cfg.pulseRollOff)
    sig = fir_filter(pulse, upsample(symbols, cfg.SpS))
    sig = cfg.mzmVpi * sig / torch.amax(torch.abs(sig), dim=0, keepdim=True)
    mzm_cfg = MZMConfig(Vpi=cfg.mzmVpi, Vb=-cfg.mzmVb, ER=cfg.mzmER)
    sig_o = mzm(torch.ones_like(sig), cfg.mzmScale * sig, mzm_cfg)
    power = torch.mean((sig_o * sig_o.conj()).real, dim=0, keepdim=True)
    return math.sqrt(dbm2w(cfg.power)) * (sig_o / torch.sqrt(power))


def pam_transmitter(generator_or_seed, config: PAMTxConfig = PAMTxConfig(), device=None):
    """Optical PAM/IM-DD transmitter (reference tx.py:231).

    ``generator_or_seed`` is a ``torch.Generator`` (its device is the Tx's)
    or an integer seed for a new generator on ``device`` (the CUDA device
    when none is named). Returns (sig_tx, symb_tx): the MZM-modulated field
    (nSamples,) or (nSamples, nPolModes) and the transmitted PAM symbols.
    """
    gen = ensure_generator(generator_or_seed, device)
    symb = pam_tx_draw(gen, config)
    sig_o = pam_tx_build(symb, config)
    if config.nPolModes == 1:
        return sig_o[:, 0], symb[:, 0]
    return sig_o, symb


def set_power_for_par_ssfm(sig, powers_dbm, verbose=False):
    """Scale the polarization pairs of a mode-batched field to launch powers
    (the GPU reference's parallel-power helper, modelsGPU.py:775).

    Column pairs (2k, 2k+1) of ``sig`` form the k-th polmux signal; each
    column is scaled to half of ``powers_dbm[k]``, so the pair carries
    ``powers_dbm[k]``. One vectorized rescale; the target powers are float32
    as in the JAX package.
    """
    sig = as_device_tensor(sig)
    p_dbm = torch.as_tensor(powers_dbm, dtype=torch.float32, device=sig.device)
    p_lin = torch.repeat_interleave(dbm2w(p_dbm), 2) / 2
    cur = torch.mean((sig * sig.conj()).real, dim=0)
    out = sig * torch.sqrt(p_lin / cur)[None, :]
    if verbose:
        for i in range(out.shape[1]):
            print("power mode %d: %.2f dBm"
                  % (i, 10 * np.log10(float(signal_power(out[:, i])) / 1e-3)))
    return out
