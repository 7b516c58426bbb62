"""The coherent receiver DSP chain (port of ``opticommpy_tpu/pipelines.py``).

:func:`coherent_dsp_chain` runs matched filter -> decimation -> EDC ->
MIMO adaptive equalization -> 4th-power FOE -> BPS carrier recovery on the
input's device. With ``eqBackend="pallas"`` and ``cprBackend="pallas"`` the
equalizer's training passes and the BPS run on the Hopper kernels
(``kernels/mimo_eq.py``, ``kernels/bps.py``); CPU tensors run the kernels'
plain versions. Clock recovery (``runCR=True``), ``coherent_dsp_serve`` and
the batch chains are not ported yet (ROADMAP.md queue 1, items 11-12).
"""

from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.comm.modulation import gray_mapping
from opticommpy_torch.dsp.carrier_recovery import bps, fourth_power_foe, unwrap
from opticommpy_torch.dsp.equalization import (
    EDCConfig,
    MIMOEqualizerConfig,
    edc,
    mimo_adapt_equalizer,
)
from opticommpy_torch.ops.filtering import fir_filter, pulse_shape
from opticommpy_torch.ops.signal import decimate, pnorm

__all__ = ["CoherentDSPConfig", "coherent_dsp_chain"]


@dataclass(frozen=True)
class CoherentDSPConfig:
    """Coherent receiver chain configuration (same fields and defaults as
    the JAX package's)."""

    Rs: float = 32e9
    SpS_in: int = 16  # samples/symbol at the receiver input
    SpS_dsp: int = 2  # samples/symbol for equalization
    # matched filter
    pulseType: str = "rrc"
    nFilterTaps: int = 1024
    rollOff: float = 0.01
    # CD compensation
    L: float = 400.0  # [km]
    D: float = 16.0
    Fc: float = 193.1e12
    # equalizer
    nTaps: int = 15
    mu: tuple = (5e-3, 2e-3)
    alg: tuple = ("da-rde", "dd-lms")
    nTrain: int = 10000
    M: int = 16
    blockUpdate: int = 1
    # 'scan': the per-symbol reference rules; 'pallas': every training pass
    # on the Hopper kernel; 'pallas-lms': one kernel pass of LMS
    # (data-aided for nTrain symbols, then decision-directed, FOE before it)
    eqBackend: str = "scan"
    # carrier recovery: 'xla' = the broadcast BPS, 'pallas' = the Hopper kernel
    cpr_window: int = 75
    cpr_phases: int = 64
    cprBackend: str = "xla"
    runFOE: bool = True
    # clock recovery: not ported yet
    runCR: bool = False
    crMethod: str = "gardner"
    crBackend: str = "pallas"
    crKp: float = 2e-3
    crKi: float = 1e-5
    crMaxPPM: float = 500.0
    crNyquist: bool = False
    crBlockLen: int = 4096
    crFit: str = "linear"


def _stage_lengths(cfg: CoherentDSPConfig, n_sym: int):
    """Per-stage symbol counts: 1 stage (all symbols) or 2 (nTrain, rest)."""
    n_stages = len(cfg.alg)
    if n_stages == 1:
        return (n_sym,)
    if n_stages == 2:
        return (cfg.nTrain, n_sym - cfg.nTrain)
    raise ValueError(
        f"CoherentDSPConfig.alg has {n_stages} stages; the chain's "
        "nTrain split only defines schedules for 1 or 2 stages — build a "
        "MIMOEqualizerConfig with an explicit L tuple and call "
        "mimo_adapt_equalizer directly for longer schedules")


def _norm_const(M):
    const = gray_mapping(M, "qam")
    return (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)


def coherent_dsp_chain(sig, symb_ref, config: CoherentDSPConfig = CoherentDSPConfig()):
    """Full coherent DSP chain on the device of ``sig``.

    Parameters
    ----------
    sig : (N, modes) complex received signal at ``SpS_in`` samples/symbol.
    symb_ref : (nSym, modes) transmitted symbols, already synchronized.

    Returns
    -------
    (y, phases): equalized + carrier-recovered symbols and the CPR phases.
    """
    cfg = config
    if cfg.runCR:
        raise NotImplementedError(
            "coherent_dsp_chain: runCR (clock recovery) is not ported yet "
            "(ROADMAP.md queue 1, item 12)")
    if cfg.eqBackend not in ("scan", "pallas", "pallas-lms"):
        raise ValueError(f"unknown eqBackend {cfg.eqBackend!r}")
    sig = torch.as_tensor(sig)
    symb_ref = torch.as_tensor(symb_ref).to(sig.device)
    fs_dsp = cfg.Rs * cfg.SpS_dsp

    pulse = pulse_shape(cfg.pulseType, cfg.SpS_in, cfg.nFilterTaps, cfg.rollOff)
    x = fir_filter(pulse.astype(np.float32), sig)
    x = decimate(x, cfg.SpS_in, cfg.SpS_dsp)
    x = edc(x, EDCConfig(L=cfg.L, D=cfg.D, Fc=cfg.Fc, Fs=fs_dsp, Rs=cfg.Rs))
    x = pnorm(x)

    n_sym = symb_ref.shape[0]
    if cfg.eqBackend == "pallas-lms":
        from opticommpy_torch.kernels.mimo_eq import mimo_eq_kernel

        # LMS is phase-sensitive: remove the carrier frequency offset first
        if cfg.runFOE:
            x, _ = fourth_power_foe(x, fs_dsp, 4)
            x = pnorm(x)
        y, _ = mimo_eq_kernel(x, pnorm(symb_ref), _norm_const(cfg.M), alg="lms",
                              n_taps=cfg.nTaps, sps=cfg.SpS_dsp,
                              mu=float(cfg.mu[0]), n_train=cfg.nTrain)
    else:
        eq_cfg = MIMOEqualizerConfig(
            nTaps=cfg.nTaps, SpS=cfg.SpS_dsp, mu=cfg.mu, alg=cfg.alg,
            L=_stage_lengths(cfg, n_sym), M=cfg.M, numIter=2,
            blockUpdate=cfg.blockUpdate,
            backend="pallas" if cfg.eqBackend == "pallas" else "scan")
        y = mimo_adapt_equalizer(x, eq_cfg, symb_ref=pnorm(symb_ref))

    if cfg.runFOE and cfg.eqBackend != "pallas-lms":
        y, _ = fourth_power_foe(y, cfg.Rs, 4)
        y = pnorm(y)
    const = _norm_const(cfg.M)
    if cfg.cprBackend == "pallas":
        from opticommpy_torch.kernels.bps import bps_kernel

        phases = bps_kernel(y, cfg.cpr_window // 2, const, cfg.cpr_phases)
    else:
        phases = bps(y, cfg.cpr_window // 2, torch.as_tensor(const), cfg.cpr_phases)
    phases = unwrap(4 * phases, dim=0) / 4
    y = pnorm(y * torch.exp(1j * phases))
    return y, phases
