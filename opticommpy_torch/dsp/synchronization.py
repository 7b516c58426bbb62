"""Sequence synchronization: align a transmitted reference to a received
signal.

Port of ``opticommpy_tpu/dsp/synchronization.py`` (reference
``optic/dsp/synchronization.py``, syncDataSequences, :30): tiles or pads
the reference to the received length, runs the cross-correlation symbol
synchronizer, then rebuilds the reference waveform ('symbols') or detects
the symbols again ('signal'). The nonzero symbols of each column are found
on the host, as in the JAX package.
"""

from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.comm.modulation import detector, gray_mapping
from opticommpy_torch.ops.filtering import fir_filter, pulse_shape
from opticommpy_torch.ops.signal import decimate, pnorm, resample, symbol_sync, upsample
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["SyncConfig", "sync_data_sequences"]


@dataclass(frozen=True)
class SyncConfig:
    """Synchronization parameters (synchronization.py:66-74 defaults)."""

    SpS: int = 1
    reference: str = "signal"  # 'signal' | 'symbols'
    syncMode: str = "amp"  # 'amp' | 'real'
    pulseType: str = "rrc"
    rollOff: float = 0.01
    nFilterTaps: int = 1024
    constType: str = "pam"
    M: int = 4


def sync_data_sequences(rx, tx, config: SyncConfig = SyncConfig()):
    """Synchronize the transmitted reference to the received signal.

    Returns (tx_synced, symbols): the aligned reference waveform and its
    symbol sequence, extracted from the upsampled reference ('symbols':
    each column's nonzero samples, power-normalized and zero-padded to
    ``len // SpS + 1``) or detected again at 41 samples per symbol by the
    ML rule ('signal'). A tensor keeps its device; any other input goes to
    the CUDA device; ``tx`` follows ``rx``.
    """
    cfg = config
    rx = as_device_tensor(rx)
    tx = torch.as_tensor(tx).to(rx.device)
    squeeze = rx.ndim == 1
    if squeeze:
        rx = rx[:, None]
    if tx.ndim == 1:
        tx = tx[:, None]
    pulse = pulse_shape(cfg.pulseType, cfg.SpS, cfg.nFilterTaps, cfg.rollOff)

    if cfg.reference == "symbols":
        tx = upsample(tx, cfg.SpS)
    repeats = int(np.ceil(rx.shape[0] / tx.shape[0]))
    tx_t = tx.repeat(repeats, 1)
    pad_l = tx_t.shape[0] - rx.shape[0]
    if pad_l > 0:
        rx = torch.cat([rx, rx.new_zeros((pad_l, rx.shape[1]))])
    tx_s = symbol_sync(rx, tx_t, 1, mode=cfg.syncMode)
    tx_s = tx_s[: rx.shape[0] - max(pad_l, 0)]

    if cfg.reference == "symbols":
        n_symb = tx_s.shape[0] // cfg.SpS + 1
        cols = []
        for k in range(tx_s.shape[1]):
            col = tx_s[:, k]
            out = pnorm(col[torch.nonzero(col != 0)[:, 0]])
            padded = col.new_zeros(n_symb)
            padded[: out.shape[0]] = out
            cols.append(padded)
        symb = torch.stack(cols, dim=1)
        tx_s = pnorm(fir_filter(pulse, tx_s))
    else:
        fine_sps = 41
        x = resample(tx_s, cfg.SpS, fine_sps)
        n_symb = x.shape[0] // fine_sps
        symb = decimate(x[: n_symb * fine_sps], fine_sps, 1)
        const = pnorm(torch.as_tensor(gray_mapping(cfg.M, cfg.constType), device=rx.device))
        dec, _ = detector(pnorm(symb.reshape(-1)), 1e-4, const, rule="ML")
        symb = pnorm(dec.reshape(symb.shape))

    if squeeze:
        tx_s = tx_s[:, 0]
    return tx_s, symb
