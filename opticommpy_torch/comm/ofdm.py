"""OFDM modulation/demodulation with cyclic prefix and pilot equalization
(port of ``opticommpy_tpu/comm/ofdm.py``).

All frames are processed as one batched (nFrames, Nfft) IFFT/FFT on
``torch.fft``, and the pilot-based channel estimate is a closed-form linear
interpolation with linear extrapolation at both edges.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.ops.signal import _interp_extrap
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = [
    "OFDMConfig",
    "hermit",
    "zero_pad",
    "calc_symbol_rate",
    "modulate_ofdm",
    "demodulate_ofdm",
]


@dataclass(frozen=True)
class OFDMConfig:
    """OFDM parameters (reference ofdm.py:128-135 defaults)."""

    Nfft: int = 512
    G: int = 4  # cyclic prefix length
    hermitSymmetry: bool = False
    pilot: complex = 0.25 + 0.25j
    pilotCarriers: tuple = ()
    nullCarriers: tuple = ()
    SpS: int = 2


def hermit(v):
    """Arrange a length-L vector with Hermitian symmetry (ofdm.py:21).

    Output has length 2L+2: [0, v, 0, conj(v[::-1])]; its IFFT is real.
    """
    v = as_device_tensor(v)
    zero = torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    return torch.cat([zero, v, zero, torch.conj(torch.flip(v, (-1,)))], dim=-1)


def zero_pad(x, L):
    """Pad ``x`` with ``L`` zeros on both ends (reference ofdm.py:46)."""
    return torch.nn.functional.pad(as_device_tensor(x), (L, L))


def calc_symbol_rate(M, Rb, nfft, n_pilots, g, hermit_sym):
    """OFDM symbol rate for a bit rate Rb (ofdm.py:71)."""
    n_data = (nfft // 2 - 1 - n_pilots) if hermit_sym else (nfft - n_pilots)
    return Rb / (n_data / (nfft + g) * np.log2(M))


def _carrier_sets(cfg: OFDMConfig):
    ns = cfg.Nfft // 2 - 1 if cfg.hermitSymmetry else cfg.Nfft
    pilots = np.asarray(cfg.pilotCarriers, dtype=np.int64)
    nulls = np.asarray(cfg.nullCarriers, dtype=np.int64)
    data = np.setdiff1d(np.arange(ns), np.union1d(pilots, nulls))
    return ns, pilots, nulls, data


def modulate_ofdm(symb, config: OFDMConfig = OFDMConfig()):
    """OFDM modulator with CP and oversampling (reference ofdm.py:99).

    All frames are assembled and IFFT'd in one batched operation. A tensor
    keeps its device; any other input goes to the CUDA device. Complex64
    out, as in the JAX package.
    """
    cfg = config
    symb = as_device_tensor(symb)
    dev = symb.device
    ns, pilots, nulls, data = _carrier_sets(cfg)
    ni = ns - len(pilots) - len(nulls)
    n_symb = symb.shape[0]
    if n_symb % ni != 0:
        raise ValueError(
            f"Number of symbols ({n_symb}) is not divisible by number of data "
            f"carriers per OFDM frame ({ni})."
        )
    n_frames = n_symb // ni

    frames = torch.zeros((n_frames, ns), dtype=torch.complex64, device=dev)
    frames[:, torch.as_tensor(data, device=dev)] = symb.reshape(n_frames, ni).to(torch.complex64)
    if len(pilots):
        frames[:, torch.as_tensor(pilots, device=dev)] = complex(cfg.pilot)

    if cfg.hermitSymmetry:
        frames = hermit(frames)

    # zero-pad symmetrically to SpS*Nfft, centered spectrum -> ifftshift -> IFFT
    pad = (cfg.Nfft * (cfg.SpS - 1)) // 2
    frames = torch.nn.functional.pad(frames, (pad, pad))
    time_frames = torch.fft.ifft(torch.fft.fftshift(frames, dim=-1), dim=-1) \
        * math.sqrt(cfg.SpS * cfg.Nfft)

    # cyclic prefix
    if cfg.G > 0:
        cp = time_frames[:, -cfg.SpS * cfg.G:]
        time_frames = torch.cat([cp, time_frames], dim=-1)
    return time_frames.reshape(-1)


def demodulate_ofdm(sig, config: OFDMConfig = OFDMConfig(), return_channel=False):
    """OFDM demodulator with pilot channel estimation (reference ofdm.py:185).

    Input must be at one sample per symbol (CP + Nfft per frame). Channel
    magnitude/phase estimated at the pilot carriers is linearly interpolated
    (with edge extrapolation) over all carriers and averaged over frames. A
    tensor keeps its device; any other input goes to the CUDA device.
    """
    cfg = config
    sig = as_device_tensor(sig)
    if not sig.is_complex():
        sig = sig.to(torch.complex64)
    dev = sig.device
    ns, pilots, nulls, data = _carrier_sets(cfg)
    n = sig.shape[0]
    if n % (cfg.Nfft + cfg.G) != 0:
        raise ValueError(
            f"Number of received symbols ({n}) is not divisible by Nfft + G "
            f"({cfg.Nfft + cfg.G})."
        )
    n_frames = n // (cfg.Nfft + cfg.G)
    frames = sig.reshape(n_frames, cfg.Nfft + cfg.G)[:, cfg.G:]
    spec = torch.fft.fftshift(torch.fft.fft(frames, dim=-1), dim=-1) / math.sqrt(cfg.Nfft)

    if cfg.hermitSymmetry:
        spec = spec[:, 1:1 + ns]

    h_chan = None
    if len(pilots):
        h_est = spec[:, torch.as_tensor(pilots, device=dev)] / complex(cfg.pilot)
        h_abs = torch.mean(torch.abs(h_est), dim=0)
        h_pha = torch.mean(torch.angle(h_est), dim=0)
        carriers = torch.arange(ns, dtype=torch.float32, device=dev)
        xp = torch.as_tensor(pilots, dtype=torch.float32, device=dev)
        h_abs_i = _interp_extrap(carriers, xp, h_abs)
        h_pha_i = _interp_extrap(carriers, xp, h_pha)
        h_chan = h_abs_i * torch.exp(1j * h_pha_i)
        spec = spec / h_chan[None, :]

    out = spec[:, torch.as_tensor(data, device=dev)].reshape(-1)
    if return_channel:
        return out, h_chan
    return out

