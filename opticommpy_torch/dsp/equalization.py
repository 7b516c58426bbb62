"""Static and adaptive equalization: EDC and the N x N MIMO adaptive equalizer.

Port of ``opticommpy_tpu/dsp/equalization.py``, part A:

- :func:`edc` — frequency-domain CD compensation (one FFT convolution, or
  overlap-save for very long signals or an explicit ``Nfft``).
- :func:`mimo_adapt_equalizer` — multi-stage training (per-stage rule and
  step, ``numIter`` pre-convergence passes of the first stage, taps chained
  across stages). ``backend='scan'`` runs the JAX package's scan rules as a
  per-symbol loop; ``backend='pallas'`` runs every stage's recurrence on the
  Hopper kernel (:mod:`opticommpy_torch.kernels.mimo_eq`), one launch per
  pass.

Not ported yet (they raise ``NotImplementedError``): the rls and dd-rls
rules, ``runWL``, ``storeCoeff`` and ``blockUpdate > 1`` (ROADMAP.md queue 1,
item 8).
"""

from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.comm.modulation import gray_mapping
from opticommpy_torch.comm.sources import symbol_pmf
from opticommpy_torch.kernels import mimo_eq
from opticommpy_torch.models.channels import fiber_coefficients
from opticommpy_torch.ops.filtering import overlap_save

__all__ = ["edc", "EDCConfig", "mimo_adapt_equalizer", "MIMOEqualizerConfig",
           "MIMOEqualizer"]


@dataclass(frozen=True)
class EDCConfig:
    """Chromatic-dispersion compensation parameters (equalization.py:36)."""

    L: float = 50.0  # [km]
    D: float = 16.0  # [ps/nm/km]
    Fc: float = 193.1e12
    Fs: float = None
    Rs: float = 32e9
    NfilterCoeffs: int = None
    Nfft: int = None


def edc(sig, config: EDCConfig):
    """Electronic chromatic dispersion compensation (reference equalization.py:36).

    The inverse CD response ``H = exp(-j*b2/2*w^2*L)`` on an auto-sized tap
    grid (Savory's rule), applied by one FFT convolution over all modes.
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    sig = torch.as_tensor(sig)
    _, beta2 = fiber_coefficients(0.0, config.D, config.Fc)
    n_coeffs = config.NfilterCoeffs
    if n_coeffs is None:
        n_coeffs = int(2 * np.ceil(6.67 * np.abs(beta2) * config.L * config.Rs**2
                                   * (config.Fs / config.Rs)))
    nfft = config.Nfft
    if nfft is None:
        nfft = min(max(8 * 2 ** int(np.ceil(np.log2(n_coeffs))), 16384),
                   2 ** int(np.ceil(np.log2(sig.shape[0] + n_coeffs))))
    w = 2 * np.pi * config.Fs * np.fft.fftfreq(n_coeffs)
    H = torch.as_tensor(np.exp(-1j * (beta2 / 2) * (w**2) * config.L)
                        .astype(np.complex64), device=sig.device)
    if config.Nfft is None and sig.shape[0] + n_coeffs <= 2**22:
        squeeze = sig.ndim == 1
        x = sig[:, None] if squeeze else sig
        n = x.shape[0]
        d_delay = n_coeffs // 2
        big = 1 << int(np.ceil(np.log2(n + n_coeffs)))
        Hf = torch.fft.fft(torch.fft.fftshift(torch.fft.ifft(H)), n=big)
        y = torch.fft.ifft(torch.fft.fft(x.to(torch.complex64).T, n=big, dim=-1)
                           * Hf, dim=-1)
        out = y[:, d_delay:d_delay + n].T
        return out[:, 0] if squeeze else out
    return overlap_save(sig, H, nfft=nfft, freq_domain_filter=True)


@dataclass(frozen=True)
class MIMOEqualizerConfig:
    """MIMO adaptive equalizer parameters (equalization.py:125 defaults).

    ``alg``/``mu``/``L`` are per-training-stage tuples; stage i runs
    algorithm alg[i] with step mu[i] for L[i] output symbols. ``backend``
    is 'scan' (the per-symbol reference rules) or 'pallas' (the Hopper
    kernel; CPU tensors run its plain version).
    """

    numIter: int = 1
    nTaps: int = 15
    mu: tuple = (1e-3,)
    lambdaRLS: float = 0.99
    SpS: int = 2
    L: tuple = None  # per-stage lengths; None = single stage over everything
    storeCoeff: bool = False
    runWL: bool = False
    alg: tuple = ("nlms",)
    constType: str = "qam"
    M: int = 4
    shapingFactor: float = 0.0
    blockUpdate: int = 1
    backend: str = "scan"


_KERNEL_STAGE_ALGS = ("nlms", "dd-lms", "cma", "rde", "da-rde")

# training-stage alg -> kernel rule ('dd-lms' is the kernel's 'lms' with
# n_train=0: decision-directed from the first symbol)
_KERNEL_ALG = {"nlms": "nlms", "dd-lms": "lms", "cma": "cma", "rde": "rde",
               "da-rde": "da-rde"}


def _unported(what):
    return NotImplementedError(
        f"mimo_adapt_equalizer: {what} is not ported yet (ROADMAP.md queue 1, "
        "item 8; the RLS kernel is queue 2, item 3)")


def _adapt_eq_stage_scan(stage_slice, ref_slice, H, const, r_cma, r_rde, mu,
                         alg, sps, n_taps, length):
    """One training stage as a per-symbol loop with the scan rules.

    ``stage_slice``: the padded input rows of this stage; ``H``: (modes,
    modes, taps) taps H[out, in, :]. Returns (y, H, err_sq).
    """
    outs, errs = [], []
    for ind in range(length):
        win = stage_slice[ind * sps:ind * sps + n_taps]  # (taps, modes)
        out = torch.sum(H * win.T[None, :, :], dim=(1, 2))
        if alg == "nlms":
            err = ref_slice[ind] - out
            norm2 = torch.sum(torch.abs(win) ** 2, dim=0)
            grad_err, grad_win = err, win / norm2[None, :]
        elif alg == "dd-lms":
            dec = const[torch.argmin(torch.abs(out[:, None] - const[None, :]) ** 2,
                                     dim=1)]
            err = dec - out
            grad_err, grad_win = err, win
        elif alg == "cma":
            err = (r_cma - torch.abs(out) ** 2).to(H.dtype)
            grad_err, grad_win = err * out, win
        elif alg == "rde":
            r_dec = r_rde[torch.argmin(torch.abs(r_rde[None, :]
                                                 - torch.abs(out)[:, None]), dim=1)]
            err = (r_dec**2 - torch.abs(out) ** 2).to(H.dtype)
            grad_err, grad_win = err * out, win
        else:  # da-rde
            err = (torch.abs(ref_slice[ind]) ** 2 - torch.abs(out) ** 2).to(H.dtype)
            grad_err, grad_win = err * out, win
        H = H + mu * (grad_err[:, None, None] * grad_win.T.conj()[None, :, :])
        outs.append(out)
        errs.append(torch.abs(err) ** 2)
    return torch.stack(outs), H, torch.stack(errs)


def _stage_err_sq(alg, y, ref, const, aux):
    """err_sq of a kernel stage, recomputed from its outputs with the scan
    rules' formulas."""
    if alg == "nlms":
        return torch.abs(ref - y) ** 2
    if alg == "dd-lms":
        dec = const[torch.argmin(torch.abs(y[..., None] - const) ** 2, dim=-1)]
        return torch.abs(dec - y) ** 2
    if alg == "cma":
        return (float(aux[0]) - torch.abs(y) ** 2) ** 2
    if alg == "rde":
        radii = torch.as_tensor(aux, device=y.device)
        r = torch.abs(y)
        r_dec = radii[torch.argmin(torch.abs(r[..., None] - radii), dim=-1)]
        return (r_dec**2 - r**2) ** 2
    return (torch.abs(ref) ** 2 - torch.abs(y) ** 2) ** 2  # da-rde


def _adapt_eq_stage_kernel(sig_pad, symb_ref, H, const_np, mu, alg, sps,
                           n_taps, n_start, length):
    """One training stage on the Hopper kernel (one launch per pass).

    Windows come from the globally padded signal at the scan stages'
    alignment, so taps chain exactly between stages. Returns (y, H, err_sq).
    """
    n_modes = sig_pad.shape[1]
    width = n_modes * n_taps
    kernel_alg = _KERNEL_ALG[alg]
    n_train = length if alg == "nlms" else 0
    aux = mimo_eq.stage_aux(kernel_alg, const_np)
    ref = symb_ref[n_start:n_start + length]
    h_flat = H.permute(0, 2, 1).reshape(n_modes, width)
    y, h_flat = mimo_eq.mimo_eq_stage(sig_pad, ref, h_flat, const_np, aux,
                                      kernel_alg, mu, n_train, sps, n_taps,
                                      n_start, length)
    H_new = h_flat.reshape(n_modes, n_taps, n_modes).permute(0, 2, 1)
    const = torch.as_tensor(const_np, device=y.device)
    return y, H_new, _stage_err_sq(alg, y, ref, const, aux)


def mimo_adapt_equalizer(sig, config: MIMOEqualizerConfig = None, symb_ref=None,
                         H=None, H_=None, return_results=False):
    """N x N MIMO adaptive equalizer with multi-stage training.

    Parity with reference mimoAdaptEqualizer (equalization.py:125): central
    spike initialization, zero padding of nTaps//2 at both ends, per-stage
    algorithm list, pre-convergence passes of the first stage.

    Returns the equalized symbols, or (sigOut, H, H_, errSq, Hiter) when
    ``return_results`` is True.
    """
    if config is None:
        config = MIMOEqualizerConfig()
    if config.runWL:
        raise _unported("runWL (widely linear)")
    if config.storeCoeff:
        raise _unported("storeCoeff")
    if config.blockUpdate > 1:
        raise _unported("blockUpdate > 1")
    if config.backend not in ("scan", "pallas"):
        raise ValueError(f"unknown backend {config.backend!r}")
    for alg in config.alg:
        if alg in ("rls", "dd-rls", "static"):
            raise _unported(f"the {alg} rule")
        if alg not in _KERNEL_STAGE_ALGS:
            raise ValueError(
                "Equalization algorithm not specified (or incorrectly specified).")
    sig = torch.as_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    dev = sig.device
    symb_ref = sig if symb_ref is None else torch.as_tensor(symb_ref).to(dev)
    if symb_ref.ndim == 1:
        symb_ref = symb_ref[:, None]
    symb_ref = symb_ref.to(torch.complex64)

    n_modes = sig.shape[1]
    n_taps = config.nTaps
    sps = config.SpS
    l_pad = n_taps // 2
    # extra trailing zeros guarantee every stage slice holds full windows
    sig_pad = torch.zeros((l_pad + sig.shape[0] + l_pad + sps + n_taps, n_modes),
                          dtype=torch.complex64, device=dev)
    sig_pad[l_pad:l_pad + sig.shape[0]] = sig

    const_np = gray_mapping(config.M, config.constType)
    px = symbol_pmf(config.M, config.constType,
                    "maxwell-boltzmann" if config.shapingFactor else "uniform",
                    config.shapingFactor)
    const_np = (const_np / np.sqrt(np.sum(np.abs(const_np) ** 2 * px))).astype(
        np.complex64)
    const = torch.as_tensor(const_np, device=dev)

    total_symbols = int(np.fix((sig.shape[0] + 2 * l_pad - n_taps) / sps + 1))
    stage_lengths = config.L if config.L is not None else (total_symbols,)
    if any(l <= 0 for l in stage_lengths) or sum(stage_lengths) > total_symbols:
        raise ValueError(
            f"invalid stage lengths {tuple(stage_lengths)}: must be positive "
            f"and sum to at most {total_symbols} output symbols")
    algs = config.alg
    mus = config.mu
    if len(mus) == 1 and len(algs) > 1:
        mus = mus * len(algs)

    if H is None:
        H = torch.zeros((n_modes, n_modes, n_taps), dtype=torch.complex64,
                        device=dev)
        H[torch.arange(n_modes), torch.arange(n_modes), n_taps // 2] = 1.0
    else:
        H = torch.as_tensor(H).to(dev, torch.complex64)
    if H_ is None:
        H_ = torch.zeros((n_modes, n_modes, n_taps), dtype=torch.complex64,
                         device=dev)

    r_cma = float(np.float32(np.mean(np.abs(const_np) ** 4)
                             / np.mean(np.abs(const_np) ** 2)))
    r_rde = torch.as_tensor(np.unique(np.abs(const_np)).astype(np.float32),
                            device=dev)

    outs, errs = [], []
    n_start = 0
    for stage, alg in enumerate(algs):
        length = int(stage_lengths[stage])
        n_iter = config.numIter if stage == 0 else 1
        use_kernel = config.backend == "pallas" and alg in _KERNEL_STAGE_ALGS
        stage_slice = sig_pad[n_start * sps:(n_start + length - 1) * sps + n_taps]
        ref_slice = symb_ref[n_start:n_start + length]
        for _ in range(n_iter):
            if use_kernel:
                sig_out, H, err_sq = _adapt_eq_stage_kernel(
                    sig_pad, symb_ref, H, const_np, float(mus[stage]), alg, sps,
                    n_taps, n_start, length)
            else:
                sig_out, H, err_sq = _adapt_eq_stage_scan(
                    stage_slice, ref_slice, H, const, r_cma, r_rde,
                    float(mus[stage]), alg, sps, n_taps, length)
        outs.append(sig_out)
        errs.append(err_sq)
        n_start += length

    sig_out = torch.cat(outs, dim=0)
    err_sq = torch.cat(errs, dim=0).T
    if squeeze:
        sig_out = sig_out[:, 0]
    if return_results:
        return sig_out, H, H_, err_sq, H[None]
    return sig_out


class MIMOEqualizer(torch.nn.Module):
    """The adaptive equalizer with its taps ``H[out, in, taps]`` as module state.

    Each call trains on one block with :func:`mimo_adapt_equalizer`,
    starting from the taps the previous call left (the central spike at
    first), and keeps the new taps in the ``H`` buffer, so a long record can
    be equalized block by block.
    """

    def __init__(self, config: MIMOEqualizerConfig, n_modes=2, device=None):
        super().__init__()
        self.config = config
        H = torch.zeros((n_modes, n_modes, config.nTaps), dtype=torch.complex64,
                        device=device)
        H[torch.arange(n_modes), torch.arange(n_modes), config.nTaps // 2] = 1.0
        self.register_buffer("H", H)

    def forward(self, sig, symb_ref=None):
        y, H, _, _, _ = mimo_adapt_equalizer(sig, self.config, symb_ref=symb_ref,
                                             H=self.H, return_results=True)
        self.H = H
        return y
