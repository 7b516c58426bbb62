"""Static and adaptive equalization: EDC and the N x N MIMO adaptive equalizer.

Port of ``opticommpy_tpu/dsp/equalization.py``, part A:

- :func:`edc` — frequency-domain CD compensation (one FFT convolution, or
  overlap-save for very long signals or an explicit ``Nfft``).
- :func:`mimo_adapt_equalizer` — multi-stage training (per-stage rule and
  step, ``numIter`` pre-convergence passes of the first stage, taps and the
  RLS state Sd chained across stages) with the rules nlms, dd-lms, cma,
  rde, da-rde, rls and dd-rls. ``backend='scan'`` runs the JAX package's
  scan rules as a per-symbol loop; ``backend='pallas'`` runs each stage's
  recurrence on a Hopper kernel, one launch per pass: the gradient rules
  on K2 (:mod:`opticommpy_torch.kernels.mimo_eq`), rls and square-QAM
  dd-rls on K5 with one signal (:mod:`opticommpy_torch.kernels.rls`);
  dd-rls on another constellation runs the scan rule, as in the JAX package.
- :func:`mimo_adapt_equalizer_batch` — B signals' schedules at once: each
  kernel pass serves all B signals (gradient rules on K3, RLS on K5).
- :class:`MIMOEqualizer` — the trainer as a module with ``H`` and ``Sd``
  buffers.

Not ported yet (they raise ``NotImplementedError``): the static rule,
``runWL``, ``blockUpdate > 1`` and, in the single-signal trainer,
``storeCoeff`` (ROADMAP.md queue 1, item 8).
"""

from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.comm.modulation import gray_mapping
from opticommpy_torch.comm.sources import symbol_pmf
from opticommpy_torch.kernels import mimo_eq, rls
from opticommpy_torch.kernels.bps import _square_qam_levels
from opticommpy_torch.models.channels import fiber_coefficients
from opticommpy_torch.ops.filtering import overlap_save

__all__ = ["edc", "EDCConfig", "mimo_adapt_equalizer", "mimo_adapt_equalizer_batch",
           "MIMOEqualizerConfig", "MIMOEqualizer"]


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
    kernels; CPU tensors run their plain versions).
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
_RLS_ALGS = ("rls", "dd-rls")

# training-stage alg -> kernel rule ('dd-lms' is the kernel's 'lms' with
# n_train=0: decision-directed from the first symbol)
_KERNEL_ALG = {"nlms": "nlms", "dd-lms": "lms", "cma": "cma", "rde": "rde",
               "da-rde": "da-rde"}


def _unported(what):
    return NotImplementedError(
        f"mimo_adapt_equalizer: {what} is not ported yet (ROADMAP.md queue 1, "
        "item 8)")


def _check_config(config):
    if config.runWL:
        raise _unported("runWL (widely linear)")
    if config.blockUpdate > 1:
        raise _unported("blockUpdate > 1")
    if config.backend not in ("scan", "pallas"):
        raise ValueError(f"unknown backend {config.backend!r}")
    for alg in config.alg:
        if alg == "static":
            raise _unported("the static rule")
        if alg not in _KERNEL_STAGE_ALGS + _RLS_ALGS:
            raise ValueError(
                "Equalization algorithm not specified (or incorrectly specified).")


def _adapt_eq_stage_scan(stage_slice, ref_slice, H, Sd, const, r_cma, r_rde, mu,
                         lam, alg, sps, n_taps, length):
    """One training stage of one signal as a per-symbol loop with the scan rules.

    ``stage_slice``: the padded input rows of this stage; ``H``: (modes,
    modes, taps) taps H[out, in, :]; ``Sd``: (modes, taps, taps), the RLS
    state. Returns (y, H, Sd, err_sq).
    """
    outs, errs = [], []
    for ind in range(length):
        win = stage_slice[ind * sps:ind * sps + n_taps]  # (taps, modes)
        out = torch.sum(H * win.T[None, :, :], dim=(1, 2))
        if alg in ("nlms", "rls"):
            err = ref_slice[ind] - out
        elif alg in ("dd-lms", "dd-rls"):
            dec = const[torch.argmin(torch.abs(out[:, None] - const[None, :]) ** 2,
                                     dim=1)]
            err = dec - out
        elif alg == "cma":
            err = (r_cma - torch.abs(out) ** 2).to(H.dtype)
        elif alg == "rde":
            r_dec = r_rde[torch.argmin(torch.abs(r_rde[None, :]
                                                 - torch.abs(out)[:, None]), dim=1)]
            err = (r_dec**2 - torch.abs(out) ** 2).to(H.dtype)
        else:  # da-rde
            err = (torch.abs(ref_slice[ind]) ** 2 - torch.abs(out) ** 2).to(H.dtype)
        if alg in _RLS_ALGS:
            # per input mode: A = Sd conj(x), B = x^T Sd,
            # Sd' = (Sd - A B / (lam + x^T A)) / lam, Y = Sd' conj(x)
            x = win.T  # (modes, taps)
            xc = x.conj()[:, :, None]
            A = Sd @ xc
            B = x[:, None, :] @ Sd
            C = (x[:, None, :] @ A)[:, 0, 0]
            Sd = (Sd - (A @ B) / (lam + C)[:, None, None]) / lam
            H = H + err[:, None, None] * (Sd @ xc)[None, :, :, 0]
        else:
            if alg == "nlms":
                grad_err, grad_win = err, win / torch.sum(torch.abs(win) ** 2, dim=0)
            elif alg == "dd-lms":
                grad_err, grad_win = err, win
            else:  # cma, rde, da-rde
                grad_err, grad_win = err * out, win
            H = H + mu * (grad_err[:, None, None] * grad_win.T.conj()[None, :, :])
        outs.append(out)
        errs.append(torch.abs(err) ** 2)
    return torch.stack(outs), H, Sd, torch.stack(errs)


def _stage_err_sq(alg, y, ref, const, aux):
    """err_sq of a kernel stage, recomputed from its outputs with the scan
    rules' formulas."""
    if alg in ("nlms", "rls"):
        return torch.abs(ref - y) ** 2
    if alg in ("dd-lms", "dd-rls"):
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
                           n_taps, n_start, length, single):
    """One gradient-rule stage of B signals on a Hopper kernel, one launch
    per pass: K2 when ``single`` (B = 1), else K3.

    Windows come from the globally padded signals (B, rows, modes) at the
    scan stages' alignment, so taps chain exactly between stages. Returns
    (y (B, length, modes), H (B, o, i, t), err_sq).
    """
    n_batch, _, n_modes = sig_pad.shape
    kernel_alg = _KERNEL_ALG[alg]
    n_train = length if alg == "nlms" else 0
    aux = mimo_eq.stage_aux(kernel_alg, const_np)
    ref = symb_ref[:, n_start:n_start + length]
    h_flat = H.transpose(-1, -2).reshape(n_batch, n_modes, n_modes * n_taps)
    args = (const_np, aux, kernel_alg, mu, n_train, sps, n_taps, n_start, length)
    if single:
        y, h_flat = mimo_eq.mimo_eq_stage(sig_pad[0], ref[0], h_flat[0], *args)
        y, h_flat = y[None], h_flat[None]
    else:
        y, h_flat = mimo_eq.mimo_eq_stage_batch(sig_pad, ref, h_flat, *args)
    H_new = h_flat.reshape(n_batch, n_modes, n_taps, n_modes).transpose(-1, -2)
    const = torch.as_tensor(const_np, device=y.device)
    return y, H_new, _stage_err_sq(alg, y, ref, const, aux)


def _adapt_eq_stage_kernel_rls(sig_pad, symb_ref, H, Sd, const_np, lam, alg,
                               sps, n_taps, n_start, length):
    """One rls / dd-rls stage of B signals on K5, one launch per pass (port
    of ``_adapt_eq_stage_pallas_rls(_batch)``). Returns (y, H, Sd, err_sq)."""
    ref = symb_ref[:, n_start:n_start + length]
    y, H, Sd = rls.rls_stage_batch(sig_pad, ref, H, Sd, const_np, alg, lam, sps,
                                   n_taps, n_start, length)
    const = torch.as_tensor(const_np, device=y.device)
    return y, H, Sd, _stage_err_sq(alg, y, ref, const, None)


def _train(sig, config, symb_ref, H, Sd, single):
    """The multi-stage schedule for B signals (B, N, modes).

    ``single`` (B = 1) sends gradient-rule stages to K2 instead of K3.
    Returns (y (B, nSym_out, modes), H (B, o, i, t), Sd (B, i, t, t),
    err_sq (B, modes, nSym_out)).
    """
    dev = sig.device
    n_batch, n_samples, n_modes = sig.shape
    n_taps = config.nTaps
    sps = config.SpS
    l_pad = n_taps // 2
    # extra trailing zeros guarantee every stage slice holds full windows
    sig_pad = torch.zeros((n_batch, l_pad + n_samples + l_pad + sps + n_taps, n_modes),
                          dtype=torch.complex64, device=dev)
    sig_pad[:, l_pad:l_pad + n_samples] = sig

    const_np = gray_mapping(config.M, config.constType)
    px = symbol_pmf(config.M, config.constType,
                    "maxwell-boltzmann" if config.shapingFactor else "uniform",
                    config.shapingFactor)
    const_np = (const_np / np.sqrt(np.sum(np.abs(const_np) ** 2 * px))).astype(
        np.complex64)
    const = torch.as_tensor(const_np, device=dev)
    square = _square_qam_levels(const_np.real, const_np.imag) is not None

    total_symbols = int(np.fix((n_samples + 2 * l_pad - n_taps) / sps + 1))
    stage_lengths = config.L if config.L is not None else (total_symbols,)
    if any(l <= 0 for l in stage_lengths) or sum(stage_lengths) > total_symbols:
        raise ValueError(
            f"invalid stage lengths {tuple(stage_lengths)}: must be positive "
            f"and sum to at most {total_symbols} output symbols")
    algs = config.alg
    mus = config.mu
    if len(mus) == 1 and len(algs) > 1:
        mus = mus * len(algs)
    lam = float(config.lambdaRLS)

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
        # dd-rls needs the O(1) square-QAM slicer; data-aided rls has none
        use_kernel_rls = (config.backend == "pallas" and alg in _RLS_ALGS
                          and (alg == "rls" or square))
        stage_slice = sig_pad[:, n_start * sps:(n_start + length - 1) * sps + n_taps]
        ref_slice = symb_ref[:, n_start:n_start + length]
        for _ in range(n_iter):
            if use_kernel:
                sig_out, H, err_sq = _adapt_eq_stage_kernel(
                    sig_pad, symb_ref, H, const_np, float(mus[stage]), alg, sps,
                    n_taps, n_start, length, single)
            elif use_kernel_rls:
                sig_out, H, Sd, err_sq = _adapt_eq_stage_kernel_rls(
                    sig_pad, symb_ref, H, Sd, const_np, lam, alg, sps, n_taps,
                    n_start, length)
            else:
                per_signal = [_adapt_eq_stage_scan(
                    stage_slice[b], ref_slice[b], H[b], Sd[b], const, r_cma, r_rde,
                    float(mus[stage]), lam, alg, sps, n_taps, length)
                    for b in range(n_batch)]
                sig_out, H, Sd, err_sq = (torch.stack(t) for t in zip(*per_signal))
        outs.append(sig_out)
        errs.append(err_sq)
        n_start += length
    return (torch.cat(outs, dim=1), H, Sd,
            torch.cat(errs, dim=1).transpose(1, 2))


def _initial_state(n_batch, n_modes, n_taps, H, dev):
    """Taps (central spike unless given) and Sd (identity per mode)."""
    if H is None:
        H = torch.zeros((n_batch, n_modes, n_modes, n_taps), dtype=torch.complex64,
                        device=dev)
        H[:, torch.arange(n_modes), torch.arange(n_modes), n_taps // 2] = 1.0
    else:
        H = torch.as_tensor(H).to(dev, torch.complex64)
    Sd = torch.eye(n_taps, dtype=torch.complex64, device=dev).repeat(
        n_batch, n_modes, 1, 1)
    return H, Sd


def _mimo_adapt_equalizer(sig, config, symb_ref=None, H=None, H_=None, Sd=None):
    """The single-signal trainer with the RLS state in and out.

    Returns (sigOut, H, H_, errSq, Sd).
    """
    if config is None:
        config = MIMOEqualizerConfig()
    _check_config(config)
    if config.storeCoeff:
        raise _unported("storeCoeff")
    sig = torch.as_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    dev = sig.device
    symb_ref = sig if symb_ref is None else torch.as_tensor(symb_ref).to(dev)
    if symb_ref.ndim == 1:
        symb_ref = symb_ref[:, None]
    n_modes = sig.shape[1]
    H, Sd0 = _initial_state(1, n_modes, config.nTaps,
                            None if H is None else torch.as_tensor(H)[None], dev)
    Sd = Sd0 if Sd is None else torch.as_tensor(Sd).to(dev, torch.complex64)[None]
    if H_ is None:
        H_ = torch.zeros((n_modes, n_modes, config.nTaps), dtype=torch.complex64,
                         device=dev)
    y, H, Sd, err_sq = _train(sig[None], config, symb_ref.to(torch.complex64)[None],
                              H, Sd, single=True)
    y = y[0, :, 0] if squeeze else y[0]
    return y, H[0], H_, err_sq[0], Sd[0]


def mimo_adapt_equalizer(sig, config: MIMOEqualizerConfig = None, symb_ref=None,
                         H=None, H_=None, return_results=False):
    """N x N MIMO adaptive equalizer with multi-stage training.

    Parity with reference mimoAdaptEqualizer (equalization.py:125): central
    spike initialization, zero padding of nTaps//2 at both ends, per-stage
    algorithm list, pre-convergence passes of the first stage, the RLS
    state Sd (identity per mode at the start) chained like the taps.

    Returns the equalized symbols, or (sigOut, H, H_, errSq, Hiter) when
    ``return_results`` is True.
    """
    sig_out, H, H_, err_sq, _ = _mimo_adapt_equalizer(sig, config, symb_ref, H, H_)
    if return_results:
        return sig_out, H, H_, err_sq, H[None]
    return sig_out


def mimo_adapt_equalizer_batch(sig, config: MIMOEqualizerConfig = None,
                               symb_ref=None, H=None, return_results=False):
    """B signals' full multi-stage training schedules at once.

    Batched counterpart of :func:`mimo_adapt_equalizer` (port of the JAX
    function of the same name): ``sig`` is (B, N, modes), ``symb_ref`` (B,
    nSym, modes), ``H`` optional (B, modes, modes, nTaps). Every signal runs
    the same schedule independently. With ``backend='pallas'`` each
    gradient-rule pass is one K3 launch and each rls / square-QAM dd-rls
    pass one K5 launch for all B signals; other stages, and
    ``backend='scan'``, run the scan rule per signal. Per signal the
    result equals :func:`mimo_adapt_equalizer`'s.

    Returns the equalized symbols (B, nSym_out, modes), or (sigOut, H (B,
    o, i, t), errSq (B, modes, nSym_out)) when ``return_results`` is True.
    """
    if config is None:
        config = MIMOEqualizerConfig()
    if config.storeCoeff:
        raise ValueError(
            "storeCoeff is not supported by mimo_adapt_equalizer_batch "
            "(there is no per-symbol h_iter return in the batch API); use "
            "mimo_adapt_equalizer per signal to record coefficient history")
    _check_config(config)
    sig = torch.as_tensor(sig)
    if sig.ndim != 3:
        raise ValueError("mimo_adapt_equalizer_batch expects (B, N, modes)")
    dev = sig.device
    symb_ref = sig if symb_ref is None else torch.as_tensor(symb_ref).to(dev)
    H, Sd = _initial_state(sig.shape[0], sig.shape[2], config.nTaps, H, dev)
    y, H, _, err_sq = _train(sig, config, symb_ref.to(torch.complex64), H, Sd,
                             single=False)
    if return_results:
        return y, H, err_sq
    return y


class MIMOEqualizer(torch.nn.Module):
    """The adaptive equalizer with its taps ``H[out, in, taps]`` and RLS state
    ``Sd[in, taps, taps]`` as module state.

    Each call trains on one block with :func:`mimo_adapt_equalizer`,
    starting from the taps and Sd the previous call left (the central spike
    and the identity at first), and keeps the new ones in the ``H`` and
    ``Sd`` buffers, so a long record can be equalized block by block.
    """

    def __init__(self, config: MIMOEqualizerConfig, n_modes=2, device=None):
        super().__init__()
        self.config = config
        H, Sd = _initial_state(1, n_modes, config.nTaps, None, device)
        self.register_buffer("H", H[0])
        self.register_buffer("Sd", Sd[0])

    def forward(self, sig, symb_ref=None):
        y, H, _, _, Sd = _mimo_adapt_equalizer(sig, self.config, symb_ref=symb_ref,
                                               H=self.H, Sd=self.Sd)
        self.H, self.Sd = H, Sd
        return y
