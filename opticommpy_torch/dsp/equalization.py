"""Static and adaptive equalization: EDC, Manakov digital backpropagation,
the N x N MIMO adaptive equalizer and the SISO DFE / FFE / Volterra
equalizers.

Port of ``opticommpy_tpu/dsp/equalization.py``, part A:

- :func:`edc` — frequency-domain CD compensation (one FFT convolution, or
  overlap-save for very long signals or an explicit ``Nfft``).
- :func:`manakov_dbp` — digital backpropagation: the Manakov span of
  :mod:`opticommpy_torch.models.channels` run with inverted signs.
- :func:`mimo_adapt_equalizer` — multi-stage training (per-stage rule and
  step, ``numIter`` pre-convergence passes of the first stage, taps, the
  widely linear taps ``H_`` and the RLS state Sd chained across stages)
  with the rules nlms, dd-lms, cma, rde, da-rde, rls, dd-rls and static.
  ``backend='scan'`` runs the JAX package's scan rules as a per-symbol
  loop; ``backend='pallas'`` runs each stage's recurrence on a Hopper
  kernel, one launch per pass: the gradient rules on K2
  (:mod:`opticommpy_torch.kernels.mimo_eq`), rls and square-QAM dd-rls on
  K5 with one signal (:mod:`opticommpy_torch.kernels.rls`). As in the JAX
  package, dd-rls on another constellation, ``runWL`` (the widely linear
  bank ``H_`` on ``conj(win)``) and ``storeCoeff`` (the taps after every
  symbol) take the scan rule, and ``blockUpdate = K > 1`` the blocked rule
  (taps frozen within K-symbol blocks, one batched contraction per block,
  the per-symbol rule on the remainder after the last whole block).
- :func:`mimo_adapt_equalizer_batch` — B signals' schedules at once: each
  kernel pass serves all B signals (gradient rules on K3, RLS on K5), and
  each block of a blocked stage is one set of ops for all B signals.
- :class:`MIMOEqualizer` — the trainer as a module with ``H``, ``H_`` and
  ``Sd`` buffers.
- :func:`mimo_apply` — frozen taps applied as one frequency-domain filter
  bank (the result of the ``static`` rule), and :func:`mimo_apply_fused`,
  which folds a matched filter, CD compensation and the power
  normalization into the same filter.

Part B (``equalization.py:1165-1395``): :func:`ffe`, :func:`dfe` and
:func:`volterra`, the decision-directed LMS equalizers of the IM-DD
receiver, as per-symbol loops with the JAX scans' rules (an argmin slicer;
``conj(win)`` in the gradient only for a complex constellation). They run
the kernels' plain versions (:mod:`opticommpy_torch.kernels.dfe`,
:mod:`opticommpy_torch.kernels.volterra`) on any device and never launch
a kernel, as the JAX functions run their scans; the kernels' entries are
``dfe_kernel``, ``ffe_kernel`` and ``volterra_kernel``.
"""

import functools
from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.comm.modulation import gray_mapping
from opticommpy_torch.comm.sources import symbol_pmf
from opticommpy_torch.kernels import dfe as dfe_k
from opticommpy_torch.kernels import mimo_eq, rls
from opticommpy_torch.kernels import volterra as volterra_k
from opticommpy_torch.kernels.bps import _square_qam_levels
from opticommpy_torch.models.channels import _manakov_span, _to_columns, fiber_coefficients
from opticommpy_torch.models.config import SSFMConfig
from opticommpy_torch.ops.filtering import overlap_save
from opticommpy_torch.ops.signal import fftfreq
from opticommpy_torch.utils.profiling import count
from opticommpy_torch.utils.rng import as_device_tensor, default_device

__all__ = ["edc", "EDCConfig", "manakov_dbp", "mimo_adapt_equalizer", "mimo_adapt_equalizer_batch",
           "MIMOEqualizerConfig", "MIMOEqualizer", "mimo_apply", "mimo_apply_fused",
           "DFEConfig", "FFEConfig", "VolterraConfig", "dfe", "ffe", "volterra"]


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


def _edc_response(config):
    """The inverse CD response ``exp(-j*b2/2*w^2*L)`` (NumPy complex128) on
    the auto-sized tap grid (Savory's rule) unless ``NfilterCoeffs`` is set."""
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    _, beta2 = fiber_coefficients(0.0, config.D, config.Fc)
    n_coeffs = config.NfilterCoeffs
    if n_coeffs is None:
        n_coeffs = int(2 * np.ceil(6.67 * np.abs(beta2) * config.L * config.Rs**2
                                   * (config.Fs / config.Rs)))
    w = 2 * np.pi * config.Fs * np.fft.fftfreq(n_coeffs)
    return np.exp(-1j * (beta2 / 2) * (w**2) * config.L)


def edc(sig, config: EDCConfig):
    """Electronic chromatic dispersion compensation (reference equalization.py:36).

    The inverse CD response ``H = exp(-j*b2/2*w^2*L)`` on an auto-sized tap
    grid (Savory's rule), applied by one FFT convolution over all modes.
    """
    sig = as_device_tensor(sig)
    Hcd = _edc_response(config)
    n_coeffs = Hcd.shape[0]
    nfft = config.Nfft
    if nfft is None:
        nfft = min(max(8 * 2 ** int(np.ceil(np.log2(n_coeffs))), 16384),
                   2 ** int(np.ceil(np.log2(sig.shape[0] + n_coeffs))))
    H = torch.as_tensor(Hcd.astype(np.complex64), device=sig.device)
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


def manakov_dbp(e_in, config: SSFMConfig):
    """Manakov-equation digital backpropagation (reference
    equalization.py:976).

    The forward Manakov span with inverted signs: per span, first undo the
    amplifier gain (``exp(-alpha/2*Lspan)``, for amp 'edfa' or 'ideal'),
    then back-propagate with ``+alpha/2 - j*beta2/2*w^2`` and the nonlinear
    rotation negated. Always complex64, whatever ``config.prec`` says, as
    in the JAX package. ``e_in`` is (N, 2*k), columns alternating x/y; a
    tensor keeps its device, any other input goes to the CUDA device. Under
    a profiler it counts ``dbp.calls``, ``dbp.steps``, ``dbp.trap_iters``
    and ``dbp.host_syncs`` (the channel's ``ssfm.*``, models/channels.py).
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    count("dbp.calls", 1)
    e_in = as_device_tensor(e_in).to(torch.complex64)
    n = e_in.shape[0]
    e = torch.stack([e_in[:, 0::2].T, e_in[:, 1::2].T]).contiguous()
    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    w = (2 * np.pi * config.Fs) * fftfreq(n, 1.0, torch.float32, e.device)
    lin_arg = torch.complex(torch.full_like(w, alpha / 2), -((beta2 / 2) * (w * w)))
    # the gain undone in float32, as jnp.exp of the weakly typed exponent
    loss = float(np.exp(np.float32(-alpha / 2 * config.Lspan)))
    for _ in range(n_spans):
        if config.amp in ("edfa", "ideal"):
            e = e * loss
        e = _manakov_span(e, lin_arg, config.Lspan, config, nl_sign=-1.0, counters="dbp")
    return _to_columns(e)


_KERNEL_STAGE_ALGS = ("nlms", "dd-lms", "cma", "rde", "da-rde")
_RLS_ALGS = ("rls", "dd-rls")

# training-stage alg -> kernel rule ('dd-lms' is the kernel's 'lms' with
# n_train=0: decision-directed from the first symbol)
_KERNEL_ALG = {"nlms": "nlms", "dd-lms": "lms", "cma": "cma", "rde": "rde",
               "da-rde": "da-rde"}


def _check_config(config):
    if config.backend not in ("scan", "pallas"):
        raise ValueError(f"unknown backend {config.backend!r}")


def _adapt_eq_stage_scan(stage_slice, ref_slice, H, Sd, const, r_cma, r_rde, mu, lam,
                         alg, sps, n_taps, length, H_=None, run_wl=False,
                         store_coeff=False):
    """One training stage of one signal as a per-symbol loop with the scan
    rules (port of ``_adapt_eq_stage``).

    ``stage_slice``: the padded input rows of this stage; ``H``: (modes,
    modes, taps) taps H[out, in, :]; ``H_``: the widely linear taps on
    ``conj(win)``, used and updated by the gradient rules under ``run_wl``;
    ``Sd``: (modes, taps, taps), the RLS state. Returns (y, H, H_, Sd,
    err_sq, h_iter): ``h_iter`` is the taps after every symbol (length,
    o, i, t) under ``store_coeff``, else the last taps (1, o, i, t).
    """
    if alg not in _KERNEL_STAGE_ALGS + _RLS_ALGS + ("static",):
        raise ValueError("Equalization algorithm not specified (or incorrectly specified).")
    outs, errs, h_iter = [], [], []
    for ind in range(length):
        win = stage_slice[ind * sps:ind * sps + n_taps]  # (taps, modes)
        out = torch.sum(H * win.T[None, :, :], dim=(1, 2))
        if run_wl:
            out = out + torch.sum(H_ * win.T.conj()[None, :, :], dim=(1, 2))
        if alg in ("nlms", "rls", "static"):
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
        elif alg != "static":  # the static rule keeps its taps
            if alg == "nlms":
                grad_err, grad_win = err, win / torch.sum(torch.abs(win) ** 2, dim=0)
            elif alg == "dd-lms":
                grad_err, grad_win = err, win
            else:  # cma, rde, da-rde
                grad_err, grad_win = err * out, win
            H = H + mu * (grad_err[:, None, None] * grad_win.T.conj()[None, :, :])
            if run_wl:
                H_ = H_ + mu * (grad_err[:, None, None] * grad_win.T[None, :, :])
        outs.append(out)
        errs.append(torch.abs(err) ** 2)
        if store_coeff:
            h_iter.append(H)
    h_iter = torch.stack(h_iter) if store_coeff else H[None]
    return torch.stack(outs), H, H_, Sd, torch.stack(errs), h_iter


def _adapt_eq_stage_blocked(stage_slice, ref_slice, H, H_, const, r_cma, r_rde, mu,
                            alg, sps, n_taps, length, run_wl, k_block):
    """Blocked training stage of B signals (port of ``_adapt_eq_stage_blocked``).

    The taps are frozen within each K-symbol block: the K outputs of a
    block come from one contraction over (taps, modes), and the
    gradient accumulated over the block is applied once (mini-batch LMS).
    ``stage_slice`` (B, rows, modes), ``ref_slice`` (B, length, modes),
    ``H`` and ``H_`` (B, o, i, t); ``length`` is a multiple of K. Every
    op of a block serves all B signals. The contractions are explicit
    complex products and sums in float32 (no matmul, so never TF32): they
    mix taps and modes. Returns (y (B, length, modes), H, H_, err_sq (B,
    length, modes)).
    """
    if alg not in ("nlms", "cma", "dd-lms", "rde", "da-rde", "static"):
        raise ValueError(f"blockUpdate > 1 is not supported for algorithm '{alg}'")
    n_blocks = length // k_block
    # (B, length, modes, taps): wins[b, k, i, t] = stage_slice[b, k*sps + t, i]
    wins_all = stage_slice.unfold(1, n_taps, sps)[:, :length]
    outs, errs = [], []
    for blk in range(n_blocks):
        wins = wins_all[:, blk * k_block:(blk + 1) * k_block]  # (B, K, i, t)
        refs = ref_slice[:, blk * k_block:(blk + 1) * k_block]  # (B, K, o)
        out = torch.sum(H[:, None] * wins[:, :, None], dim=(-2, -1))  # (B, K, o)
        if run_wl:
            out = out + torch.sum(H_[:, None] * wins.conj()[:, :, None], dim=(-2, -1))
        wins_g = wins
        if alg == "nlms":
            err = refs - out
            wins_g = wins / torch.sum(torch.abs(wins) ** 2, dim=-1, keepdim=True)
            eff = err
        elif alg == "cma":
            err = r_cma - torch.abs(out) ** 2
            eff = err.to(H.dtype) * out
        elif alg == "dd-lms":
            dec = const[torch.argmin(torch.abs(out[..., None] - const) ** 2, dim=-1)]
            err = dec - out
            eff = err
        elif alg == "rde":
            r_dec = r_rde[torch.argmin(torch.abs(r_rde - torch.abs(out)[..., None]), dim=-1)]
            err = (r_dec**2 - torch.abs(out) ** 2).to(H.dtype)
            eff = err * out
        elif alg == "da-rde":
            err = (torch.abs(refs) ** 2 - torch.abs(out) ** 2).to(H.dtype)
            eff = err * out
        else:  # static
            err = refs - out
            eff = torch.zeros_like(out)
        # grad[b, o, i, t] = sum_k eff[b, k, o] conj(wins_g[b, k, i, t])
        eff5 = eff[:, :, :, None, None]
        H = H + mu * torch.sum(eff5 * wins_g.conj()[:, :, None], dim=1)
        if run_wl:
            H_ = H_ + mu * torch.sum(eff5 * wins_g[:, :, None], dim=1)
        outs.append(out)
        errs.append(torch.abs(err) ** 2)
    return torch.cat(outs, dim=1), H, H_, torch.cat(errs, dim=1)


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


def _train(sig, config, symb_ref, H, H_, Sd, single):
    """The multi-stage schedule for B signals (B, N, modes).

    ``single`` (B = 1) sends gradient-rule stages to K2 instead of K3.
    Each stage takes the JAX package's route: a kernel pass (neither
    ``runWL`` nor ``storeCoeff``; gradient rules only at ``blockUpdate``
    1), else the blocked rule (``blockUpdate`` K > 1, not rls / dd-rls,
    not ``storeCoeff``, at least K symbols) and the per-symbol rule on the
    remainder, else the per-symbol rule. Returns (y (B, nSym_out, modes),
    H (B, o, i, t), H_ (B, o, i, t), Sd (B, i, t, t), err_sq (B, modes,
    nSym_out), h_iter): under ``storeCoeff`` ``h_iter`` is the stages'
    tap histories concatenated, (B, nSym_out, o, i, t), each stage's from
    its last pass; else None.
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

    run_wl, store = config.runWL, config.storeCoeff
    k_block = config.blockUpdate

    def scan(stage_slice, ref_slice, H, H_, Sd, mu, alg, length, store_coeff):
        per_signal = [_adapt_eq_stage_scan(
            stage_slice[b], ref_slice[b], H[b], Sd[b], const, r_cma, r_rde, mu, lam,
            alg, sps, n_taps, length, H_[b], run_wl, store_coeff)
            for b in range(n_batch)]
        return tuple(torch.stack(t) for t in zip(*per_signal))

    outs, errs, h_iters = [], [], []
    n_start = 0
    for stage, alg in enumerate(algs):
        length = int(stage_lengths[stage])
        n_iter = config.numIter if stage == 0 else 1
        mu = float(mus[stage])
        gates_ok = config.backend == "pallas" and not run_wl and not store
        use_kernel = gates_ok and alg in _KERNEL_STAGE_ALGS and k_block == 1
        # dd-rls needs the O(1) square-QAM slicer; data-aided rls has none
        use_kernel_rls = gates_ok and alg in _RLS_ALGS and (alg == "rls" or square)
        use_blocked = (k_block > 1 and alg not in _RLS_ALGS and not store
                       and length >= k_block)
        stage_slice = sig_pad[:, n_start * sps:(n_start + length - 1) * sps + n_taps]
        ref_slice = symb_ref[:, n_start:n_start + length]
        h_iter = None
        for _ in range(n_iter):
            if use_kernel:
                sig_out, H, err_sq = _adapt_eq_stage_kernel(
                    sig_pad, symb_ref, H, const_np, mu, alg, sps, n_taps, n_start,
                    length, single)
            elif use_kernel_rls:
                sig_out, H, Sd, err_sq = _adapt_eq_stage_kernel_rls(
                    sig_pad, symb_ref, H, Sd, const_np, lam, alg, sps, n_taps,
                    n_start, length)
            elif use_blocked:
                n_main = (length // k_block) * k_block
                sig_out, H, H_, err_sq = _adapt_eq_stage_blocked(
                    stage_slice, ref_slice, H, H_, const, r_cma, r_rde, mu, alg, sps,
                    n_taps, n_main, run_wl, k_block)
                if n_main < length:  # the per-symbol remainder
                    so2, H, H_, Sd, es2, _ = scan(
                        stage_slice[:, n_main * sps:], ref_slice[:, n_main:], H, H_,
                        Sd, mu, alg, length - n_main, False)
                    sig_out = torch.cat([sig_out, so2], dim=1)
                    err_sq = torch.cat([err_sq, es2], dim=1)
            else:
                sig_out, H, H_, Sd, err_sq, h_iter = scan(
                    stage_slice, ref_slice, H, H_, Sd, mu, alg, length, store)
        outs.append(sig_out)
        errs.append(err_sq)
        h_iters.append(h_iter)
        n_start += length
    h_iter = torch.cat(h_iters, dim=1) if store else None
    return (torch.cat(outs, dim=1), H, H_, Sd,
            torch.cat(errs, dim=1).transpose(1, 2), h_iter)


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

    Returns (sigOut, H, H_, errSq, Sd, Hiter).
    """
    if config is None:
        config = MIMOEqualizerConfig()
    _check_config(config)
    sig = as_device_tensor(sig)
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
        H_ = torch.zeros_like(H)
    else:
        H_ = torch.as_tensor(H_).to(dev, torch.complex64)[None]
    y, H, H_, Sd, err_sq, h_iter = _train(
        sig[None], config, symb_ref.to(torch.complex64)[None], H, H_, Sd, single=True)
    y = y[0, :, 0] if squeeze else y[0]
    h_iter = H if h_iter is None else h_iter[0]
    return y, H[0], H_[0], err_sq[0], Sd[0], h_iter


def mimo_adapt_equalizer(sig, config: MIMOEqualizerConfig = None, symb_ref=None,
                         H=None, H_=None, return_results=False):
    """N x N MIMO adaptive equalizer with multi-stage training.

    Parity with reference mimoAdaptEqualizer (equalization.py:125): central
    spike initialization, zero padding of nTaps//2 at both ends, per-stage
    algorithm list, pre-convergence passes of the first stage, the RLS
    state Sd (identity per mode at the start) chained like the taps, the
    widely linear mode (``runWL``: taps ``H_`` on ``conj(win)``, zero at the
    start unless given) and coefficient storage (``storeCoeff``).

    Returns the equalized symbols, or (sigOut, H, H_, errSq, Hiter) when
    ``return_results`` is True: ``Hiter`` is the taps after every output
    symbol (nSym_out, o, i, t) under ``storeCoeff`` (each stage's from its
    last pass), else the final taps (1, o, i, t).
    """
    sig_out, H, H_, err_sq, _, h_iter = _mimo_adapt_equalizer(sig, config, symb_ref, H, H_)
    if return_results:
        return sig_out, H, H_, err_sq, h_iter
    return sig_out


def mimo_adapt_equalizer_batch(sig, config: MIMOEqualizerConfig = None,
                               symb_ref=None, H=None, return_results=False):
    """B signals' full multi-stage training schedules at once.

    Batched counterpart of :func:`mimo_adapt_equalizer` (port of the JAX
    function of the same name): ``sig`` is (B, N, modes), ``symb_ref`` (B,
    nSym, modes), ``H`` optional (B, modes, modes, nTaps). Every signal runs
    the same schedule independently. With ``backend='pallas'`` each
    gradient-rule pass is one K3 launch and each rls / square-QAM dd-rls
    pass one K5 launch for all B signals; a blocked stage (``blockUpdate >
    1``) runs each block for all B signals at once; other stages, and
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
    sig = as_device_tensor(sig)
    if sig.ndim != 3:
        raise ValueError("mimo_adapt_equalizer_batch expects (B, N, modes)")
    dev = sig.device
    symb_ref = sig if symb_ref is None else torch.as_tensor(symb_ref).to(dev)
    H, Sd = _initial_state(sig.shape[0], sig.shape[2], config.nTaps, H, dev)
    y, H, _, _, err_sq, _ = _train(sig, config, symb_ref.to(torch.complex64), H,
                                   torch.zeros_like(H), Sd, single=False)
    if return_results:
        return y, H, err_sq
    return y


def _apply_spectrum(H, X, sps, nfft, n_sym):
    """Frozen taps on the input spectrum ``X`` (..., modes_in, nfft).

    ``y_o[s] = sum_{i,t} H[o,i,t] x[s*sps + t]``, a bank of correlations in
    the frequency domain. The mode mixing is an elementwise complex product
    summed over the input modes, in full float32 (never a TF32 matmul).
    When ``nfft % sps == 0`` the symbol-rate decimation is folded into the
    inverse transform: the wanted sampling phase (offset ``nTaps - 1``) is
    shifted to index 0, the spectrum aliased down by ``sps``, and an
    ``nfft/sps``-point inverse FFT runs. Returns (..., nSym, modes_out).
    """
    n_taps = H.shape[-1]
    Hf = torch.fft.fft(torch.flip(H.to(torch.complex64), [-1]), n=nfft, dim=-1)
    Yf = torch.sum(X.unsqueeze(-3) * Hf, dim=-2)  # (..., modes_out, nfft)
    if nfft % sps == 0:
        f32 = dict(dtype=torch.float32, device=X.device)
        k = torch.arange(nfft, **f32)
        ph = (torch.tensor(2 * np.pi, **f32) * k) * torch.tensor((n_taps - 1) / nfft, **f32)
        Yf = Yf * torch.exp(1j * ph)
        m = nfft // sps
        folded = Yf.reshape(*Yf.shape[:-1], sps, m).sum(dim=-2) / sps
        return torch.fft.ifft(folded, dim=-1)[..., :n_sym].transpose(-1, -2)
    y_full = torch.fft.ifft(Yf, dim=-1)
    return y_full[..., n_taps - 1:][..., ::sps][..., :n_sym].transpose(-1, -2)


def mimo_apply(H, sig, sps=2):
    """Apply a trained (frozen) MIMO tap tensor (port of the JAX ``mimo_apply``).

    ``H`` (modes_out, modes_in, nTaps), ``sig`` (N, modes_in) at ``sps``
    samples/symbol, zero-padded by nTaps//2 in front as the adaptive
    equalizer pads it. Returns (nSym, modes_out): the output of the
    equalizer's ``alg='static'`` rule, computed in the frequency domain.
    """
    sig = as_device_tensor(sig).to(torch.complex64)
    if sig.ndim == 1:
        sig = sig[:, None]
    H = torch.as_tensor(H).to(sig.device)
    n_taps = H.shape[-1]
    l_pad = n_taps // 2
    n = sig.shape[0] + 2 * l_pad + sps + n_taps
    n_sym = int(np.fix((sig.shape[0] + 2 * l_pad - n_taps) / sps + 1))
    nfft = 1 << int(np.ceil(np.log2(n)))
    # the tail padding is inside the FFT's own zero fill
    sig_pad = torch.cat([sig.new_zeros((l_pad, sig.shape[1])), sig])
    X = torch.fft.fft(sig_pad.T, n=nfft, dim=-1)
    return _apply_spectrum(H, X, sps, nfft, n_sym)


def _fused_response(pre, edc_config, n, n_taps, sps, device):
    """(P (nfft,) complex64, nfft): the combined response of the 'same'
    pre-filter, the CD compensation and the front padding of an n_taps
    equalizer, for signals of ``n`` samples at ``sps``.

    Host taps (NumPy, as designed) give a response computed in NumPy in
    float64 and rounded once; tensor taps give one computed in complex64
    on their device, as the JAX package does for traced taps.
    """
    l_pad = n_taps // 2
    n_pad = n + 2 * l_pad + sps + n_taps  # = mimo_apply's padded length
    parts, k_extra = [], 0
    if pre is not None:
        parts.append((pre, (pre.shape[0] - 1) // 2))
        k_extra += pre.shape[0] - 1
    if edc_config is not None:
        ht = np.fft.fftshift(np.fft.ifft(_edc_response(edc_config))).astype(np.complex64)
        parts.append((ht, ht.shape[0] // 2))
        k_extra += ht.shape[0] - 1
    nfft = 1 << int(np.ceil(np.log2(n_pad + k_extra)))
    if all(not isinstance(taps, torch.Tensor) for taps, _ in parts):
        kh = np.arange(nfft)
        Pn = np.exp(-2j * np.pi * kh * (l_pad / nfft))
        for taps, delay in parts:
            Pn = Pn * np.fft.fft(np.asarray(taps), n=nfft) * np.exp(
                2j * np.pi * kh * (delay / nfft))
        return torch.as_tensor(Pn.astype(np.complex64), device=device), nfft
    f32 = dict(dtype=torch.float32, device=device)
    two_pi_k = torch.tensor(2 * np.pi, **f32) * torch.arange(nfft, **f32)
    P = torch.exp(-1j * (two_pi_k * torch.tensor(l_pad / nfft, **f32)))
    for taps, delay in parts:
        taps = torch.as_tensor(taps).to(device, torch.complex64)
        P = P * torch.fft.fft(taps, n=nfft) * torch.exp(
            1j * (two_pi_k * torch.tensor(delay / nfft, **f32)))
    return P, nfft


def _fused_apply(H, sig, sps, P, nfft, scale):
    """The fused front end on (..., N, modes) signals with (..., o, i, T)
    taps and a response ``P`` from :func:`_fused_response`."""
    n, modes = sig.shape[-2:]
    n_taps = H.shape[-1]
    n_sym = int(np.fix((n + 2 * (n_taps // 2) - n_taps) / sps + 1))
    X = torch.fft.fft(sig.transpose(-1, -2), n=nfft, dim=-1) * P
    if scale is None:
        # Parseval: pnorm's mean power over the filtered signal (tails incl.)
        power = torch.sum((X * X.conj()).real, dim=(-2, -1))
        scale = torch.sqrt(power / torch.tensor(np.float32(float(nfft) * n * modes),
                                                device=X.device))
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32).to(X.device)
    X = X / scale.reshape(*scale.shape, 1, 1)
    return _apply_spectrum(H, X, sps, nfft, n_sym)


def mimo_apply_fused(H, sig, sps=2, pre=None, edc_config=None, scale=None):
    """Converged receiver front end in one pass: pre-filter + EDC + MIMO.

    Port of the JAX ``mimo_apply_fused``: computes
    ``mimo_apply(H, pnorm(edc(fir_filter(pre, sig), edc_config)), sps)`` with
    one forward FFT per input mode and one folded inverse FFT per output
    mode. ``scale`` is the power-normalization divisor; ``None`` derives it
    from the combined spectrum by Parseval (which includes the convolution
    tails outside the staged pnorm's window, an O(K/N) relative difference);
    pass the training-time scalar for parity with the staged path.

    Returns (nSym, modes_out) equalized symbols.
    """
    sig = as_device_tensor(sig).to(torch.complex64)
    if sig.ndim == 1:
        sig = sig[:, None]
    H = torch.as_tensor(H).to(sig.device)
    P, nfft = _fused_response(pre, edc_config, sig.shape[0], H.shape[-1], sps, sig.device)
    return _fused_apply(H, sig, sps, P, nfft, scale)


class MIMOEqualizer(torch.nn.Module):
    """The adaptive equalizer with its taps ``H[out, in, taps]``, widely
    linear taps ``H_`` and RLS state ``Sd[in, taps, taps]`` as module state.

    Each call trains on one block with :func:`mimo_adapt_equalizer`,
    starting from the taps, ``H_`` and Sd the previous call left (the
    central spike, zeros and the identity at first), and keeps the new
    ones in the ``H``, ``H_`` and ``Sd`` buffers, so a long record can be
    equalized block by block.
    """

    def __init__(self, config: MIMOEqualizerConfig, n_modes=2, device=None):
        super().__init__()
        self.config = config
        H, Sd = _initial_state(1, n_modes, config.nTaps, None, default_device(device))
        self.register_buffer("H", H[0])
        self.register_buffer("H_", torch.zeros_like(H[0]))
        self.register_buffer("Sd", Sd[0])

    def forward(self, sig, symb_ref=None):
        y, H, H_, _, Sd, _ = _mimo_adapt_equalizer(sig, self.config, symb_ref=symb_ref,
                                                   H=self.H, H_=self.H_, Sd=self.Sd)
        self.H, self.H_, self.Sd = H, H_, Sd
        return y


# ---------------------------------------------------------------------------
# SISO decision-feedback equalizers (DFE / FFE / Volterra)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DFEConfig:
    """Decision-feedback equalizer parameters (equalization.py:1176)."""

    nTapsFF: int = 5
    nTapsFB: int = 5
    SpS: int = 1
    mu: float = 1e-4
    nTrain: int = 1000
    M: int = 4
    constType: str = "pam"
    trainingMode: str = "data-aided"  # or 'fulltime'
    preconvIters: int = 1


@dataclass(frozen=True)
class FFEConfig:
    """Feedforward equalizer parameters (equalization.py:1545)."""

    nTaps: int = 5
    mu: float = 1e-4
    SpS: int = 1
    nTrain: int = 1000
    M: int = 4
    constType: str = "pam"
    trainingMode: str = "data-aided"
    preconvIters: int = 1


@dataclass(frozen=True)
class VolterraConfig:
    """Volterra equalizer parameters (equalization.py:1868)."""

    n1Taps: int = 5
    n2Taps: int = 3
    n3Taps: int = 2
    SpS: int = 1
    mu: float = 1e-3
    nTrain: int = 1000
    order: int = 2
    M: int = 4
    constType: str = "pam"
    trainingMode: str = "data-aided"
    preconvIters: int = 1


def _lms_scan(sig, symb_ref, cfg, n_ff, n_fb, use_fb):
    """The JAX ``_dfe_core`` / ``_ffe_core`` scans as a per-symbol loop on
    one signal: argmin slicer, ``conj(win)`` only for a complex
    constellation."""
    const = dfe_k.norm_const(cfg.M, cfg.constType)
    sig = as_device_tensor(sig).reshape(-1)
    symb_ref = torch.as_tensor(symb_ref).to(sig.device).reshape(-1)
    sig_pad, ref, n_out, _ = dfe_k.prepare(sig, symb_ref, n_ff, cfg.SpS, const)
    run = functools.partial(dfe_k.dfe_pass_plain, grid=False, conj=cfg.constType != "pam")
    y, mse, f, b = dfe_k.run_passes(sig_pad, ref, const, n_ff, n_fb, n_out, cfg, use_fb, run)
    y = y[0].real if cfg.constType == "pam" and y.is_complex() else y[0]
    if cfg.constType != "pam":
        y = y.to(torch.complex64)
    return y, f[0].to(torch.complex64), b[0].to(torch.complex64), mse[0]


def ffe(sig, symb_ref, config: FFEConfig = FFEConfig()):
    """Decision-directed feedforward LMS equalizer (equalization.py:1545).

    Returns (sigOut, f, mse): ``sigOut`` real at PAM, ``f`` complex64.
    """
    y, f, _, mse = _lms_scan(sig, symb_ref, config, config.nTaps, 1, False)
    return y, f, mse


def dfe(sig, symb_ref, config: DFEConfig = DFEConfig()):
    """Decision-feedback LMS equalizer (equalization.py:1176).

    Returns (sigOut, f, b, mse): ``sigOut`` real at PAM, taps complex64.
    """
    return _lms_scan(sig, symb_ref, config, config.nTapsFF, config.nTapsFB, True)


def volterra(sig, symb_ref, config: VolterraConfig = VolterraConfig()):
    """Decision-directed Volterra equalizer to 3rd order (equalization.py:1868).

    ``anorm(pnorm(.))`` of the real input, the argmin slicer over the PAM
    levels, updates with mu, mu/2 and mu/7, ``pnorm`` on the output.
    Returns (sigOut, [h1, h2 (n2, n2), h3 (n3, n3, n3)], mse).
    """
    return volterra_k.equalize(as_device_tensor(sig).reshape(-1),
                               torch.as_tensor(symb_ref).reshape(-1), config,
                               functools.partial(volterra_k.volterra_pass_plain, grid=False))
