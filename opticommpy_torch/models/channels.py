"""Fiber channels: the linear fiber and Manakov split-step Fourier
propagation.

Port of ``opticommpy_tpu/models/channels.py`` (:func:`linear_fiber_channel`,
:func:`manakov_ssf`). Both
polarizations and every signal of a batch are stacked in one (2, B, N)
field, so each FFT is one batched ``torch.fft`` call over the time axis
(cuFFT on the card). The fixed-step path (``nlprMethod=False``) knows its
step schedule in advance; with ``fusedLinear`` it merges adjacent linear
half-steps and carries the field in the frequency domain (one FFT pair per
step). The adaptive path (``nlprMethod=True``) sizes each step from the
peak nonlinear phase rotation and iterates the trapezoidal correction to
``tol``. ASE noise comes from one ``torch.Generator`` whose draws follow
each other span by span.
"""

import math

import numpy as np
import scipy.constants as sconst
import torch

from opticommpy_torch.models.config import EDFAConfig, LinearFiberConfig, SSFMConfig
from opticommpy_torch.models.devices import edfa
from opticommpy_torch.ops.signal import fftfreq
from opticommpy_torch.utils.rng import ensure_generator

__all__ = ["linear_fiber_channel", "manakov_ssf", "nlin_phase_rot",
           "convergence_condition", "fiber_coefficients"]


def fiber_coefficients(alpha_db_km, D_ps_nm_km, fc_hz):
    """(alpha [1/km], beta2 [ps^2/km]) from engineering units (channels.py:78-82)."""
    c_kms = sconst.c / 1e3
    lam = c_kms / fc_hz
    alpha = alpha_db_km / (10 * np.log10(np.e))
    beta2 = -(D_ps_nm_km * lam**2) / (2 * np.pi * c_kms)
    return alpha, beta2


def linear_fiber_channel(e_in, config: LinearFiberConfig):
    """Linear fiber: one-shot frequency-domain loss and chromatic dispersion,
    ``H(w) = exp(-a/2*L + j*b2/2*w^2*L)`` (reference channels.py:30), on
    every column of (N,) or (N, modes) ``e_in``.

    The angular-frequency grid and the dispersion phase are float32 as in
    the JAX package (``w = 2*pi*Fs*fftfreq(n)``, then ``(b2/2)*w**2*L``, each
    product rounded to float32), and the phase reaches tens of radians, so
    the port keeps that arithmetic rather than computing it in float64.
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    e_in = torch.as_tensor(e_in)
    squeeze = e_in.ndim == 1
    if squeeze:
        e_in = e_in[:, None]
    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    n = e_in.shape[0]
    w = (2 * np.pi * config.Fs) * fftfreq(n, 1.0, torch.float32, e_in.device)
    phase = ((beta2 / 2) * (w * w)) * config.L
    H = torch.exp(torch.complex(torch.full_like(w, (-alpha / 2) * config.L), phase))
    out = torch.fft.ifft(torch.fft.fft(e_in.to(torch.complex64), dim=0) * H[:, None], dim=0)
    return out[:, 0] if squeeze else out


def _solver_cdtype(cfg):
    """Complex dtype for the solver (cfg.prec: 'c64' | 'c128')."""
    if cfg.prec == "c128":
        return torch.complex128
    if cfg.prec != "c64":
        raise ValueError(f"prec must be 'c64' or 'c128', got {cfg.prec!r}")
    return torch.complex64


def nlin_phase_rot(ex, ey, pch, gamma_):
    """Manakov nonlinear phase rotation per km (reference channels.py:471).

    Trapezoidal form: 8/9*gamma*(P_start + |Ex|^2 + |Ey|^2)/2.
    """
    return (8 / 9) * gamma_ * (pch + torch.abs(ex) ** 2 + torch.abs(ey) ** 2) / 2


def convergence_condition(e_fd, e_conv):
    """Normalized RMS change between trapezoidal iterations (channels.py:496)."""
    num = torch.sum(torch.abs(e_fd - e_conv) ** 2)
    den = torch.sum(torch.abs(e_conv) ** 2)
    return torch.sqrt(num) / torch.sqrt(den)


def _fft(x):
    return torch.fft.fft(x, dim=-1)


def _ifft(x):
    return torch.fft.ifft(x, dim=-1)


def _manakov_step(e, pch, lin_op, hz_, cfg: SSFMConfig):
    """One symmetric split step with the trapezoidal nonlinear correction.

    ``pch`` is the start-of-step power (trapezoid anchor).
    """
    e_hd = _ifft(_fft(e) * lin_op)

    def one_iter(e_conv):
        phi = nlin_phase_rot(e_conv[0], e_conv[1], pch, cfg.gamma)
        return _ifft(_fft(e_hd * torch.exp(1j * (phi * hz_))) * lin_op)

    if cfg.trapIters > 0:
        e_fd = e
        for _ in range(cfg.trapIters):
            e_fd = one_iter(e_fd)
        return e_fd
    e_fd, e_conv, n_it = e_hd, e, 0
    lim = math.inf
    while n_it < cfg.maxIter and lim >= cfg.tol:
        e_fd = one_iter(e_conv)
        lim = float(convergence_condition(e_fd, e_conv))
        e_conv = e_fd
        n_it += 1
    return e_fd


def _manakov_span(e, lin_arg, span_len, cfg: SSFMConfig):
    """Propagate the (2, B, N) field through one span."""
    if not cfg.nlprMethod:
        n_full = int(np.floor(span_len / cfg.hz))
        hz_last = span_len - n_full * cfg.hz
        sizes = np.asarray(
            [cfg.hz] * n_full + ([hz_last] if hz_last > 1e-9 else []),
            dtype=np.float64)

        if cfg.fusedLinear and cfg.trapIters == 1:
            # the linear operator between nonlinear steps k and k+1 covers
            # (h_k + h_{k+1})/2, the edges h/2; the field stays in the
            # frequency domain between steps
            mid = (sizes[:-1] + sizes[1:]) / 2 if len(sizes) > 1 else []
            gaps = np.concatenate([mid, [sizes[-1] / 2]])
            gamma_ = cfg.gamma

            def fstep_with(ef, hz_, lin_gap):
                et = _ifft(ef)
                pch = torch.sum((et * et.conj()).real, dim=0)
                # trapezoid anchor = current power: (8/9)*gamma*pch
                return _fft(et * torch.exp(1j * (((8 / 9) * gamma_ * hz_) * pch))) * lin_gap

            n_uni = 0
            while (n_uni < len(sizes) and sizes[n_uni] == cfg.hz
                   and gaps[n_uni] == cfg.hz):
                n_uni += 1
            ef = _fft(e) * torch.exp(lin_arg * (sizes[0] / 2))
            lin_full = torch.exp(lin_arg * cfg.hz)
            for _ in range(n_uni):
                ef = fstep_with(ef, cfg.hz, lin_full)
            for k in range(n_uni, len(sizes)):  # <= 2 trailing steps
                ef = fstep_with(ef, sizes[k], torch.exp(lin_arg * gaps[k]))
            return _ifft(ef)

        def step_with(e, hz_, lin_op):
            pch = torch.sum(torch.abs(e) ** 2, dim=0)
            return _manakov_step(e, pch, lin_op, hz_, cfg)

        n_uni = int(np.sum(sizes == cfg.hz))
        lin_half = torch.exp(lin_arg * (cfg.hz / 2))
        for _ in range(n_uni):
            e = step_with(e, cfg.hz, lin_half)
        for k in range(n_uni, len(sizes)):  # at most the partial final step
            e = step_with(e, sizes[k], torch.exp(lin_arg * (sizes[k] / 2)))
        return e

    # adaptive step size (channels.py:392-397); z and the step size are
    # carried in the field's real dtype, as the JAX package carries them
    real_dtype = e.real.dtype
    z = torch.zeros((), dtype=real_dtype, device=e.device)
    span = torch.tensor(span_len, dtype=real_dtype, device=e.device)
    while bool(z < span):
        pch = torch.sum(torch.abs(e) ** 2, dim=0)
        phi_rot = nlin_phase_rot(e[0], e[1], pch, cfg.gamma)
        hz_cand = cfg.maxNlinPhaseRot / torch.max(phi_rot)
        hz_ = torch.minimum(hz_cand, span - z)
        lin_op = torch.exp(lin_arg * (hz_ / 2))
        e = _manakov_step(e, pch, lin_op, hz_, cfg)
        z = z + hz_
    return e


def _to_columns(e):
    """(2, B, N) pol-stacked field -> (N, 2*B) interleaved columns."""
    _, b, n = e.shape
    return torch.stack([e[0].T, e[1].T], dim=2).reshape(n, 2 * b)


def manakov_ssf(e_in, config: SSFMConfig, generator=None, save_all_spans=False):
    """Manakov split-step Fourier propagation (reference channels.py:252).

    Parameters
    ----------
    e_in : (N, 2*k) tensor
        Dual-polarization field(s); columns alternate x/y polarization for k
        independently propagating signals.
    config : SSFMConfig
    generator : torch.Generator for the per-span ASE noise (a generator
        seeded 0 on the field's device when None).
    save_all_spans : also return the field after every span,
        (Nspans, N, 2*k).

    Returns
    -------
    (N, 2*k) output field, or (output, per_span_fields) if save_all_spans.
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    cdtype = _solver_cdtype(config)
    real_dtype = torch.float64 if cdtype == torch.complex128 else torch.float32
    e_in = torch.as_tensor(e_in).to(cdtype)
    n = e_in.shape[0]
    e = torch.stack([e_in[:, 0::2].T, e_in[:, 1::2].T]).contiguous()

    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    w = (2 * np.pi * config.Fs) * fftfreq(n, 1.0, real_dtype, e.device)
    lin_arg = torch.complex(torch.full_like(w, -(alpha / 2)),
                            (beta2 / 2) * (w * w)).to(cdtype)

    amp_cfg = EDFAConfig(G=config.alpha * config.Lspan, NF=config.NF,
                         Fc=config.Fc, Fs=config.Fs)
    if config.amp == "edfa":
        generator = ensure_generator(generator, e.device)
    span_fields = []
    for _ in range(n_spans):
        e = _manakov_span(e, lin_arg, config.Lspan, config)
        if config.amp == "edfa":
            e = edfa(e, amp_cfg, generator)
        elif config.amp == "ideal":
            e = e * float(np.exp(alpha / 2 * config.Lspan))
        if save_all_spans:
            span_fields.append(_to_columns(e))
    out = _to_columns(e)
    if save_all_spans:
        return out, torch.stack(span_fields)
    return out
