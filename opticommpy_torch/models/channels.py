"""Fiber channels: the linear fiber, the scalar and the Manakov split-step
Fourier propagation, and the AWGN channel.

Port of ``opticommpy_tpu/models/channels.py`` (:func:`linear_fiber_channel`,
:func:`ssfm`, :func:`manakov_ssf`, :func:`awgn`). In the Manakov solver both
polarizations and every signal of a batch are stacked in one (2, B, N)
field, so each FFT is one batched ``torch.fft`` call over the time axis
(cuFFT on the card). The fixed-step path (``nlprMethod=False``) knows its
step schedule in advance; with ``fusedLinear`` it merges adjacent linear
half-steps and carries the field in the frequency domain (one FFT pair per
step). The adaptive path (``nlprMethod=True``) sizes each step from the
peak nonlinear phase rotation and iterates the trapezoidal correction to
``tol``. The span loop takes the sign of the nonlinear operator, so
digital backpropagation (:func:`opticommpy_torch.dsp.equalization.manakov_dbp`)
runs the same span with ``nl_sign=-1``. ASE noise comes from one
``torch.Generator`` whose draws follow each other span by span. On a
field on the card the step's and the trapezoidal pass's elementwise work
runs K16 (``kernels/ssfm_pass``, ``csrc/ssfm_pass.cu``) around cuFFT; on
the CPU its plain twins, the PyTorch ops below, run it.

Under a profiler (``utils/profiling``) the solver counts, from host
integers its loop already holds: ``ssfm.calls`` (one per call of a Manakov
channel entry point), ``ssfm.steps`` (split steps), ``ssfm.trap_iters``
(trapezoidal passes run) and ``ssfm.host_syncs`` (the step loop's
synchronizing reads: each convergence test, which on the adaptive path
also reads whether another step follows, and with fixed passes the
adaptive path's ``z < span`` test a step) and ``ssfm.fused_passes`` (the
passes K16 ran, counted by its wrapper); digital backpropagation counts the
same as ``dbp.*``.
Its spans are host-only labels (``ssfm.span`` per span, ``ssfm.amplifier``),
so a caller's device range around the call keeps all of its kernels.
"""

import math

import numpy as np
import scipy.constants as sconst
import torch

from opticommpy_torch.kernels import ssfm_pass
from opticommpy_torch.models.config import (AWGNConfig, EDFAConfig, LinearFiberConfig,
                                            SSFMConfig)
from opticommpy_torch.models.devices import _edfa_gain, edfa
from opticommpy_torch.ops.noise import gaussian_complex_noise, gaussian_noise
from opticommpy_torch.ops.signal import fftfreq, sig_pow
from opticommpy_torch.utils.profiling import count, span
from opticommpy_torch.utils.rng import as_device_tensor, ensure_generator

__all__ = ["linear_fiber_channel", "ssfm", "manakov_ssf", "nlin_phase_rot",
           "convergence_condition", "awgn", "fiber_coefficients"]


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
    e_in = as_device_tensor(e_in)
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


def convergence_condition(e_fd, e_conv, group=None):
    """Normalized RMS change between trapezoidal iterations (channels.py:496).

    With a process ``group`` (the data-parallel SSFM), the two sums run
    over the whole batch the group holds: one all-reduce of both. On a
    field on the card the sums are K16's (``converge_kernel``).
    """
    if _k16(e_fd):
        sums = ssfm_pass.converge_kernel(e_fd, e_conv)
    else:
        sums = torch.stack(_converge_sums_plain(e_fd, e_conv))
    if group is not None:
        torch.distributed.all_reduce(sums, group=group)
    return torch.sqrt(sums[0]) / torch.sqrt(sums[1])


def _k16(e):
    """Whether the Manakov step's elementwise work runs K16
    (``kernels/ssfm_pass``): a field on a CUDA device, which K16 takes or
    refuses. On the CPU the plain twins below, the PyTorch ops, run it."""
    return e.is_cuda


def _power_plain(e, gamma_):
    """K16's ``power_kernel`` in PyTorch ops: the start-of-step power of the
    (2, B, N) field and the maximum of its rotation."""
    pch = torch.sum(torch.abs(e) ** 2, dim=0)
    return pch, torch.max(nlin_phase_rot(e[0], e[1], pch, gamma_))


def _rotate_plain(e_conv, e_hd, pch, hz_, gamma_, nl_sign):
    """K16's ``rotate_kernel`` in PyTorch ops: the half-stepped field
    ``e_hd`` rotated by the mean of the start-of-step power ``pch`` and the
    power of the pass's estimate ``e_conv``."""
    phi = nlin_phase_rot(e_conv[0], e_conv[1], pch, gamma_)
    return e_hd * torch.exp((nl_sign * 1j) * (phi * hz_))


def _converge_sums_plain(e_fd, e_conv):
    """K16's ``converge_kernel`` sums in PyTorch ops."""
    return torch.sum(torch.abs(e_fd - e_conv) ** 2), torch.sum(torch.abs(e_conv) ** 2)


def _fft(x):
    return torch.fft.fft(x, dim=-1)


def _ifft(x):
    return torch.fft.ifft(x, dim=-1)


def _half_step(e, lin_op):
    """A linear half-step, ``ifft(fft(e) * lin_op)``; on K16's route the
    product takes the inverse FFT's 1/N (``lin_kernel``) and the inverse
    FFT is unnormalized."""
    if _k16(e):
        spec = _fft(e)
        ssfm_pass.lin_kernel(spec, lin_op)
        return torch.fft.ifft(spec, dim=-1, norm="forward")
    return _ifft(_fft(e) * lin_op)


def _nl_rot(et, gamma_, hz):
    """The scalar NLSE's nonlinear step, ``et * exp(1j*gamma*|et|^2*hz)``,
    with the complex power ``et*conj(et)`` as the JAX package forms it."""
    return et * torch.exp(1j * gamma_ * (et * et.conj()) * hz)


def ssfm(e_in, config: SSFMConfig, generator=None):
    """Symmetric split-step Fourier for the scalar NLSE (reference
    channels.py:112).

    Fixed step ``hz``: ``floor(Ltotal/Lspan)`` spans of ``floor(Lspan/hz)``
    steps, the nonlinear step ``exp(1j*gamma*|E|^2*hz)`` (no 8/9 factor, no
    trapezoid), with per-span EDFA, ideal (gain ``exp(alpha/2*n_steps*hz)``,
    not ``Lspan``) or no amplification. ``fusedLinear`` merges adjacent
    linear half-steps (one FFT pair per step). Accepts (N,) or (N, B); each
    column propagates on its own. The EDFA noise comes from ``generator``
    (seed 0 on the field's device when None), span after span; the JAX
    package folds the span index into its key. A tensor keeps its device;
    any other input goes to the CUDA device.
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    cdtype = _solver_cdtype(config)
    real_dtype = torch.float64 if cdtype == torch.complex128 else torch.float32
    e_in = as_device_tensor(e_in).to(cdtype)
    squeeze = e_in.ndim == 1
    if squeeze:
        e_in = e_in[:, None]
    e = e_in.T.contiguous()  # (B, N): time on the last axis
    n = e.shape[-1]

    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    gamma_, hz = config.gamma, config.hz
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    n_steps = int(np.floor(config.Lspan / hz))
    w = (2 * np.pi * config.Fs) * fftfreq(n, 1.0, real_dtype, e.device)
    lin_arg = torch.complex(torch.full_like(w, -(alpha / 2)),
                            (beta2 / 2) * (w * w)).to(cdtype)
    lin_half = torch.exp(lin_arg * (hz / 2))
    amp_cfg = EDFAConfig(G=config.alpha * config.Lspan, NF=config.NF,
                         Fc=config.Fc, Fs=config.Fs)
    if config.amp == "edfa":
        generator = ensure_generator(generator, e.device)

    if config.fusedLinear:
        lin_full = torch.exp(lin_arg * hz)

        def span_steps(e):
            ef = _fft(e) * lin_half
            for _ in range(n_steps - 1):
                ef = _fft(_nl_rot(_ifft(ef), gamma_, hz)) * lin_full
            return _ifft(_fft(_nl_rot(_ifft(ef), gamma_, hz)) * lin_half)
    else:
        def span_steps(e):
            ef = _fft(e)
            for _ in range(n_steps):
                ef = _fft(_nl_rot(_ifft(ef * lin_half), gamma_, hz)) * lin_half
            return _ifft(ef)

    for _ in range(n_spans):
        e = span_steps(e)
        if config.amp == "edfa":
            e = edfa(e, amp_cfg, generator)
        elif config.amp == "ideal":
            e = e * float(np.exp(alpha / 2 * n_steps * hz))
    out = e.T
    return out[:, 0] if squeeze else out


def _trap_pass(e_conv, e_hd, pch, lin_op, hz_, gamma_, nl_sign):
    """One trapezoidal pass: the half-stepped field ``e_hd`` rotated by the
    mean of the start-of-step power ``pch`` and the power of the pass's
    estimate ``e_conv``, through the second linear half-step."""
    if _k16(e_conv):
        rot = ssfm_pass.rotate_kernel(e_conv, e_hd, pch, hz_, gamma_, nl_sign)
    else:
        rot = _rotate_plain(e_conv, e_hd, pch, hz_, gamma_, nl_sign)
    return _half_step(rot, lin_op)


def _converge(e_fd, e_conv, status, group=None, write=False):
    """The pass's convergence number into ``status[0]``; ``write`` copies
    ``e_fd`` over ``e_conv`` (K16 does both in one launch)."""
    if _k16(e_fd) and group is None:
        ssfm_pass.converge_kernel(e_fd, e_conv, status, write)
        return
    status[0] = convergence_condition(e_fd, e_conv, group)
    if write:
        e_conv.copy_(e_fd)


def _step_start(e, z, span_end, lin_arg, cfg: SSFMConfig, status, group=None):
    """The adaptive step's work before its passes (channels.py:392-397):
    (start-of-step power, step size, linear half-step operator, the
    half-stepped field), with ``z`` advanced by the step in place and
    ``status[1]`` set to whether another step follows. The step size keeps
    the peak nonlinear phase rotation at ``maxNlinPhaseRot`` and ends the
    step at the span's end at the latest."""
    def reduce_max(phi_max):
        if group is not None:
            torch.distributed.all_reduce(phi_max, torch.distributed.ReduceOp.MAX, group=group)

    if _k16(e):
        pch, _, hz_ = ssfm_pass.power_kernel(e, cfg.gamma,
                                             (z, span_end, cfg.maxNlinPhaseRot, status),
                                             None if group is None else reduce_max)
        spec = _fft(e)
        lin_op = ssfm_pass.lin_kernel(spec, lin_arg=lin_arg, hz=hz_)
        return pch, hz_, lin_op, torch.fft.ifft(spec, dim=-1, norm="forward")
    pch, phi_max = _power_plain(e, cfg.gamma)
    reduce_max(phi_max)
    hz_ = torch.minimum(cfg.maxNlinPhaseRot / phi_max, span_end - z)
    z.add_(hz_)
    status[1] = z < span_end
    lin_op = torch.exp(lin_arg * (hz_ / 2))
    return pch, hz_, lin_op, _half_step(e, lin_op)


def _manakov_step(e, pch, lin_op, hz_, cfg: SSFMConfig, nl_sign=1.0, group=None,
                  e_hd=None, status=None):
    """One symmetric split step with the trapezoidal nonlinear correction.

    ``pch`` is the start-of-step power (trapezoid anchor); ``nl_sign`` the
    sign of the nonlinear rotation (``nl_sign * 1j`` is exactly ``1j`` for
    the forward channel, so its rounding is the same as without it);
    ``group`` as in :func:`_manakov_span`; ``e_hd`` the half-stepped field
    where the caller formed it. Returns the stepped field, the trapezoidal
    passes run (each a synchronizing read when ``trapIters`` is 0) and,
    where ``status`` (the device's [convergence number, whether another
    step follows], :func:`_step_start`) is given and the passes read the
    device, whether another step follows, read with the last pass's
    convergence number; None otherwise.
    """
    if e_hd is None:
        e_hd = _half_step(e, lin_op)
    if cfg.trapIters > 0:
        e_fd = e
        for _ in range(cfg.trapIters):
            e_fd = _trap_pass(e_fd, e_hd, pch, lin_op, hz_, cfg.gamma, nl_sign)
        return e_fd, cfg.trapIters, None
    read = e.real.new_zeros(2) if status is None else status
    e_fd, e_conv, n_it, lim, go_on = e_hd, e, 0, math.inf, None
    while n_it < cfg.maxIter and lim >= cfg.tol:
        e_fd = _trap_pass(e_conv, e_hd, pch, lin_op, hz_, cfg.gamma, nl_sign)
        _converge(e_fd, e_conv, read, group)
        # one transfer: the convergence number and whether a step follows
        lim, go_on = read.tolist()
        e_conv = e_fd
        n_it += 1
    return e_fd, n_it, None if status is None or go_on is None else bool(go_on)


def _manakov_span(e, lin_arg, span_len, cfg: SSFMConfig, nl_sign=1.0, group=None,
                  counters="ssfm"):
    """Propagate the (2, B, N) field through one span; ``nl_sign=-1``
    inverts the nonlinear rotation (digital backpropagation, reference
    equalization.py:976). With a process ``group``, ``e`` is the group
    member's share of a batch split over the group: the adaptive step and
    the trapezoid's convergence test then read the whole batch (a MAX and a
    SUM all-reduce), so every member steps as the unsplit batch would.
    The span's steps, trapezoidal passes and synchronizing reads go to the
    counters ``<counters>.steps``, ``.trap_iters`` and ``.host_syncs``, the
    passes K16 ran (its wrapper's count) to ``.fused_passes``."""
    e = e.contiguous()  # K16 takes contiguous fields; a pipeline stage may pass a slice
    k16_passes = ssfm_pass.passes
    e, steps, iters, syncs = _span_steps(e, lin_arg, span_len, cfg, nl_sign, group)
    count(counters + ".steps", steps)
    count(counters + ".trap_iters", iters)
    count(counters + ".host_syncs", syncs)
    count(counters + ".fused_passes", ssfm_pass.passes - k16_passes)
    return e


def _span_steps(e, lin_arg, span_len, cfg: SSFMConfig, nl_sign, group):
    """:func:`_manakov_span`'s propagation: (field, steps, trapezoidal
    passes, synchronizing reads)."""
    j_sign = nl_sign * 1j
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
                return _fft(et * torch.exp(j_sign * (((8 / 9) * gamma_ * hz_) * pch))) * lin_gap

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
            return _ifft(ef), len(sizes), len(sizes), 0

        def step_with(e, hz_, lin_op):
            pch = torch.sum(torch.abs(e) ** 2, dim=0)
            return _manakov_step(e, pch, lin_op, hz_, cfg, nl_sign, group)[:2]

        n_uni = int(np.sum(sizes == cfg.hz))
        lin_half = torch.exp(lin_arg * (cfg.hz / 2))
        iters = 0
        for _ in range(n_uni):
            e, n_it = step_with(e, cfg.hz, lin_half)
            iters += n_it
        for k in range(n_uni, len(sizes)):  # at most the partial final step
            e, n_it = step_with(e, sizes[k], torch.exp(lin_arg * (sizes[k] / 2)))
            iters += n_it
        return e, len(sizes), iters, 0 if cfg.trapIters > 0 else iters

    # adaptive step size (channels.py:392-397); z and the step size are
    # carried in the field's real dtype, as the JAX package carries them.
    # Whether another step follows (z < span) is read with the step's last
    # convergence number, so a step iterated to tol reads the device once a
    # pass; the first test, 0 < span, is the host's. On a CUDA field in one
    # process the loop replays CUDA graphs of the same work (_StepGraphs).
    if _use_graphs(e, cfg, group):
        return _span_steps_graphed(e, lin_arg, span_len, cfg, nl_sign)
    real_dtype = e.real.dtype
    z = torch.zeros((), dtype=real_dtype, device=e.device)
    span_end = torch.tensor(span_len, dtype=real_dtype, device=e.device)
    status = torch.zeros(2, dtype=real_dtype, device=e.device)
    steps = iters = syncs = 0
    go_on = span_len > 0
    while go_on:
        pch, hz_, lin_op, e_hd = _step_start(e, z, span_end, lin_arg, cfg, status, group)
        e, n_it, go_on = _manakov_step(e, pch, lin_op, hz_, cfg, nl_sign, group, e_hd, status)
        if go_on is None:  # fixed passes: read z < span alone
            go_on = bool(status[1])
            syncs += 1
        steps += 1
        iters += n_it
    return e, steps, iters, syncs + (0 if cfg.trapIters > 0 else iters)


def _use_graphs(e, cfg: SSFMConfig, group):
    """Whether the adaptive loop replays CUDA graphs: a CUDA field in one
    process, the trapezoid iterated to ``tol``."""
    return e.is_cuda and group is None and cfg.trapIters == 0 and cfg.maxIter > 0


class _StepGraphs:
    """The adaptive step loop's device work as two CUDA graphs on static
    buffers, for one field shape and solver: ``start`` (the step size, the
    half-stepped field, z after the step and, into ``status[1]``, whether
    another step follows) and ``one_pass`` (a trapezoidal pass; its
    convergence number into ``status[0]``; the pass's field written over
    the field). A replay runs the eager loop's kernels on the same values,
    so fields and counts are the same bits, with one launch where the eager
    loop launches several kernels (K16's, cuFFT's): the card, not the host,
    paces the loop. K16's counts (``ssfm_pass.launches``, ``.passes``) take
    the warm-up and the captures off, and each replay on (``start_k16``,
    ``pass_k16``)."""

    def __init__(self, e, lin_arg, cfg: SSFMConfig, nl_sign):
        self.e, self.lin_arg = e.clone(), lin_arg.clone()
        self.z = torch.zeros((), dtype=e.real.dtype, device=e.device)
        self.span_end = torch.ones_like(self.z)
        self.status = torch.zeros(2, dtype=e.real.dtype, device=e.device)

        def start():
            self.pch, self.hz, self.lin_op, self.e_hd = _step_start(
                self.e, self.z, self.span_end, self.lin_arg, cfg, self.status)

        def one_pass():
            e_fd = _trap_pass(self.e, self.e_hd, self.pch, self.lin_op, self.hz, cfg.gamma,
                              nl_sign)
            _converge(e_fd, self.e, self.status, write=True)

        stream = torch.cuda.current_stream(e.device)
        side = torch.cuda.Stream(e.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):  # cuFFT plans, K16's scratch, the allocator's blocks
            ssfm_pass.uncounted(lambda: (start(), one_pass()))
        stream.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self.start, self.one_pass = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.start, pool=pool):
            _, self.start_k16 = ssfm_pass.uncounted(start)
        with torch.cuda.graph(self.one_pass, pool=pool):
            _, self.pass_k16 = ssfm_pass.uncounted(one_pass)


_GRAPHS = {}


def _step_graphs(e, lin_arg, cfg: SSFMConfig, nl_sign):
    """The :class:`_StepGraphs` of this field shape and solver, captured on
    first use; the last four kept."""
    key = (e.device, tuple(e.shape), e.dtype, float(nl_sign), cfg.gamma, cfg.maxNlinPhaseRot)
    if key not in _GRAPHS:
        if len(_GRAPHS) >= 4:
            _GRAPHS.pop(next(iter(_GRAPHS)))
        _GRAPHS[key] = _StepGraphs(e, lin_arg, cfg, nl_sign)
    return _GRAPHS[key]


def _span_steps_graphed(e, lin_arg, span_len, cfg: SSFMConfig, nl_sign):
    """:func:`_span_steps`'s adaptive loop by :class:`_StepGraphs`: the same
    steps, passes and reads (one a pass)."""
    g = _step_graphs(e, lin_arg, cfg, nl_sign)
    g.e.copy_(e)
    g.lin_arg.copy_(lin_arg)
    g.z.zero_()
    g.span_end.fill_(span_len)
    steps = iters = 0
    go_on = span_len > 0
    while go_on:
        g.start.replay()
        n_it, lim = 0, math.inf
        while n_it < cfg.maxIter and lim >= cfg.tol:
            g.one_pass.replay()
            lim, go_on = g.status.tolist()
            n_it += 1
        steps, iters = steps + 1, iters + n_it
    ssfm_pass.replayed(g.start_k16, steps)
    ssfm_pass.replayed(g.pass_k16, iters)
    return g.e.clone(), steps, iters, iters


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
    count("ssfm.calls", 1)
    e = _to_pol_stacked(e_in, config)
    span_fields = []
    for e in _manakov_spans(e, config, generator):
        if save_all_spans:
            span_fields.append(_to_columns(e))
    out = _to_columns(e)
    if save_all_spans:
        return out, torch.stack(span_fields)
    return out


def _to_pol_stacked(e_in, config: SSFMConfig):
    """(N, 2*k) interleaved columns -> the solver's (2, k, N) field, after
    the checks every Manakov entry point makes."""
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    cdtype = _solver_cdtype(config)
    e_in = as_device_tensor(e_in).to(cdtype)
    return torch.stack([e_in[:, 0::2].T, e_in[:, 1::2].T]).contiguous()


def _lin_arg(n, config: SSFMConfig, cdtype, device):
    """The linear operator's exponent ``-alpha/2 + 1j*beta2/2*w^2`` on the
    ``n``-point grid ``w = 2*pi*Fs*fftfreq(n)``."""
    real_dtype = torch.float64 if cdtype == torch.complex128 else torch.float32
    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    w = (2 * np.pi * config.Fs) * fftfreq(n, 1.0, real_dtype, device)
    return torch.complex(torch.full_like(w, -(alpha / 2)), (beta2 / 2) * (w * w)).to(cdtype)


def _amplify(e, config: SSFMConfig, generator, batch=None):
    """The span's amplifier on the (2, B, N) field: ``config.amp`` 'edfa'
    (gain ``alpha*Lspan`` dB, ASE from ``generator``), 'ideal' or none.

    ``batch=(b_total, b0)`` says ``e`` holds signals ``b0 .. b0+B`` of a
    batch of ``b_total``: the EDFA then draws the whole batch's noise, as
    the unsplit call does, and adds its own signals' share.
    """
    if config.amp == "edfa":
        amp_cfg = EDFAConfig(G=config.alpha * config.Lspan, NF=config.NF,
                             Fc=config.Fc, Fs=config.Fs)
        if batch is None:
            return edfa(e, amp_cfg, generator)
        b_total, b0 = batch
        gain, p_noise = _edfa_gain(amp_cfg)
        noise = gaussian_complex_noise(generator, (2, b_total) + tuple(e.shape[2:]), p_noise)
        return e * gain + noise[:, b0:b0 + e.shape[1]]
    if config.amp == "ideal":
        alpha, _ = fiber_coefficients(config.alpha, config.D, config.Fc)
        return e * float(np.exp(alpha / 2 * config.Lspan))
    return e


def _manakov_spans(e, config: SSFMConfig, generator, group=None, batch=None):
    """Yield the (2, B, N) field after each span of the link (the span, then
    its amplifier); ``group`` as in :func:`_manakov_span`, ``batch`` as in
    :func:`_amplify`."""
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    lin_arg = _lin_arg(e.shape[-1], config, e.dtype, e.device)
    if config.amp == "edfa":
        generator = ensure_generator(generator, e.device)
    for _ in range(n_spans):
        with span("ssfm.span", device=False):
            e = _manakov_span(e, lin_arg, config.Lspan, config, group=group)
        with span("ssfm.amplifier", device=False):
            e = _amplify(e, config, generator, batch)
        yield e


def awgn(sig, generator, config: AWGNConfig = AWGNConfig(), device=None):
    """AWGN channel calibrated to an SNR in the signal bandwidth (reference
    channels.py:522): noise variance ``(Fs/B) * sig_pow(sig) / SNR_lin``,
    complex or (``complexNoise=False``) real.

    ``generator`` is a ``torch.Generator`` or an integer seed for a new
    generator on the signal's device. A tensor keeps its device, or goes
    to ``device`` when one is named; any other input goes to ``device``, the
    CUDA device when none is named.
    """
    sig = as_device_tensor(sig, device)
    generator = ensure_generator(generator, sig.device)
    var = (config.Fs / config.B) * (sig_pow(sig) / 10 ** (config.snr / 10))
    if config.complexNoise:
        noise = gaussian_complex_noise(generator, sig.shape, var)
    else:
        noise = gaussian_noise(generator, sig.shape, var / 2)
    return sig + noise.to(sig.device)
