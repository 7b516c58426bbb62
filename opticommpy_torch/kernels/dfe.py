"""Decision-feedback / feedforward LMS equalizer: the Hopper kernel
``csrc/dfe.cu`` and its plain version.

Port of ``opticommpy_tpu/kernels/dfe_pallas.py`` (K13). Every signal of a
(B, N) batch runs its own recurrence; per symbol k:

- ``y = sum_t f[t] w[t] + sum_j b[j] d[j]``, with the window ``w[t] =
  x[k*sps + t]`` of the padded signal and the decision buffer ``d``;
- the decision: the uniform-level quantizer ``clip(round((y - lo)/step),
  0, L-1)*step + lo`` per axis on a square-QAM grid, on the real axis for
  PAM (imaginary decision 0), else an argmin over the constellation;
- the target: the reference while ``k < n_train``, else the decision;
  ``e = target - y``, ``mse = |e|^2``;
- while training, or always with ``fulltime``: ``f += mu*(e*conj(w))`` and
  ``b += mu*(e*conj(d))``;
- the target enters the buffer at index 0.

The FFE is the same pass without feedback (``b`` is then unused).

Both versions do the same float32 operations in the same order: each tap
sum is a pairwise tree over the taps zero-padded to a power of two (the
kernel pads to a larger power of two, which adds only zeros first), and
the quantizer divides by ``step``. So the kernel equals its plain version
bit for bit, and one signal's result does not depend on the batch it rides
in. A real (B, N) signal with a real constellation runs the real instance,
which gives the complex instance's real parts exactly: at PAM every
imaginary plane stays zero.

:func:`dfe_run` routes by device: a CPU tensor goes to :func:`dfe_pass_plain`,
a CUDA tensor to the kernel, which either launches or raises. ``launches``
counts kernel launches.
"""

import numpy as np
import torch

from opticommpy_torch.comm.modulation import norm_const
from opticommpy_torch.kernels import _build
from opticommpy_torch.kernels._build import device_tables
from opticommpy_torch.kernels.bps import _square_qam_levels
from opticommpy_torch.ops.signal import pnorm_rows, tree_sum
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["dfe_run", "dfe_pass_plain", "dfe_kernel", "ffe_kernel", "launches"]

launches = 0  # kernel launches made by dfe_run on CUDA tensors

MAX_FF, MAX_FB = 32, 16  # widest tap vectors the kernel's instances hold
_MAX_TABLE = 1024
_SLICER = {"argmin": 0, "pam": 1, "qam": 2}


def _uniform_levels(c_re, c_im, tol=1e-5):
    """(lo, step, L) for a real uniform-level constellation (PAM), else None."""
    if np.any(np.abs(np.asarray(c_im)) > tol):
        return None
    re = np.sort(np.asarray(c_re, dtype=np.float64))
    if len(re) < 2:
        return None
    steps = np.diff(re)
    if not np.allclose(steps, steps[0], atol=tol):
        return None
    return float(re[0]), float(steps[0]), int(len(re))


def slicer_of(const):
    """(kind, (lo, step, L)) of the decision rule the kernel takes for
    ``const``: 'qam' for a square grid, 'pam' for uniform real levels, else
    'argmin' (grid None)."""
    const = np.asarray(const, np.complex64)
    grid = _square_qam_levels(const.real, const.imag)
    if grid is not None:
        return "qam", grid
    grid = _uniform_levels(const.real, const.imag)
    return ("pam", grid) if grid is not None else ("argmin", None)


def _grad(er, ei, xr, xi, conj):
    """(re, im) of ``e*conj(x)``, or of ``e*x`` with ``conj=False``."""
    er, ei = er[:, None], ei[:, None]
    if conj:
        return er * xr + ei * xi, ei * xr - er * xi
    return er * xr - ei * xi, er * xi + ei * xr


def _real_const(const):
    return not np.any(np.asarray(const, np.complex64).imag != 0)


def _check(sig_pad, ref, const, f0, b0, n_sym, sps, use_fb):
    if not sig_pad.is_complex() and not _real_const(const):
        raise ValueError("dfe: a real signal needs a real constellation")
    if sig_pad.ndim != 2 or ref.ndim != 2 or ref.shape != (sig_pad.shape[0], n_sym):
        raise ValueError("dfe: sig_pad must be (B, N) and ref (B, n_sym)")
    n_ff = f0.shape[-1]
    if f0.shape != (sig_pad.shape[0], n_ff) or (use_fb and b0.shape[0] != sig_pad.shape[0]):
        raise ValueError("dfe: taps must be (B, nTaps)")
    if n_sym > 0 and (n_sym - 1) * sps + n_ff > sig_pad.shape[1]:
        raise ValueError("dfe: sig_pad is too short for n_sym windows")


def dfe_pass_plain(sig_pad, ref, const, f0, b0, n_sym, sps, mu, n_train, fulltime,
                   use_fb=True, grid=True, conj=True):
    """One pass of B independent recurrences in plain PyTorch (any device).

    ``sig_pad`` (B, N) and ``ref`` (B, n_sym) are both real (float32; the
    real instance, for a real constellation) or both complex64; ``f0``
    (B, nTapsFF) and ``b0`` (B, nTapsFB) carry the taps in. ``grid=False``
    decides by the argmin whatever the constellation, and ``conj=False``
    takes the gradient ``e*w`` (the JAX scans' rules for a real
    constellation). Returns (y (B, n_sym), mse (B, n_sym) float32, f, b).
    """
    _check(sig_pad, ref, const, f0, b0, n_sym, sps, use_fb)
    dev = sig_pad.device
    cplx = sig_pad.is_complex()
    kind, levels = slicer_of(const) if grid else ("argmin", None)
    const = np.asarray(const, np.complex64)
    c_re = torch.as_tensor(const.real.copy(), device=dev)
    c_im = torch.as_tensor(const.imag.copy(), device=dev)
    n_b, n_ff = f0.shape
    f32 = dict(dtype=torch.float32, device=dev)
    if levels is not None:
        lo, step, n_lev = levels
        step_t = torch.tensor(step, **f32)  # a device divisor: a true division on CUDA

        def quantize(x):
            return torch.clamp(torch.round((x - lo) / step_t), 0.0, n_lev - 1.0) * step + lo

    def planes(t):
        t = t.to(torch.complex64 if cplx else torch.float32)
        return (t.real, t.imag) if cplx else (t, None)

    wins = sig_pad.unfold(1, n_ff, sps)[:, :n_sym]  # (B, n_sym, n_ff) view
    w_re, w_im = planes(wins)
    r_re, r_im = planes(ref)
    fr, fi = (p.clone() if p is not None else None for p in planes(f0))
    n_fb = b0.shape[-1] if use_fb else 0
    if use_fb:
        br, bi = (p.clone() if p is not None else None for p in planes(b0))
        dr = torch.zeros((n_b, n_fb), **f32)
        di = torch.zeros((n_b, n_fb), **f32) if cplx else None
    y_re = torch.empty((n_b, n_sym), **f32)
    y_im = torch.empty((n_b, n_sym), **f32) if cplx else None
    mse = torch.empty((n_b, n_sym), **f32)

    for k in range(n_sym):
        wr = w_re[:, k]
        wi = w_im[:, k] if cplx else None
        if cplx:
            yr = tree_sum(fr * wr - fi * wi)
            yi = tree_sum(fr * wi + fi * wr)
            if use_fb:
                yr = yr + tree_sum(br * dr - bi * di)
                yi = yi + tree_sum(br * di + bi * dr)
        else:
            yr = tree_sum(fr * wr)
            if use_fb:
                yr = yr + tree_sum(br * dr)
        if k < n_train:
            tr = r_re[:, k]
            ti = r_im[:, k] if cplx else None
        elif kind == "argmin":
            dre = yr[:, None] - c_re
            d2 = dre * dre
            if cplx:
                dim_ = yi[:, None] - c_im
                d2 = d2 + dim_ * dim_
            ind = torch.argmin(d2, dim=1)
            tr, ti = c_re[ind], (c_im[ind] if cplx else None)
        else:
            tr = quantize(yr)
            if cplx:
                ti = quantize(yi) if kind == "qam" else torch.zeros_like(yi)
        er = tr - yr
        ei = ti - yi if cplx else None
        if fulltime or k < n_train:
            if cplx:
                gr, gi = _grad(er, ei, wr, wi, conj)
                fr, fi = fr + mu * gr, fi + mu * gi
                if use_fb:
                    gr, gi = _grad(er, ei, dr, di, conj)
                    br, bi = br + mu * gr, bi + mu * gi
            else:
                fr = fr + mu * (er[:, None] * wr)
                if use_fb:
                    br = br + mu * (er[:, None] * dr)
        if use_fb and n_fb:
            dr = torch.cat([tr[:, None], dr[:, :n_fb - 1]], dim=1)
            if cplx:
                di = torch.cat([ti[:, None], di[:, :n_fb - 1]], dim=1)
        y_re[:, k] = yr
        mse[:, k] = er * er + ei * ei if cplx else er * er
        if cplx:
            y_im[:, k] = yi

    def join(re, im):
        return torch.complex(re, im) if cplx else re

    f = join(fr, fi)
    b = join(br, bi) if use_fb else b0
    return join(y_re, y_im), mse, f, b


def _dfe_cuda(sig_pad, ref, const, f0, b0, n_sym, sps, mu, n_train, fulltime, use_fb):
    global launches
    _check(sig_pad, ref, const, f0, b0, n_sym, sps, use_fb)
    kind, levels = slicer_of(const)
    cplx = sig_pad.is_complex()
    dtype = torch.complex64 if cplx else torch.float32
    for name, t in (("sig_pad", sig_pad), ("ref", ref), ("f0", f0), ("b0", b0)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"dfe: {name} must be a contiguous {dtype} tensor")
        if t.device != sig_pad.device:
            raise ValueError(f"dfe: {name} is on another device")
    n_b, n_ff = f0.shape
    n_fb = b0.shape[1] if use_fb else 0
    if n_ff > MAX_FF or n_fb > MAX_FB or n_ff < 1:
        raise ValueError(f"dfe: the kernel takes 1-{MAX_FF} feedforward and at most "
                         f"{MAX_FB} feedback taps")
    const = np.asarray(const, np.complex64)
    if const.shape[0] > _MAX_TABLE:
        raise ValueError(f"dfe: at most {_MAX_TABLE} constellation points")
    lib = _build.load_library()
    dev = sig_pad.device
    c_re, c_im, _ = device_tables(const, None, dev)
    lo, step, n_lev = levels if levels is not None else (0.0, 1.0, 1)
    y = torch.empty((n_b, n_sym), dtype=dtype, device=dev)
    mse = torch.empty((n_b, n_sym), dtype=torch.float32, device=dev)
    f_out = torch.empty_like(f0)
    b_out = torch.empty_like(b0)
    with torch.cuda.device(dev):
        code = lib.dfe_launch(
            n_b, int(cplx), _build.ptr(sig_pad), sig_pad.shape[1], n_sym, sps,
            _build.ptr(ref), _build.ptr(c_re), _build.ptr(c_im), int(const.shape[0]),
            _SLICER[kind], float(lo), float(step), float(n_lev - 1), n_ff, n_fb,
            float(mu), int(n_train), int(bool(fulltime)), _build.ptr(f0), _build.ptr(b0),
            _build.ptr(f_out), _build.ptr(b_out), _build.ptr(y), _build.ptr(mse),
            _build.stream_ptr(dev))
    _build.check(code, "dfe_launch")
    launches += 1
    return y, mse, f_out, (b_out if use_fb else b0)


def dfe_run(sig_pad, ref, const, f0, b0, n_sym, sps, mu, n_train, fulltime, use_fb=True):
    """One pass of the DFE (FFE with ``use_fb=False``) recurrence over B
    signals: the kernel for CUDA tensors, :func:`dfe_pass_plain` for CPU
    tensors. Same arguments and outputs as :func:`dfe_pass_plain`."""
    if sig_pad.device.type == "cuda":
        return _dfe_cuda(sig_pad, ref, const, f0, b0, n_sym, sps, mu, n_train, fulltime,
                         use_fb)
    if sig_pad.device.type == "cpu":
        return dfe_pass_plain(sig_pad, ref, const, f0, b0, n_sym, sps, mu, n_train, fulltime,
                              use_fb)
    raise ValueError(f"dfe: unsupported device {sig_pad.device}")


def prepare(sig, symb_ref, n_taps, sps, const):
    """Per-row pnorm, padding and the zero-filled reference of the JAX wrappers
    (``dfe_pallas.py:222-247``). Real rows stay real where the constellation
    is real. A tensor stays on its device; a NumPy array goes to the CUDA
    device."""
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[None]
    symb_ref = torch.as_tensor(symb_ref).to(sig.device)
    if symb_ref.ndim == 1:
        symb_ref = symb_ref[None]
    cplx = sig.is_complex() or symb_ref.is_complex() or not _real_const(const)
    dtype = torch.complex64 if cplx else torch.float32
    sig = pnorm_rows(sig).to(dtype)
    symb_ref = pnorm_rows(symb_ref).to(dtype)
    edge = sig.new_zeros((sig.shape[0], n_taps // 2))
    sig_pad = torch.cat([edge, sig, edge], dim=1)
    n_out = int((sig_pad.shape[1] - n_taps + n_taps % 2) // sps)
    ref = sig.new_zeros((sig.shape[0], n_out))
    m = min(n_out, symb_ref.shape[1])
    ref[:, :m] = symb_ref[:, :m]
    return sig_pad.contiguous(), ref, n_out, squeeze


def run_passes(sig_pad, ref, const, n_ff, n_fb, n_out, cfg, use_fb, run=None):
    """``cfg.preconvIters`` passes of ``run`` (by default :func:`dfe_run`;
    the JAX scans pass a plain pass with their rules) from the centre-spike
    taps."""
    run = run or dfe_run
    n_b = sig_pad.shape[0]
    f = sig_pad.new_zeros((n_b, n_ff))
    f[:, n_ff // 2] = 1.0
    b = sig_pad.new_zeros((n_b, n_fb))
    y = mse = None
    for _ in range(cfg.preconvIters):
        y, mse, f, b = run(sig_pad, ref, const, f, b, n_out, int(cfg.SpS), float(cfg.mu),
                           int(cfg.nTrain), cfg.trainingMode == "fulltime", use_fb)
    return y, mse, f, b


def dfe_kernel(sig, symb_ref, config=None):
    """Kernel decision-feedback equalizer (port of ``dfe_pallas``; drop-in
    for :func:`~opticommpy_torch.dsp.equalization.dfe`).

    One signal ((N,) samples, (nSym,) reference) or a batch ((B, N),
    (B, nSym)), each row ``pnorm``-ed on its own and equalized by its own
    recurrence, all in one launch per ``preconvIters`` pass on CUDA. A real
    signal with a PAM constellation runs the real instance. Returns (y, f,
    b, mse) with the batching of the input; ``y``, ``f`` and ``b`` are
    complex64, as the JAX kernel returns them.
    """
    from opticommpy_torch.dsp.equalization import DFEConfig

    cfg = config if config is not None else DFEConfig()
    const = norm_const(cfg.M, cfg.constType)
    sig_pad, ref, n_out, squeeze = prepare(sig, symb_ref, cfg.nTapsFF, cfg.SpS, const)
    y, mse, f, b = run_passes(sig_pad, ref, const, cfg.nTapsFF, cfg.nTapsFB, n_out, cfg, True)
    y, f, b = (t.to(torch.complex64) for t in (y, f, b))
    if squeeze:
        return y[0], f[0], b[0], mse[0]
    return y, f, b, mse


def ffe_kernel(sig, symb_ref, config=None):
    """Kernel feedforward equalizer (port of ``ffe_pallas``; drop-in for
    :func:`~opticommpy_torch.dsp.equalization.ffe`): the DFE kernel without
    feedback. Returns (y, f, mse); ``y`` is real at PAM, complex64
    otherwise, and ``f`` complex64."""
    from opticommpy_torch.dsp.equalization import FFEConfig

    cfg = config if config is not None else FFEConfig()
    const = norm_const(cfg.M, cfg.constType)
    sig_pad, ref, n_out, squeeze = prepare(sig, symb_ref, cfg.nTaps, cfg.SpS, const)
    y, mse, f, _ = run_passes(sig_pad, ref, const, cfg.nTaps, 1, n_out, cfg, False)
    y = y.real if cfg.constType == "pam" and y.is_complex() else y
    if cfg.constType != "pam":
        y = y.to(torch.complex64)
    f = f.to(torch.complex64)
    if squeeze:
        return y[0], f[0], mse[0]
    return y, f, mse
