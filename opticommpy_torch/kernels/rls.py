"""RLS / DD-RLS adaptive equalizer recurrence: the Hopper kernel
``csrc/rls.cu`` and its plain version.

Port of ``opticommpy_tpu/kernels/rls_pallas.py``: the batched kernel (K5,
``_rls_run_windows``: B signals, data-aided rls or dd-rls with the quantized
square-QAM slicer) and the single-signal one (K4, ``_rls_run``: dd-rls with
the argmin slicer over any constellation). Per symbol and input mode m,
with x the window column of mode m::

    A = Sd_m conj(x);  B = x^T Sd_m;  C = x^T A
    Sd_m' = (Sd_m - A B / (lam + C)) / lam;  Y_m = Sd_m' conj(x)
    H[o, m, :] += e[o] * Y_m

with e = ref - o (rls) or decision(o) - o (dd-rls). Sd is the per-mode
inverse-correlation state, carried in and out like the taps.

Layouts: ``sig_pad`` (B, rows, modes) padded signals, the window of symbol
k of a pass starting at symbol ``n_start`` being rows ``(n_start + k) *
sps`` ... ``+ n_taps``; ``ref`` (B, length, modes); taps ``H`` (B, modes,
modes, n_taps) as H[out, in, tap]; ``Sd`` (B, modes, n_taps, n_taps).

:func:`rls_stage_batch` (K5) and :func:`rls_stage` (K4) route by device: a
CPU tensor goes to :func:`rls_stage_plain`, a CUDA tensor to the kernel,
which either launches or raises. ``launches`` counts K4 launches,
``batch_launches`` K5 launches. Only the live symbols of a pass are
visited, so no padded tail symbol can rescale Sd.
"""

import numpy as np
import torch

from opticommpy_torch.kernels import _build
from opticommpy_torch.kernels.bps import _quantize, _square_qam_levels
from opticommpy_torch.kernels.mimo_eq import _kernel_inputs as _pad_inputs

__all__ = ["mimo_rls_kernel", "mimo_rls_kernel_batch", "rls_stage",
           "rls_stage_batch", "rls_stage_plain", "launches", "batch_launches"]

launches = 0  # K4 launches made by rls_stage on CUDA tensors
batch_launches = 0  # K5 launches made by rls_stage_batch on CUDA tensors

_SLICER = {"ref": 0, "grid": 1, "argmin": 2}
# limits of csrc/rls.cu: one thread per (mode, tap) row, at most 256; up to
# 8 modes and 32 taps; 1024 constellation points for the argmin slicer
_MAX_ROWS, _MAX_MODES, _MAX_TAPS, _MAX_TABLE = 256, 8, 32, 1024


def _check_args(sig_pad, ref, H, Sd, alg, sps, n_taps, n_start, length):
    if alg not in ("rls", "dd-rls"):
        raise ValueError(f"unknown RLS alg {alg!r}")
    if sig_pad.ndim != 3:
        raise ValueError(f"sig_pad must be (B, rows, modes), got {tuple(sig_pad.shape)}")
    n_batch, rows, modes = sig_pad.shape
    if length > 0 and (n_start + length - 1) * sps + n_taps > rows:
        raise ValueError("sig_pad is too short for the requested windows")
    if tuple(ref.shape) != (n_batch, length, modes):
        raise ValueError(f"ref must be ({n_batch}, {length}, {modes}), "
                         f"got {tuple(ref.shape)}")
    if tuple(H.shape) != (n_batch, modes, modes, n_taps):
        raise ValueError(f"H must be ({n_batch}, {modes}, {modes}, {n_taps})")
    if tuple(Sd.shape) != (n_batch, modes, n_taps, n_taps):
        raise ValueError(f"Sd must be ({n_batch}, {modes}, {n_taps}, {n_taps})")


def rls_stage_plain(sig_pad, ref, H, Sd, const, alg, lam, sps, n_taps,
                    n_start, length):
    """One RLS pass of B independent signals in plain PyTorch (any device).

    dd-rls decides with the quantized slicer on square QAM and the argmin
    over ``const`` otherwise, as the kernels do. The arithmetic follows the
    JAX kernels' real/imaginary form and order. Returns (y (B, length,
    modes) complex64, H (B, modes, modes, n_taps), Sd (B, modes, n_taps,
    n_taps)).
    """
    _check_args(sig_pad, ref, H, Sd, alg, sps, n_taps, n_start, length)
    dev = sig_pad.device
    n_batch, _, modes = sig_pad.shape
    const = np.asarray(const).astype(np.complex64)
    grid = _square_qam_levels(const.real, const.imag)
    c_re = torch.as_tensor(const.real.copy(), device=dev)
    c_im = torch.as_tensor(const.imag.copy(), device=dev)

    flat = sig_pad.to(torch.complex64).reshape(n_batch, -1)[:, n_start * sps * modes:]
    win = flat.unfold(1, modes * n_taps, sps * modes)[:, :length]
    win = win.reshape(n_batch, length, n_taps, modes).permute(1, 0, 3, 2)
    w_re, w_im = win.real, win.imag  # (length, B, modes, T)
    ref = ref.to(torch.complex64).transpose(0, 1)
    r_re, r_im = ref.real, ref.imag  # (length, B, modes)
    hr = H.real.to(torch.float32).clone()  # (B, o, m, T)
    hi = H.imag.to(torch.float32).clone()
    sr = Sd.real.to(torch.float32).clone()  # (B, m, T, T)
    si = Sd.imag.to(torch.float32).clone()
    y_re = torch.empty((length, n_batch, modes), dtype=torch.float32, device=dev)
    y_im = torch.empty_like(y_re)

    for k in range(length):
        xr, xi = w_re[k], w_im[k]  # (B, m, T)
        o_re = (hr * xr[:, None] - hi * xi[:, None]).sum((2, 3))  # (B, o)
        o_im = (hr * xi[:, None] + hi * xr[:, None]).sum((2, 3))
        if alg == "rls":
            t_re, t_im = r_re[k], r_im[k]
        elif grid is not None:
            t_re, t_im = _quantize(o_re, *grid), _quantize(o_im, *grid)
        else:
            d2 = (o_re[..., None] - c_re) ** 2 + (o_im[..., None] - c_im) ** 2
            ind = torch.argmin(d2, dim=-1)
            t_re, t_im = c_re[ind], c_im[ind]
        e_re, e_im = t_re - o_re, t_im - o_im

        xr_j, xi_j = xr[..., None, :], xi[..., None, :]  # along columns j
        xr_i, xi_i = xr[..., :, None], xi[..., :, None]  # along rows i
        a_re = (sr * xr_j + si * xi_j).sum(-1)  # A = Sd conj(x): (B, m, T)
        a_im = (si * xr_j - sr * xi_j).sum(-1)
        b_re = (sr * xr_i - si * xi_i).sum(-2)  # B = x^T Sd
        b_im = (si * xr_i + sr * xi_i).sum(-2)
        c_r = (xr * a_re - xi * a_im).sum(-1)  # C = x^T A: (B, m)
        c_i = (xr * a_im + xi * a_re).sum(-1)
        d_re, d_im = lam + c_r, c_i
        den = d_re * d_re + d_im * d_im
        inv_re, inv_im = (d_re / den)[..., None, None], (-d_im / den)[..., None, None]
        ab_re = a_re[..., :, None] * b_re[..., None, :] - a_im[..., :, None] * b_im[..., None, :]
        ab_im = a_re[..., :, None] * b_im[..., None, :] + a_im[..., :, None] * b_re[..., None, :]
        sub_re = ab_re * inv_re - ab_im * inv_im
        sub_im = ab_re * inv_im + ab_im * inv_re
        sr = (sr - sub_re) / lam
        si = (si - sub_im) / lam
        yy_re = (sr * xr_j + si * xi_j).sum(-1)  # Y = Sd' conj(x): (B, m, T)
        yy_im = (si * xr_j - sr * xi_j).sum(-1)
        # H[o, m, t] += e[o] * Y[m, t]
        er, ei = e_re[..., None, None], e_im[..., None, None]
        hr = hr + (er * yy_re[:, None] - ei * yy_im[:, None])
        hi = hi + (er * yy_im[:, None] + ei * yy_re[:, None])
        y_re[k] = o_re
        y_im[k] = o_im
    y = torch.complex(y_re, y_im).transpose(0, 1).contiguous()
    return y, torch.complex(hr, hi), torch.complex(sr, si)


def _rls_cuda(sig_pad, ref, H, Sd, const, alg, lam, sps, n_taps, n_start,
              length, slicer):
    _check_args(sig_pad, ref, H, Sd, alg, sps, n_taps, n_start, length)
    dev = sig_pad.device
    n_batch, rows, modes = sig_pad.shape
    if modes > _MAX_MODES or n_taps > _MAX_TAPS or modes * n_taps > _MAX_ROWS:
        raise ValueError(f"the RLS kernel takes at most {_MAX_MODES} modes, "
                         f"{_MAX_TAPS} taps and {_MAX_ROWS} = modes*taps rows")
    if slicer == "argmin" and not 0 < const.size <= _MAX_TABLE:
        raise ValueError(f"the RLS kernel takes 1 to {_MAX_TABLE} constellation points")
    lib = _build.load_library()
    grid = _square_qam_levels(const.real, const.imag)
    lo, step, top = (grid[0], grid[1], grid[2] - 1.0) if grid else (0.0, 1.0, 0.0)
    c_re = torch.as_tensor(const.real.copy(), device=dev)
    c_im = torch.as_tensor(const.imag.copy(), device=dev)
    sig_pad = sig_pad.to(torch.complex64).contiguous()
    ref = ref.to(device=dev, dtype=torch.complex64).contiguous()
    h0 = H.to(device=dev, dtype=torch.complex64).contiguous()
    sd0 = Sd.to(device=dev, dtype=torch.complex64).contiguous()
    y = torch.empty((n_batch, length, modes), dtype=torch.complex64, device=dev)
    h_out = torch.empty_like(h0)
    sd_out = torch.empty_like(sd0)
    with torch.cuda.device(dev):
        code = lib.rls_launch(
            n_batch, _build.ptr(sig_pad), rows * modes, n_start * sps * modes,
            sps * modes, int(length), modes, int(n_taps), _build.ptr(ref),
            _build.ptr(c_re), _build.ptr(c_im), int(c_re.shape[0]),
            _SLICER[slicer], float(lo), float(step), float(top), float(lam),
            _build.ptr(h0), _build.ptr(sd0), _build.ptr(h_out),
            _build.ptr(sd_out), _build.ptr(y), _build.stream_ptr(dev))
    _build.check(code, "rls_launch")
    return y, h_out, sd_out


def _stage_args(sig_pad, ref, H, Sd, const, alg, lam, sps, n_taps, n_start,
                length):
    if sig_pad.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rls: unsupported device {sig_pad.device}")
    return (sig_pad, ref, H, Sd, np.asarray(const).astype(np.complex64), alg,
            float(lam), int(sps), int(n_taps), int(n_start), int(length))


def rls_stage_batch(sig_pad, ref, H, Sd, const, alg, lam, sps, n_taps,
                    n_start, length):
    """One RLS pass of B signals: K5 on CUDA (one launch, one CTA per
    signal), :func:`rls_stage_plain` on CPU. dd-rls needs a square-QAM
    ``const`` (the quantized slicer), as the JAX batched kernel does."""
    global batch_launches
    args = _stage_args(sig_pad, ref, H, Sd, const, alg, lam, sps, n_taps,
                       n_start, length)
    const = args[4]
    square = _square_qam_levels(const.real, const.imag) is not None
    if alg != "rls" and not square:
        raise ValueError("batched dd-rls requires a square-QAM "
                         "constellation (quantized slicer)")
    if sig_pad.device.type == "cpu":
        return rls_stage_plain(*args)
    out = _rls_cuda(*args, "grid" if alg == "dd-rls" else "ref")
    batch_launches += 1
    return out


def rls_stage(sig_pad, ref, H, Sd, const, alg, lam, sps, n_taps, n_start,
              length):
    """One RLS pass of one signal: K4 on CUDA, the plain version on CPU.

    ``sig_pad`` (rows, modes), ``ref`` (length, modes), ``H`` (modes,
    modes, n_taps), ``Sd`` (modes, n_taps, n_taps). dd-rls decides with the
    quantized slicer on square QAM and the argmin over ``const`` otherwise.
    Returns (y, H, Sd) in those layouts.
    """
    global launches
    args = _stage_args(sig_pad[None], ref[None], H[None], Sd[None], const, alg,
                       lam, sps, n_taps, n_start, length)
    if sig_pad.device.type == "cpu":
        y, h, sd = rls_stage_plain(*args)
    else:
        const = args[4]
        square = _square_qam_levels(const.real, const.imag) is not None
        slicer = "ref" if alg == "rls" else ("grid" if square else "argmin")
        y, h, sd = _rls_cuda(*args, slicer)
        launches += 1
    return y[0], h[0], sd[0]


def _kernel_inputs(sig, symb_ref, alg, n_taps, sps, H0, Sd0):
    """Padded signals, references, taps and Sd (identity per mode by default)."""
    sig_pad, ref, h0 = _pad_inputs(
        sig, symb_ref, "symb_ref is required for alg='rls'" if alg == "rls" else None,
        n_taps, sps, H0)
    if Sd0 is None:
        sd0 = torch.eye(n_taps, dtype=torch.complex64, device=sig.device).repeat(
            sig.shape[0], sig.shape[2], 1, 1)
    else:
        sd0 = torch.as_tensor(Sd0).to(sig.device, torch.complex64)
    return sig_pad, ref, h0, sd0


def mimo_rls_kernel_batch(sig, symb_ref, const, alg="rls", n_taps=15, sps=2,
                          lam=0.99, H0=None, Sd0=None):
    """B signals' RLS / DD-RLS equalizers in one pass (port of
    ``mimo_rls_pallas_batch``): K5 on CUDA.

    ``sig`` (B, N, modes); ``symb_ref`` (B, nSym, modes), or None for
    dd-rls; dd-rls requires a square-QAM constellation. Returns (y (B,
    nSym, modes) complex64, H (B, modes, modes, n_taps), Sd (B, modes,
    n_taps, n_taps)).
    """
    sig = torch.as_tensor(sig)
    sig_pad, ref, h0, sd0 = _kernel_inputs(sig, symb_ref, alg, n_taps, sps, H0, Sd0)
    return rls_stage_batch(sig_pad, ref, h0, sd0, const, alg, lam, sps, n_taps,
                           0, ref.shape[1])


def mimo_rls_kernel(sig, symb_ref, const, alg="rls", n_taps=15, sps=2,
                    lam=0.99, H0=None, Sd0=None):
    """NxN RLS / DD-RLS adaptive equalizer (port of ``mimo_rls_pallas``).

    As the JAX function routes: rls, and dd-rls on square QAM, run the
    batched kernel K5 with B = 1; dd-rls on any other constellation runs
    the single-signal kernel K4 with the argmin slicer. Returns (y (nSym,
    modes) complex64, H (modes, modes, n_taps), Sd (modes, n_taps,
    n_taps)).
    """
    sig = torch.as_tensor(sig)
    const = np.asarray(const).astype(np.complex64)
    ref_b = None if symb_ref is None else torch.as_tensor(symb_ref)[None]
    h0_b = None if H0 is None else torch.as_tensor(H0)[None]
    sd0_b = None if Sd0 is None else torch.as_tensor(Sd0)[None]
    if alg == "rls" or _square_qam_levels(const.real, const.imag) is not None:
        y, h, sd = mimo_rls_kernel_batch(sig[None], ref_b, const, alg, n_taps,
                                         sps, lam, h0_b, sd0_b)
        return y[0], h[0], sd[0]
    sig_pad, ref, h0, sd0 = _kernel_inputs(sig[None], ref_b, alg, n_taps, sps,
                                           h0_b, sd0_b)
    return rls_stage(sig_pad[0], ref[0], h0[0], sd0[0], const, alg, lam, sps,
                     n_taps, 0, ref.shape[1])
