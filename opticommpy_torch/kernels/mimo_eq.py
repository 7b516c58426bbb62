"""N x N adaptive equalizer recurrence: the Hopper kernel ``csrc/mimo_eq.cu``
and its plain version.

Port of ``opticommpy_tpu/kernels/mimo_pallas.py`` (the single-signal
kernel). Per symbol: the filter output ``o = H @ w`` of the window ``w``, the
rule's error ``e``, and the rank-1 update ``H += mu * e * conj(g)`` with
``g = w`` (``g = w / P_mode`` for nlms). Rules: ``'lms'`` (reference symbols
for the first ``n_train`` symbols of the pass, decisions after), ``'nlms'``,
``'cma'``, ``'rde'`` and ``'da-rde'``.

Layouts: ``sig_pad`` is the (rows, modes) padded signal; the window of
symbol k of a pass starting at symbol ``n_start`` is rows
``(n_start + k) * sps`` ... ``+ n_taps``, flattened tap-major/mode-minor
(lane ``t * modes + i``). Taps travel in that flat layout, ``(modes,
modes * n_taps)``.

:func:`mimo_eq_stage` routes by device: a CPU tensor goes to
:func:`mimo_eq_stage_plain`, a CUDA tensor to the kernel, which either
launches or raises. ``launches`` counts kernel launches.
"""

import numpy as np
import torch

from opticommpy_torch.kernels import _build
from opticommpy_torch.kernels.bps import _quantize, _square_qam_levels

__all__ = ["mimo_eq_kernel", "mimo_eq_stage", "mimo_eq_stage_plain",
           "stage_aux", "launches"]

launches = 0  # kernel launches made by mimo_eq_stage on CUDA tensors

_ALG_CODE = {"lms": 0, "nlms": 1, "cma": 2, "rde": 3, "da-rde": 4}
# limits of csrc/mimo_eq.cu: register tiles up to 8 modes x 256 lanes,
# constellation and radii tables of 1024 entries in shared memory
_MAX_MODES, _MAX_WIDTH, _MAX_TABLE = 8, 256, 1024


def stage_aux(alg, const_np):
    """The rule's aux vector: the CMA radius, or the RDE radii."""
    if alg == "cma":
        return np.array([np.mean(np.abs(const_np) ** 4)
                         / np.mean(np.abs(const_np) ** 2)], np.float32)
    if alg == "rde":
        return np.unique(np.round(np.abs(const_np), 6)).astype(np.float32)
    return np.zeros(1, np.float32)


def _check_args(sig_pad, ref, h_flat, alg, sps, n_taps, n_start, length):
    if alg not in _ALG_CODE:
        raise ValueError(f"unknown alg {alg}")
    if sig_pad.ndim != 2:
        raise ValueError(f"sig_pad must be (rows, modes), got {tuple(sig_pad.shape)}")
    rows, modes = sig_pad.shape
    if (n_start + length - 1) * sps + n_taps > rows and length > 0:
        raise ValueError("sig_pad is too short for the requested windows")
    if tuple(ref.shape) != (length, modes):
        raise ValueError(f"ref must be ({length}, {modes}), got {tuple(ref.shape)}")
    if tuple(h_flat.shape) != (modes, modes * n_taps):
        raise ValueError(f"taps must be ({modes}, {modes * n_taps})")


def mimo_eq_stage_plain(sig_pad, ref, h_flat, const, aux, alg, mu, n_train,
                        sps, n_taps, n_start, length):
    """One pass of the recurrence in plain PyTorch (any device).

    Returns (y (length, modes) complex64, taps (modes, modes*n_taps)).
    """
    _check_args(sig_pad, ref, h_flat, alg, sps, n_taps, n_start, length)
    dev = sig_pad.device
    modes = sig_pad.shape[1]
    width = modes * n_taps
    const = np.asarray(const).astype(np.complex64)
    grid = _square_qam_levels(const.real, const.imag)
    c_re = torch.as_tensor(const.real.copy(), device=dev)
    c_im = torch.as_tensor(const.imag.copy(), device=dev)
    aux_t = torch.as_tensor(np.asarray(aux, np.float32), device=dev)

    flat = sig_pad.to(torch.complex64).reshape(-1)[n_start * sps * modes:]
    win = flat.unfold(0, width, sps * modes)[:length]
    w_re, w_im = win.real, win.imag
    ref = ref.to(torch.complex64)
    r_re, r_im = ref.real, ref.imag
    hr = h_flat.real.to(torch.float32).clone()
    hi = h_flat.imag.to(torch.float32).clone()
    lane_mode = torch.arange(width, device=dev) % modes
    y_re = torch.empty((length, modes), dtype=torch.float32, device=dev)
    y_im = torch.empty_like(y_re)

    for k in range(length):
        wr, wi = w_re[k], w_im[k]
        o_re = (hr * wr - hi * wi).sum(1)
        o_im = (hr * wi + hi * wr).sum(1)
        p_out = o_re * o_re + o_im * o_im
        if alg in ("lms", "nlms"):
            if k < n_train:
                t_re, t_im = r_re[k], r_im[k]
            elif grid is not None:
                t_re, t_im = _quantize(o_re, *grid), _quantize(o_im, *grid)
            else:
                d2 = (o_re[:, None] - c_re) ** 2 + (o_im[:, None] - c_im) ** 2
                ind = torch.argmin(d2, dim=1)
                t_re, t_im = c_re[ind], c_im[ind]
            e_re, e_im = t_re - o_re, t_im - o_im
        else:
            if alg == "cma":
                err = aux_t[0] - p_out
            elif alg == "rde":
                d2 = (torch.sqrt(p_out)[:, None] - aux_t) ** 2
                r_dec = aux_t[torch.argmin(d2, dim=1)]
                err = r_dec * r_dec - p_out
            else:  # da-rde
                err = (r_re[k] * r_re[k] + r_im[k] * r_im[k]) - p_out
            e_re, e_im = err * o_re, err * o_im
        if alg == "nlms":
            pw = wr * wr + wi * wi
            p_mode = torch.zeros(modes, dtype=torch.float32, device=dev)
            p_mode = p_mode.index_add(0, lane_mode, pw)[lane_mode]
            p_mode = torch.clamp(p_mode, min=1e-12)
            g_re, g_im = wr / p_mode, wi / p_mode
        else:
            g_re, g_im = wr, wi
        hr = hr + mu * (e_re[:, None] * g_re + e_im[:, None] * g_im)
        hi = hi + mu * (e_im[:, None] * g_re - e_re[:, None] * g_im)
        y_re[k] = o_re
        y_im[k] = o_im
    return torch.complex(y_re, y_im), torch.complex(hr, hi)


def _mimo_eq_stage_cuda(sig_pad, ref, h_flat, const, aux, alg, mu, n_train,
                        sps, n_taps, n_start, length):
    global launches
    _check_args(sig_pad, ref, h_flat, alg, sps, n_taps, n_start, length)
    dev = sig_pad.device
    modes = sig_pad.shape[1]
    width = modes * n_taps
    const = np.asarray(const).astype(np.complex64)
    if modes > _MAX_MODES or width > _MAX_WIDTH:
        raise ValueError(f"the kernel takes at most {_MAX_MODES} modes and "
                         f"{_MAX_WIDTH} = modes*taps window lanes")
    if max(const.size, np.size(aux)) > _MAX_TABLE:
        raise ValueError(f"the kernel takes at most {_MAX_TABLE} constellation "
                         "points and radii")
    lib = _build.load_library()
    grid = _square_qam_levels(const.real, const.imag)
    lo, step, top = (grid[0], grid[1], grid[2] - 1.0) if grid else (0.0, 1.0, 0.0)
    c_re = torch.as_tensor(const.real.copy(), device=dev)
    c_im = torch.as_tensor(const.imag.copy(), device=dev)
    aux_t = torch.as_tensor(np.asarray(aux, np.float32), device=dev)
    sig_pad = sig_pad.to(torch.complex64).contiguous()
    ref = ref.to(device=dev, dtype=torch.complex64).contiguous()
    h0 = h_flat.to(device=dev, dtype=torch.complex64).contiguous()
    y = torch.empty((length, modes), dtype=torch.complex64, device=dev)
    h_out = torch.empty_like(h0)
    with torch.cuda.device(dev):
        code = lib.mimo_eq_launch(
            _build.ptr(sig_pad), n_start * sps * modes, sps * modes,
            int(length), modes, width, _build.ptr(ref), _build.ptr(c_re),
            _build.ptr(c_im), int(c_re.shape[0]), _build.ptr(aux_t),
            int(aux_t.shape[0]), int(grid is not None), float(lo),
            float(step), float(top), _ALG_CODE[alg], float(mu), int(n_train),
            _build.ptr(h0), _build.ptr(h_out), _build.ptr(y),
            _build.stream_ptr(dev))
    _build.check(code, "mimo_eq_launch")
    launches += 1
    return y, h_out


def mimo_eq_stage(sig_pad, ref, h_flat, const, aux, alg, mu, n_train, sps,
                  n_taps, n_start, length):
    """One pass of the recurrence: the kernel on CUDA, the plain version on CPU.

    ``ref`` holds the pass's ``length`` reference symbols; ``const`` is the
    numpy constellation, ``aux`` the rule's :func:`stage_aux` vector.
    Returns (y (length, modes) complex64, taps (modes, modes*n_taps)).
    """
    args = (sig_pad, ref, h_flat, const, aux, alg, float(mu), int(n_train),
            int(sps), int(n_taps), int(n_start), int(length))
    if sig_pad.device.type == "cuda":
        return _mimo_eq_stage_cuda(*args)
    if sig_pad.device.type == "cpu":
        return mimo_eq_stage_plain(*args)
    raise ValueError(f"mimo_eq: unsupported device {sig_pad.device}")


def mimo_eq_kernel(sig, symb_ref, const, alg="lms", n_taps=15, sps=2,
                   mu=2e-3, n_train=10000, H0=None):
    """NxN adaptive equalizer with a selectable update rule (port of
    ``mimo_eq_pallas``).

    ``sig`` is (N, modes) at ``sps`` samples/symbol; ``symb_ref`` the
    (nSym, modes) reference (None for the blind rules). Returns (equalized
    symbols (nSym, modes) complex64, taps H (modes, modes, n_taps)).
    """
    sig = torch.as_tensor(sig)
    dev = sig.device
    const = np.asarray(const).astype(np.complex64)
    n, modes = sig.shape
    if symb_ref is None:
        if alg in ("lms", "nlms", "da-rde"):
            raise ValueError(
                "symb_ref is required for alg='lms'/'nlms'/'da-rde'")
        symb_ref = torch.zeros((n // sps, modes), dtype=torch.complex64,
                               device=dev)
    symb_ref = torch.as_tensor(symb_ref).to(dev, torch.complex64)
    n_sym = symb_ref.shape[0]
    if H0 is None:
        h0 = torch.zeros((modes, modes, n_taps), dtype=torch.complex64,
                         device=dev)
        h0[torch.arange(modes), torch.arange(modes), n_taps // 2] = 1.0
    else:
        h0 = torch.as_tensor(H0).to(dev, torch.complex64)
    h_flat = h0.permute(0, 2, 1).reshape(modes, modes * n_taps)
    l_pad = n_taps // 2
    tail = max(l_pad + sps + n_taps, (n_sym - 1) * sps + n_taps - n - l_pad)
    sig_pad = torch.zeros((l_pad + n + tail, modes), dtype=torch.complex64,
                          device=dev)
    sig_pad[l_pad:l_pad + n] = sig
    y, h = mimo_eq_stage(sig_pad, symb_ref, h_flat, const,
                         stage_aux(alg, const), alg, mu, n_train, sps, n_taps,
                         0, n_sym)
    return y, h.reshape(modes, n_taps, modes).permute(0, 2, 1)
