"""N x N adaptive equalizer recurrence: the Hopper kernel ``csrc/mimo_eq.cu``
and its plain version.

Port of ``opticommpy_tpu/kernels/mimo_pallas.py``: the single-signal kernel
(K2, ``_mimo_eq_run_windows``) and the batched one (K3,
``_mimo_eq_run_batch_windows``), which runs B independent signals in one
launch, bit-identical per signal to K2. Per symbol: the filter output
``o = H @ w`` of the window ``w``, the
rule's error ``e``, and the rank-1 update ``H += mu * e * conj(g)`` with
``g = w`` (``g = w / P_mode`` for nlms). Rules: ``'lms'`` (reference symbols
for the first ``n_train`` symbols of the pass, decisions after), ``'nlms'``,
``'cma'``, ``'rde'`` and ``'da-rde'``.

Layouts: ``sig_pad`` is the (rows, modes) padded signal; the window of
symbol k of a pass starting at symbol ``n_start`` is rows
``(n_start + k) * sps`` ... ``+ n_taps``, flattened tap-major/mode-minor
(lane ``t * modes + i``). Taps travel in that flat layout, ``(modes,
modes * n_taps)``.

The batched layouts add a leading signal axis: ``(B, rows, modes)`` padded
signals, ``(B, length, modes)`` references and outputs, ``(B, modes, modes
* n_taps)`` taps.

:func:`mimo_eq_stage` and :func:`mimo_eq_stage_batch` route by device: a
CPU tensor goes to the plain version, a CUDA tensor to the kernel, which
either launches or raises. ``launches`` counts the single-signal launches
(K2), ``batch_launches`` the batched ones (K3).
"""

import numpy as np
import torch

from opticommpy_torch.kernels import _build
from opticommpy_torch.kernels._build import device_tables
from opticommpy_torch.kernels.bps import _quantize, _square_qam_levels
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["mimo_eq_kernel", "mimo_eq_kernel_batch", "mimo_lms_kernel", "mimo_eq_stage",
           "mimo_eq_stage_batch", "mimo_eq_stage_plain",
           "mimo_eq_stage_batch_plain", "stage_aux",
           "chunk_symbols", "launches", "batch_launches"]

launches = 0  # K2 launches made by mimo_eq_stage on CUDA tensors
batch_launches = 0  # K3 launches made by mimo_eq_stage_batch on CUDA tensors

_ALG_CODE = {"lms": 0, "nlms": 1, "cma": 2, "rde": 3, "da-rde": 4}
# limits of csrc/mimo_eq.cu: register tiles up to 8 modes x 256 lanes,
# constellation and radii tables of 1024 entries in shared memory
_MAX_MODES, _MAX_WIDTH, _MAX_TABLE = 8, 256, 1024
_REF_NEEDED = dict.fromkeys(("lms", "nlms", "da-rde"),
                            "symb_ref is required for alg='lms'/'nlms'/'da-rde'")


def stage_aux(alg, const_np):
    """The rule's aux vector: the CMA radius, or the RDE radii."""
    if alg == "cma":
        return np.array([np.mean(np.abs(const_np) ** 4)
                         / np.mean(np.abs(const_np) ** 2)], np.float32)
    if alg == "rde":
        return np.unique(np.round(np.abs(const_np), 6)).astype(np.float32)
    return np.zeros(1, np.float32)


def chunk_symbols(modes, n_taps, sps):
    """Symbols per chunk that ``csrc/mimo_eq.cu`` stages in shared memory
    for a pass of this shape (builds the library: CUDA only)."""
    return int(_build.load_library().mimo_eq_chunk(modes, modes * n_taps, sps * modes))


def _check_args(sig_pad, ref, h_flat, alg, sps, n_taps, n_start, length):
    """Validate the batched layouts (a leading signal axis on every tensor)."""
    if alg not in _ALG_CODE:
        raise ValueError(f"unknown alg {alg}")
    if sig_pad.ndim != 3:
        raise ValueError(f"sig_pad must be (B, rows, modes), got {tuple(sig_pad.shape)}")
    n_batch, rows, modes = sig_pad.shape
    if (n_start + length - 1) * sps + n_taps > rows and length > 0:
        raise ValueError("sig_pad is too short for the requested windows")
    if tuple(ref.shape) != (n_batch, length, modes):
        raise ValueError(f"ref must be ({n_batch}, {length}, {modes}), "
                         f"got {tuple(ref.shape)}")
    if tuple(h_flat.shape) != (n_batch, modes, modes * n_taps):
        raise ValueError(f"taps must be ({n_batch}, {modes}, {modes * n_taps})")


def mimo_eq_stage_batch_plain(sig_pad, ref, h_flat, const, aux, alg, mu,
                              n_train, sps, n_taps, n_start, length):
    """One pass of B independent recurrences in plain PyTorch (any device).

    Every op acts on each signal's rows alone, so signal b's result does
    not depend on the other signals. Returns (y (B, length, modes)
    complex64, taps (B, modes, modes*n_taps)).
    """
    _check_args(sig_pad, ref, h_flat, alg, sps, n_taps, n_start, length)
    dev = sig_pad.device
    n_batch, _, modes = sig_pad.shape
    width = modes * n_taps
    const = np.asarray(const).astype(np.complex64)
    grid = _square_qam_levels(const.real, const.imag)
    c_re = torch.as_tensor(const.real.copy(), device=dev)
    c_im = torch.as_tensor(const.imag.copy(), device=dev)
    aux_t = torch.as_tensor(np.asarray(aux, np.float32), device=dev)

    flat = sig_pad.to(torch.complex64).reshape(n_batch, -1)[:, n_start * sps * modes:]
    win = flat.unfold(1, width, sps * modes)[:, :length].transpose(0, 1)
    w_re, w_im = win.real, win.imag  # (length, B, width)
    ref = ref.to(torch.complex64).transpose(0, 1)
    r_re, r_im = ref.real, ref.imag  # (length, B, modes)
    hr = h_flat.real.to(torch.float32).clone()  # (B, modes, width)
    hi = h_flat.imag.to(torch.float32).clone()
    # per-mode window power (nlms): mode of lane l is l % modes
    mode_of_lane = (torch.arange(width, device=dev) % modes
                    == torch.arange(modes, device=dev)[:, None]).to(torch.float32)
    y_re = torch.empty((length, n_batch, modes), dtype=torch.float32, device=dev)
    y_im = torch.empty_like(y_re)

    for k in range(length):
        wr, wi = w_re[k][:, None, :], w_im[k][:, None, :]  # (B, 1, width)
        o_re = (hr * wr - hi * wi).sum(-1)  # (B, modes)
        o_im = (hr * wi + hi * wr).sum(-1)
        p_out = o_re * o_re + o_im * o_im
        if alg in ("lms", "nlms"):
            if k < n_train:
                t_re, t_im = r_re[k], r_im[k]
            elif grid is not None:
                t_re, t_im = _quantize(o_re, *grid), _quantize(o_im, *grid)
            else:
                d2 = (o_re[..., None] - c_re) ** 2 + (o_im[..., None] - c_im) ** 2
                ind = torch.argmin(d2, dim=-1)
                t_re, t_im = c_re[ind], c_im[ind]
            e_re, e_im = t_re - o_re, t_im - o_im
        else:
            if alg == "cma":
                err = aux_t[0] - p_out
            elif alg == "rde":
                d2 = (torch.sqrt(p_out)[..., None] - aux_t) ** 2
                r_dec = aux_t[torch.argmin(d2, dim=-1)]
                err = r_dec * r_dec - p_out
            else:  # da-rde
                err = (r_re[k] * r_re[k] + r_im[k] * r_im[k]) - p_out
            e_re, e_im = err * o_re, err * o_im
        if alg == "nlms":
            pw = wr * wr + wi * wi  # (B, 1, width)
            p_mode = (pw * mode_of_lane).sum(-1, keepdim=True)  # (B, modes, 1)
            p_mode = torch.clamp((p_mode * mode_of_lane).sum(1, keepdim=True),
                                 min=1e-12)  # back on the lanes: (B, 1, width)
            g_re, g_im = wr / p_mode, wi / p_mode
        else:
            g_re, g_im = wr, wi
        e_re, e_im = e_re[..., None], e_im[..., None]
        hr = hr + mu * (e_re * g_re + e_im * g_im)
        hi = hi + mu * (e_im * g_re - e_re * g_im)
        y_re[k] = o_re
        y_im[k] = o_im
    y = torch.complex(y_re, y_im).transpose(0, 1).contiguous()
    return y, torch.complex(hr, hi)


def mimo_eq_stage_plain(sig_pad, ref, h_flat, const, aux, alg, mu, n_train,
                        sps, n_taps, n_start, length):
    """One pass of the recurrence in plain PyTorch (any device): the batched
    plain version with B = 1.

    Returns (y (length, modes) complex64, taps (modes, modes*n_taps)).
    """
    y, h = mimo_eq_stage_batch_plain(sig_pad[None], ref[None], h_flat[None],
                                     const, aux, alg, mu, n_train, sps, n_taps,
                                     n_start, length)
    return y[0], h[0]


def _mimo_eq_stage_cuda(sig_pad, ref, h_flat, const, aux, alg, mu, n_train,
                        sps, n_taps, n_start, length):
    """Launch K2 (B == 1) or K3 on (B, ...) CUDA tensors; one launch."""
    _check_args(sig_pad, ref, h_flat, alg, sps, n_taps, n_start, length)
    dev = sig_pad.device
    n_batch, rows, modes = sig_pad.shape
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
    c_re, c_im, aux_t = device_tables(const, aux, dev)
    sig_pad = sig_pad.to(torch.complex64).contiguous()
    ref = ref.to(device=dev, dtype=torch.complex64).contiguous()
    h0 = h_flat.to(device=dev, dtype=torch.complex64).contiguous()
    y = torch.empty((n_batch, length, modes), dtype=torch.complex64, device=dev)
    h_out = torch.empty_like(h0)
    with torch.cuda.device(dev):
        code = lib.mimo_eq_launch(
            n_batch, _build.ptr(sig_pad), rows * modes, n_start * sps * modes,
            sps * modes, int(length), modes, width, _build.ptr(ref),
            _build.ptr(c_re), _build.ptr(c_im), int(c_re.shape[0]),
            _build.ptr(aux_t), int(aux_t.shape[0]), int(grid is not None),
            float(lo), float(step), float(top), _ALG_CODE[alg], float(mu),
            int(n_train), _build.ptr(h0), _build.ptr(h_out), _build.ptr(y),
            _build.stream_ptr(dev))
    _build.check(code, "mimo_eq_launch")
    return y, h_out


def _stage_args(sig_pad, ref, h_flat, const, aux, alg, mu, n_train, sps,
                n_taps, n_start, length):
    if sig_pad.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mimo_eq: unsupported device {sig_pad.device}")
    return (sig_pad, ref, h_flat, const, aux, alg, float(mu), int(n_train),
            int(sps), int(n_taps), int(n_start), int(length))


def mimo_eq_stage(sig_pad, ref, h_flat, const, aux, alg, mu, n_train, sps,
                  n_taps, n_start, length):
    """One pass of the recurrence: K2 on CUDA, the plain version on CPU.

    ``sig_pad`` is (rows, modes); ``ref`` holds the pass's ``length``
    reference symbols; ``const`` is the numpy constellation, ``aux`` the
    rule's :func:`stage_aux` vector. Returns (y (length, modes) complex64,
    taps (modes, modes*n_taps)).
    """
    global launches
    args = _stage_args(sig_pad, ref, h_flat, const, aux, alg, mu, n_train,
                       sps, n_taps, n_start, length)
    if sig_pad.device.type == "cpu":
        return mimo_eq_stage_plain(*args)
    y, h = _mimo_eq_stage_cuda(sig_pad[None], ref[None], h_flat[None], *args[3:])
    launches += 1
    return y[0], h[0]


def mimo_eq_stage_batch(sig_pad, ref, h_flat, const, aux, alg, mu, n_train,
                        sps, n_taps, n_start, length):
    """One pass of B independent recurrences: K3 on CUDA (one launch, one
    CTA per signal), the batched plain version on CPU.

    ``sig_pad`` is (B, rows, modes), ``ref`` (B, length, modes), ``h_flat``
    (B, modes, modes*n_taps). Returns (y (B, length, modes) complex64,
    taps (B, modes, modes*n_taps)).
    """
    global batch_launches
    args = _stage_args(sig_pad, ref, h_flat, const, aux, alg, mu, n_train,
                       sps, n_taps, n_start, length)
    if sig_pad.device.type == "cpu":
        return mimo_eq_stage_batch_plain(*args)
    out = _mimo_eq_stage_cuda(*args)
    batch_launches += 1
    return out


def _kernel_inputs(sig, symb_ref, ref_needed, n_taps, sps, H0):
    """Pad (B, N, modes) signals and set up references and taps.

    ``ref_needed`` is the error message when ``symb_ref`` is None and the
    rule needs it (None: zeros stand in). Returns (sig_pad (B, rows,
    modes), ref (B, nSym, modes), H0 (B, modes, modes, n_taps), central
    spike by default). The padding covers every window of the nSym live
    symbols; no window past them is built.
    """
    dev = sig.device
    n_batch, n, modes = sig.shape
    if symb_ref is None:
        if ref_needed:
            raise ValueError(ref_needed)
        symb_ref = torch.zeros((n_batch, n // sps, modes), dtype=torch.complex64,
                               device=dev)
    symb_ref = torch.as_tensor(symb_ref).to(dev, torch.complex64)
    n_sym = symb_ref.shape[1]
    if H0 is None:
        h0 = torch.zeros((n_batch, modes, modes, n_taps), dtype=torch.complex64,
                         device=dev)
        h0[:, torch.arange(modes), torch.arange(modes), n_taps // 2] = 1.0
    else:
        h0 = torch.as_tensor(H0).to(dev, torch.complex64)
    l_pad = n_taps // 2
    tail = max(l_pad + sps + n_taps, (n_sym - 1) * sps + n_taps - n - l_pad)
    sig_pad = torch.zeros((n_batch, l_pad + n + tail, modes), dtype=torch.complex64,
                          device=dev)
    sig_pad[:, l_pad:l_pad + n] = sig
    return sig_pad, symb_ref, h0


def _flat(H):
    """(..., modes, modes, n_taps) taps -> (..., modes, modes*n_taps) flat."""
    return H.transpose(-1, -2).reshape(*H.shape[:-2], -1)


def _taps(h_flat, n_taps):
    """(..., modes, modes*n_taps) flat taps -> (..., modes, modes, n_taps)."""
    modes = h_flat.shape[-2]
    return h_flat.reshape(*h_flat.shape[:-1], n_taps, modes).transpose(-1, -2)


def mimo_eq_kernel(sig, symb_ref, const, alg="lms", n_taps=15, sps=2,
                   mu=2e-3, n_train=10000, H0=None):
    """NxN adaptive equalizer with a selectable update rule (port of
    ``mimo_eq_pallas``).

    ``sig`` is (N, modes) at ``sps`` samples/symbol; ``symb_ref`` the
    (nSym, modes) reference (None for the blind rules). Returns (equalized
    symbols (nSym, modes) complex64, taps H (modes, modes, n_taps)).
    """
    sig = as_device_tensor(sig)
    const = np.asarray(const).astype(np.complex64)
    sig_pad, ref, h0 = _kernel_inputs(
        sig[None], None if symb_ref is None else torch.as_tensor(symb_ref)[None],
        _REF_NEEDED.get(alg), n_taps, sps,
        None if H0 is None else torch.as_tensor(H0)[None])
    y, h = mimo_eq_stage(sig_pad[0], ref[0], _flat(h0[0]), const,
                         stage_aux(alg, const), alg, mu, n_train, sps, n_taps,
                         0, ref.shape[1])
    return y, _taps(h, n_taps)


def mimo_lms_kernel(sig, symb_ref, const, n_taps=15, sps=2, mu=2e-3, n_train=10000, H0=None):
    """The 2x2 LMS equalizer, data-aided then decision-directed (port of
    ``mimo_lms_pallas``): :func:`mimo_eq_kernel` with ``alg='lms'``."""
    return mimo_eq_kernel(sig, symb_ref, const, "lms", n_taps, sps, mu, n_train, H0)


def mimo_eq_kernel_batch(sig, symb_ref, const, alg="lms", n_taps=15, sps=2,
                         mu=2e-3, n_train=10000, H0=None):
    """B signals' adaptive equalizers in one pass (port of
    ``mimo_eq_pallas_batch``): K3 on CUDA, one launch.

    ``sig`` is (B, N, modes); ``symb_ref`` (B, nSym, modes) (None for the
    blind rules); ``H0`` optional (B, modes, modes, n_taps). Per signal the
    result equals :func:`mimo_eq_kernel`. Returns (y (B, nSym, modes)
    complex64, H (B, modes, modes, n_taps)).
    """
    sig = as_device_tensor(sig)
    const = np.asarray(const).astype(np.complex64)
    sig_pad, ref, h0 = _kernel_inputs(sig, symb_ref, _REF_NEEDED.get(alg),
                                      n_taps, sps, H0)
    y, h = mimo_eq_stage_batch(sig_pad, ref, _flat(h0), const,
                               stage_aux(alg, const), alg, mu, n_train, sps,
                               n_taps, 0, ref.shape[1])
    return y, _taps(h, n_taps)
