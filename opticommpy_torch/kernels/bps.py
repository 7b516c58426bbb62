"""Blind phase search: the Hopper kernel ``csrc/bps.cu`` and its plain version.

Port of ``opticommpy_tpu/kernels/bps_pallas.py``. Each symbol is rotated by
``n_phases`` test phases over [0, pi/2); for each, the minimum distance to
the constellation is taken (per axis in O(1) for a square-QAM grid, as a
min over the M points otherwise); the distances are summed over a
(2*n_half+1)-symbol window, and the argmin gives the phase index. Symbols
beyond either end of the signal are zero, as in the TPU kernel.

The window sums are block prefix and suffix sums (:func:`_window_sums_plain`):
the kernel and the plain version add in that order and agree bit for bit.

:func:`bps_indices` routes by device: a CPU tensor goes to
:func:`bps_indices_plain`, a CUDA tensor to the kernel, which either launches
or raises. ``launches`` counts kernel launches.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from opticommpy_torch.kernels import _build
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["bps_kernel", "bps_indices", "bps_indices_plain", "slicer_tables",
           "bps_exact_check", "launches"]

launches = 0  # kernel launches made by bps_indices / bps_kernel on CUDA tensors

# the kernel's distance routes (csrc/bps.cu, Route)
GRID4, GRID_SEARCH, POINTS = 0, 1, 2
MAX_GRID_LEVELS = 256  # levels per axis the kernel's slicer tables hold
_OUT_INDEX, _OUT_PHASE = 0, 1


def _square_qam_levels(c_re, c_im, tol=1e-5):
    """(lo, step, L) if the constellation is a uniform square grid, else None."""
    re = np.unique(np.round(np.asarray(c_re) / tol) * tol)
    im = np.unique(np.round(np.asarray(c_im) / tol) * tol)
    if len(re) != len(im) or len(re) < 2:
        return None
    if len(re) * len(im) != len(np.asarray(c_re)):
        return None
    steps = np.diff(re)
    if not (np.allclose(re, im, atol=tol) and np.allclose(steps, steps[0], atol=tol)):
        return None
    # every (re, im) combination must be present
    pts = {(round(float(a) / tol), round(float(b) / tol))
           for a, b in zip(np.asarray(c_re), np.asarray(c_im))}
    if len(pts) != len(re) * len(im):
        return None
    return float(re[0]), float(steps[0]), int(len(re))


def _qam_grid(const_symb):
    """``_square_qam_levels`` of a NumPy constellation, cached by content
    (the test costs ~0.1 ms of host time a call); None for anything else:
    the O(1) grid path is only for a NumPy array, as in the JAX package."""
    if not isinstance(const_symb, np.ndarray):
        return None
    a = np.ascontiguousarray(const_symb)
    return _qam_grid_of(a.dtype.str, a.shape, a.tobytes())


@lru_cache(maxsize=64)
def _qam_grid_of(dtype, shape, data):
    a = np.frombuffer(data, dtype).reshape(shape)
    return _square_qam_levels(a.real, a.imag)


def _quantize(x, lo, step, n_lev):
    k = torch.clamp(torch.round((x - lo) / step), 0.0, n_lev - 1.0)
    return k * step + lo


def _slice_plain(x, lo, step, n_lev):
    """The grid slicer with a true division: a CUDA tensor divided by a
    Python float is multiplied by its reciprocal instead, so the step is a
    0-dim tensor on x's device."""
    step_t = torch.full((), step, dtype=torch.float32, device=x.device)
    k = torch.clamp(torch.round(torch.div(x - lo, step_t)), 0.0, n_lev - 1.0)
    return k * step + lo


@lru_cache(maxsize=64)
def _test_phases(n_phases, device):
    """The test-phase grid k*(pi/2)/B in f32 and its rotations, computed
    once per device; shared between calls, never written."""
    phases = torch.arange(n_phases, dtype=torch.float32,
                          device=device) * (math.pi / 2) / n_phases
    return phases, torch.cos(phases), torch.sin(phases)


def _constellation(const_symb, device):
    """(c_re, c_im, qam_grid): the O(1) grid path only for a numpy array."""
    c = torch.as_tensor(const_symb).to(device, torch.complex64)
    return c.real.contiguous(), c.imag.contiguous(), _qam_grid(const_symb)


def _to_key(y):
    """Order-preserving int64 key of float32 values (NaN excluded)."""
    u = np.asarray(y, np.float32).view(np.uint32).astype(np.int64)
    return np.where(u >= 2**31, 2**32 - 1 - u, u + 2**31)


def _from_key(k):
    k = np.asarray(k, np.int64)
    u = np.where(k >= 2**31, k - 2**31, 2**32 - 1 - k)
    return u.astype(np.uint32).view(np.float32)


def slicer_index(x, lo, step, n_lev):
    """The grid slicer's level index with NumPy's float32 division, the
    kernel's former rule: clip(rint((x - lo) / step), 0, L - 1), NaN to 0."""
    lo, step = np.float32(lo), np.float32(step)
    with np.errstate(all="ignore"):
        k = np.rint((np.asarray(x, np.float32) - lo) / step)
        return np.fmin(np.fmax(k, np.float32(0)), np.float32(n_lev - 1))


def slicer_tables(lo, step, n_lev):
    """(route, thr, lev) of the kernel's division-free grid slicer.

    ``thr[k]``, 1 <= k < L, is the least float32 x whose level index
    (:func:`slicer_index`) is at least k, found by bisection over the
    ordered float32 values with the slicer's own float32 operations;
    ``thr[0]`` is -inf and entries past L - 1 +inf. ``lev[k] = k * step +
    lo`` in float32, the last level repeated past L - 1. The index is a
    monotone step function of x, so the level of x is ``lev[#{k >= 1: x >=
    thr[k]}]``: NaN takes level 0, +inf the top one. Tables have 4 entries
    up to 4 levels (route ``GRID4``, selects in registers), else the next
    power of two (``GRID_SEARCH``, a binary search). Read-only arrays, cached
    per grid.
    """
    return _slicer_tables(float(np.float32(lo)), float(np.float32(step)), int(n_lev))


@lru_cache(maxsize=64)
def _slicer_tables(lo, step, n_lev):
    if not 2 <= n_lev <= MAX_GRID_LEVELS:
        raise ValueError(f"bps: {n_lev} levels per axis (2 to {MAX_GRID_LEVELS})")
    n_tab = 4 if n_lev <= 4 else 1 << (n_lev - 1).bit_length()
    lo_k = np.full(n_lev - 1, _to_key(np.float32(-np.inf)), np.int64)
    hi_k = np.full(n_lev - 1, _to_key(np.float32(np.inf)), np.int64)
    want = np.arange(1, n_lev, dtype=np.float32)
    while np.any(lo_k < hi_k):  # least key whose index reaches the level
        mid = (lo_k + hi_k) // 2
        up = slicer_index(_from_key(mid), lo, step, n_lev) >= want
        hi_k = np.where(up, mid, hi_k)
        lo_k = np.where(up, lo_k, mid + 1)
    thr = np.full(n_tab, np.inf, np.float32)
    thr[0] = -np.inf
    thr[1:n_lev] = _from_key(lo_k)
    k = np.minimum(np.arange(n_tab), n_lev - 1).astype(np.float32)
    lev = k * np.float32(step) + np.float32(lo)
    thr.setflags(write=False)
    lev.setflags(write=False)
    return (GRID4 if n_tab == 4 else GRID_SEARCH), thr, lev


def _distances_plain(sp, const_symb, n_phases):
    """Minimum squared constellation distance (Q, modes, B) of the padded
    symbols ``sp`` (Q, modes) at every test phase, in the kernel's order."""
    c_re, c_im, grid = _constellation(const_symb, sp.device)
    _, rot_re, rot_im = _test_phases(n_phases, sp.device)
    s_re = sp.real[:, :, None]
    s_im = sp.imag[:, :, None]
    z_re = s_re * rot_re - s_im * rot_im  # (Q, modes, B)
    z_im = s_re * rot_im + s_im * rot_re
    if grid is not None:
        lo, step, n_lev = grid
        dr = z_re - _slice_plain(z_re, lo, step, n_lev)
        di = z_im - _slice_plain(z_im, lo, step, n_lev)
        return dr * dr + di * di
    dist = torch.full_like(z_re, math.inf)
    for m in range(c_re.shape[0]):
        dr = z_re - c_re[m]
        di = z_im - c_im[m]
        dist = torch.minimum(dist, dr * dr + di * di)
    return dist


def _window_sums_plain(dist, n, w):
    """Sums of ``w`` consecutive rows of ``dist`` (Q, ...) starting at rows
    0 .. n-1, Q a multiple of w with Q >= n + w - 1: block suffix and prefix
    sums, each serial over the w rows of a block (blocks counted from row
    0), the window at a block start its suffix sum, elsewhere the suffix sum
    of its first block plus the prefix sum of the next. Every term is >= 0,
    so there is no cancellation; ``csrc/bps.cu`` adds in this order."""
    d = dist.reshape(dist.shape[0] // w, w, *dist.shape[1:])
    suf = torch.empty_like(d)
    pre = torch.empty_like(d)
    suf[:, w - 1] = d[:, w - 1]
    for i in range(w - 2, -1, -1):
        suf[:, i] = d[:, i] + suf[:, i + 1]
    pre[:, 0] = d[:, 0]
    for i in range(1, w):
        pre[:, i] = pre[:, i - 1] + d[:, i]
    win = suf[:-1].clone()
    win[:, 1:] = win[:, 1:] + pre[1:, :w - 1]
    return win.reshape(-1, *dist.shape[1:])[:n]


def bps_indices_plain(sig, n_half, const_symb, n_phases):
    """Plain PyTorch phase indices (N, modes) int64 for (N, modes) ``sig``.

    The same arithmetic, in the same order, as ``csrc/bps.cu``: the grid
    slicer with a true division (the kernel's thresholds decide alike on
    every float32), the window sums of :func:`_window_sums_plain`.
    """
    n, modes = sig.shape
    w = 2 * n_half + 1
    q = (-(-n // w) + 1) * w  # whole blocks, the last one only for prefix sums
    sp = torch.zeros((q, modes), dtype=torch.complex64, device=sig.device)
    sp[n_half:n_half + n] = sig
    dist = _distances_plain(sp, const_symb, n_phases)
    return torch.argmin(_window_sums_plain(dist, n, w), dim=-1)


def _kernel_tables(const_symb, device):
    """(route, tab0, tab1, n_tab) for bps_launch: the grid slicer's tables, or
    the constellation as complex64, on ``device`` without a copy per call
    (a tensor already there is used as it is; anything else is looked up
    by content)."""
    if isinstance(const_symb, torch.Tensor):
        if const_symb.device == device:
            c = const_symb.to(torch.complex64).contiguous()
            return POINTS, c, c, int(c.numel())
        const_symb = const_symb.detach().cpu().numpy()
        grid_ok = False
    else:
        grid_ok = isinstance(const_symb, np.ndarray)  # as in the JAX package
    a = np.ascontiguousarray(const_symb)
    return _kernel_tables_of(a.dtype.str, a.shape, a.tobytes(), grid_ok, device)


@lru_cache(maxsize=64)
def _kernel_tables_of(dtype, shape, data, grid_ok, device):
    a = np.frombuffer(data, dtype).reshape(shape)
    grid = _square_qam_levels(a.real, a.imag) if grid_ok else None
    if grid is not None:
        route, thr, lev = slicer_tables(*grid)
        thr_t, lev_t = _build.device_arrays((thr, lev), device)
        return route, thr_t, lev_t, len(thr)
    pts = np.ascontiguousarray(a.ravel(), np.complex64)
    (c,) = _build.device_arrays((pts,), device)
    return POINTS, c, c, int(c.numel())


@lru_cache(maxsize=None)
def _smem_limit(device):
    """Shared memory a CTA may take on ``device`` (bytes)."""
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", 232448)  # an H100's


def _launch(sig, n_half, const_symb, n_phases, out_kind, run_blocks=0):
    """One launch of the kernel on CUDA ``sig`` (N, modes): int64 indices or
    float32 phases (N, modes)."""
    global launches
    lib = _build.load_library()
    if sig.dtype != torch.complex64 or not sig.is_contiguous():
        sig = sig.to(torch.complex64).contiguous()
    n, modes = sig.shape
    dev = sig.device
    route, tab0, tab1, n_tab = _kernel_tables(const_symb, dev)
    phases, rot_re, rot_im = _test_phases(n_phases, dev)
    if n_phases > 512:
        raise ValueError(f"bps: {n_phases} test phases (the kernel takes up to 512)")
    smem = lib.bps_smem_bytes(n_half, n_phases, route, n_tab)
    limit = _smem_limit(dev)
    if smem > limit:
        raise ValueError(f"bps: window {2 * n_half + 1} x {n_phases} phases needs {smem} "
                         f"bytes of shared memory, more than the {limit} a CTA may take")
    dtype = torch.int64 if out_kind == _OUT_INDEX else torch.float32
    out = torch.empty((n, modes), dtype=dtype, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        code = lib.bps_launch(
            _build.ptr(sig), n, modes, _build.ptr(rot_re), _build.ptr(rot_im), n_phases,
            route, _build.ptr(tab0), _build.ptr(tab1), n_tab, n_half, int(run_blocks),
            out_kind, _build.ptr(phases), _build.ptr(out), _build.stream_ptr(dev))
    _build.check(code, "bps_launch")
    launches += 1
    return out


def _check_args(sig, n_half, n_phases):
    if sig.ndim != 2 or int(n_half) < 0 or int(n_phases) < 1:
        raise ValueError("bps: sig must be (N, modes), n_half >= 0, n_phases >= 1")
    if sig.device.type not in ("cuda", "cpu"):
        raise ValueError(f"bps: unsupported device {sig.device}")


def bps_indices(sig, n_half, const_symb, n_phases):
    """Phase indices (N, modes) int64: the kernel on CUDA, the plain version on CPU."""
    _check_args(sig, n_half, n_phases)
    if sig.device.type == "cuda":
        return _launch(sig, int(n_half), const_symb, int(n_phases), _OUT_INDEX)
    return bps_indices_plain(sig, int(n_half), const_symb, int(n_phases))


def bps_kernel(sig, n_half, const_symb, n_phases):
    """Fused BPS phase estimation (drop-in for ``carrier_recovery.bps``).

    ``sig`` is (N,) or (N, modes) complex; ``const_symb`` the (M,)
    constellation (a numpy array enables the O(1) square-QAM distance).
    Returns the estimated phases in [0, pi/2) per symbol (and mode). On
    CUDA one launch writes the phases.
    """
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    _check_args(sig, n_half, n_phases)
    if sig.device.type == "cuda":
        est = _launch(sig, int(n_half), const_symb, int(n_phases), _OUT_PHASE)
    else:
        phases = _test_phases(int(n_phases), sig.device)[0]
        est = phases[bps_indices_plain(sig, int(n_half), const_symb, int(n_phases))]
    return est[:, 0] if squeeze else est


def bps_exact_check(lo, step, n_lev, device):
    """Count of float32 inputs (of all 2^32) whose level the kernel's
    threshold slicer for the grid (lo, step, n_lev) takes otherwise than the
    true division, and up to four of them: ``(count, [bit patterns])``.
    Runs on ``device`` (CUDA) once per grid and device, then cached."""
    return _bps_exact_check(float(np.float32(lo)), float(np.float32(step)), int(n_lev),
                            torch.device(device))


@lru_cache(maxsize=64)
def _bps_exact_check(lo, step, n_lev, device):
    lib = _build.load_library()
    route, thr, lev = slicer_tables(lo, step, n_lev)
    thr_t, lev_t = _build.device_arrays((thr, lev), device)
    bad = torch.zeros(5, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        _build.check(lib.bps_exact_check(0, 1 << 32, route, _build.ptr(thr_t), _build.ptr(lev_t),
                                         len(thr), lo, step, float(n_lev - 1), _build.ptr(bad),
                                         _build.stream_ptr(device)), "bps_exact_check")
    counts = bad.tolist()  # synchronizes
    return counts[0], counts[1:1 + min(counts[0], 4)]
