"""Blind phase search: the Hopper kernel ``csrc/bps.cu`` and its plain version.

Port of ``opticommpy_tpu/kernels/bps_pallas.py``. Each symbol is rotated by
``n_phases`` test phases over [0, pi/2); for each, the minimum distance to
the constellation is taken (per axis in O(1) for a square-QAM grid, as a
min over the M points otherwise); the distances are summed over a
(2*n_half+1)-symbol window, and the argmin gives the phase index. Symbols
beyond either end of the signal are zero, as in the TPU kernel.

:func:`bps_indices` routes by device: a CPU tensor goes to
:func:`bps_indices_plain`, a CUDA tensor to the kernel, which either launches
or raises. ``launches`` counts kernel launches.
"""

import math

import numpy as np
import torch

from opticommpy_torch.kernels import _build
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["bps_kernel", "bps_indices", "bps_indices_plain", "launches"]

launches = 0  # kernel launches made by bps_indices on CUDA tensors

_TILE = 256  # output symbols per CTA
_SMEM_LIMIT = 200 * 1024  # bytes of dynamic shared memory a CTA may take


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


def _quantize(x, lo, step, n_lev):
    k = torch.clamp(torch.round((x - lo) / step), 0.0, n_lev - 1.0)
    return k * step + lo


def _test_phases(n_phases, device):
    """The test-phase grid k*(pi/2)/B in f32 and its rotations."""
    phases = torch.arange(n_phases, dtype=torch.float32,
                          device=device) * (math.pi / 2) / n_phases
    return phases, torch.cos(phases), torch.sin(phases)


def _constellation(const_symb, device):
    """(c_re, c_im, qam_grid): the O(1) grid path only for a numpy array."""
    grid = None
    if isinstance(const_symb, np.ndarray):
        grid = _square_qam_levels(const_symb.real, const_symb.imag)
    c = torch.as_tensor(const_symb).to(device, torch.complex64)
    return c.real.contiguous(), c.imag.contiguous(), grid


def bps_indices_plain(sig, n_half, const_symb, n_phases):
    """Plain PyTorch phase indices (N, modes) for (N, modes) ``sig``.

    Same arithmetic, in the same order, as ``csrc/bps.cu``: the window sum
    adds its 2*n_half+1 terms one after another.
    """
    n, modes = sig.shape
    c_re, c_im, grid = _constellation(const_symb, sig.device)
    _, rot_re, rot_im = _test_phases(n_phases, sig.device)
    sp = torch.zeros((n + 2 * n_half, modes), dtype=torch.complex64,
                     device=sig.device)
    sp[n_half:n_half + n] = sig
    s_re = sp.real[:, :, None]
    s_im = sp.imag[:, :, None]
    z_re = s_re * rot_re - s_im * rot_im  # (N + 2*n_half, modes, B)
    z_im = s_re * rot_im + s_im * rot_re
    if grid is not None:
        lo, step, n_lev = grid
        dr = z_re - _quantize(z_re, lo, step, n_lev)
        di = z_im - _quantize(z_im, lo, step, n_lev)
        dist = dr * dr + di * di
    else:
        dist = torch.full_like(z_re, math.inf)
        for m in range(c_re.shape[0]):
            dr = z_re - c_re[m]
            di = z_im - c_im[m]
            dist = torch.minimum(dist, dr * dr + di * di)
    sums = torch.zeros((n, modes, n_phases), dtype=torch.float32,
                       device=sig.device)
    for j in range(2 * n_half + 1):
        sums = sums + dist[j:j + n]
    return torch.argmin(sums, dim=-1)


def _bps_indices_cuda(sig, n_half, const_symb, n_phases):
    global launches
    lib = _build.load_library()
    sig = sig.to(torch.complex64).contiguous()
    n, modes = sig.shape
    c_re, c_im, grid = _constellation(const_symb, sig.device)
    _, rot_re, rot_im = _test_phases(n_phases, sig.device)
    tile = _TILE
    while (tile + 2 * n_half) * n_phases * 4 > _SMEM_LIMIT and tile > 32:
        tile //= 2
    if (tile + 2 * n_half) * n_phases * 4 > _SMEM_LIMIT:
        raise ValueError(f"BPS window {2 * n_half + 1} x {n_phases} phases "
                         "does not fit the kernel's shared memory")
    lo, step, top = (grid[0], grid[1], grid[2] - 1.0) if grid else (0.0, 1.0, 0.0)
    out = torch.empty((n, modes), dtype=torch.int32, device=sig.device)
    if n == 0:
        return out.long()
    with torch.cuda.device(sig.device):
        code = lib.bps_launch(
            _build.ptr(sig), n, modes, _build.ptr(rot_re), _build.ptr(rot_im),
            int(n_phases), _build.ptr(c_re), _build.ptr(c_im),
            int(c_re.shape[0]), int(grid is not None), float(lo), float(step),
            float(top), int(n_half), tile, _build.ptr(out),
            _build.stream_ptr(sig.device))
    _build.check(code, "bps_launch")
    launches += 1
    return out.long()


def bps_indices(sig, n_half, const_symb, n_phases):
    """Phase indices (N, modes): the kernel on CUDA, the plain version on CPU."""
    if sig.ndim != 2 or int(n_half) < 0 or int(n_phases) < 1:
        raise ValueError("bps: sig must be (N, modes), n_half >= 0, n_phases >= 1")
    if sig.device.type == "cuda":
        return _bps_indices_cuda(sig, int(n_half), const_symb, int(n_phases))
    if sig.device.type == "cpu":
        return bps_indices_plain(sig, int(n_half), const_symb, int(n_phases))
    raise ValueError(f"bps: unsupported device {sig.device}")


def bps_kernel(sig, n_half, const_symb, n_phases):
    """Fused BPS phase estimation (drop-in for ``carrier_recovery.bps``).

    ``sig`` is (N,) or (N, modes) complex; ``const_symb`` the (M,)
    constellation (a numpy array enables the O(1) square-QAM distance).
    Returns the estimated phases in [0, pi/2) per symbol (and mode).
    """
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    phases, _, _ = _test_phases(int(n_phases), sig.device)
    est = phases[bps_indices(sig, n_half, const_symb, n_phases)]
    return est[:, 0] if squeeze else est
