"""Decision-directed PLL: the Hopper kernel ``csrc/ddpll.cu``.

Port of ``opticommpy_tpu/kernels/ddpll_pallas.py`` (K7). Every column of
the (N, C) input runs its own PLL; per symbol: ``eo = x * e^{j phi}``, the
decision (an O(1) per-axis quantizer on a square-QAM grid, an argmin over
the constellation otherwise), the pilot's known symbol in its place on
pilot rows, the phase detector ``u_d = Im(eo * conj(target))``, the
second-order loop filter ``u_f = a0 u_f + a1 u_d[k-1] + a2 u_d`` and
``phi <- phi - Kv u_f``. The output is ``phi`` before its update. B
signals packed as columns give exactly the per-signal result.

The loop coefficients ``(1, a1, a2, Kv)`` are computed in NumPy and rounded
to float32 once, as the JAX wrapper computes them (``ddpll_pallas.py:165-173``).

The kernel's plain twin :func:`ddpll_plain` is a per-symbol loop of torch
ops with the kernel's own rule (the float32 coefficients, the grid
quantizer on square QAM, separate multiplies and adds in the kernel's
order, ``torch.cos`` / ``torch.sin``); the tests and ``chip_smoke.py`` hold
the kernel to it bit for bit on the card. The reference rule
:func:`opticommpy_torch.dsp.carrier_recovery.ddpll` (argmin slicer,
``exp(j phi)``) agrees with both within 2e-4 rad, as the JAX package pins
its kernel to its scan (``tests/test_pallas_kernels.py:84-113``).

:func:`ddpll_phases` routes by device: a CPU tensor goes to the reference
rule, a CUDA tensor to the kernel, which either launches or raises.
``launches`` counts kernel launches.
"""

import numpy as np
import torch

from opticommpy_torch.kernels import _build
from opticommpy_torch.kernels.bps import _square_qam_levels
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["ddpll_kernel", "ddpll_phases", "ddpll_plain", "loop_coefs", "launches"]

launches = 0  # kernel launches made by ddpll_phases on CUDA tensors

_MAX_TABLE = 1024  # constellation points the kernel's shared table holds


def loop_coefs(ts, kv, tau1, tau2):
    """(a0, a1, a2, Kv) of the loop filter in float32, from NumPy float64."""
    cot = 1 / np.tan(ts / (2 * tau2))
    return np.array([1.0, ts / (2 * tau1) * (1 - cot), ts / (2 * tau1) * (1 + cot), kv],
                    dtype=np.float32)


def _check(x, ref, pilot):
    if x.ndim != 2 or ref.shape != x.shape or pilot.shape != x.shape[:1]:
        raise ValueError("ddpll: x and ref must be (N, C), pilot (N,)")


def _slicer(const_np):
    """(use_grid, lo, step, top) as the kernel receives them: the square-QAM
    grid's float32 levels, or the argmin's placeholders."""
    grid = _square_qam_levels(const_np.real, const_np.imag)
    lo, step, top = (grid[0], grid[1], grid[2] - 1.0) if grid else (0.0, 1.0, 0.0)
    return grid is not None, *(float(np.float32(v)) for v in (lo, step, top))


def ddpll_plain(x, ref, pilot, const_np, coefs):
    """K7's plain twin: the kernel's rule as a per-symbol loop of torch ops
    on the (C,) columns of each row, on the device of ``x``.

    ``x``, ``ref`` (N, C) complex64, ``pilot`` (N,), ``const_np`` the
    constellation, ``coefs`` the float32 ``(a0, a1, a2, Kv)`` of
    :func:`loop_coefs`. Per symbol: ``eo = x e^{j phi}`` from ``torch.cos``
    and ``torch.sin``, the decision (the grid quantizer
    ``clip(round((eo - lo) / step), 0, top) * step + lo`` per axis on square
    QAM, else the first nearest point), the pilot's symbol in its place on
    pilot rows, ``u_d = Im(eo) t_re - Re(eo) t_im``, ``u_f = (a0 u_f + a1
    u_d[k-1]) + a2 u_d``, ``phi <- phi - Kv u_f``: every multiply and add a
    separate float32 op in the kernel's order. Returns the phases (N, C)
    float32 before each update. For tests and ``chip_smoke.py``.
    """
    _check(x, ref, pilot)
    dev = x.device
    x = x.to(torch.complex64)
    ref = ref.to(torch.complex64)
    n, n_cols = x.shape
    const_np = np.asarray(const_np, np.complex64)
    use_grid, lo, step, top = _slicer(const_np)
    a0, a1, a2, kv = (float(v) for v in np.asarray(coefs, np.float32))
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    rr, ri = ref.real.contiguous(), ref.imag.contiguous()
    is_pilot = (pilot.detach().cpu().numpy() != 0).tolist()
    # the quotient as a true division by a tensor: torch divides by a
    # Python scalar through its reciprocal on the card
    step_t = torch.full((n_cols,), step, dtype=torch.float32, device=dev)
    c_re = torch.as_tensor(const_np.real.copy(), device=dev)
    c_im = torch.as_tensor(const_np.imag.copy(), device=dev)

    def quantize(v):
        k = torch.round(torch.div(v - lo, step_t)).clamp(0.0, top)
        return k * step + lo

    out = torch.empty((n, n_cols), dtype=torch.float32, device=dev)
    phi = torch.zeros(n_cols, dtype=torch.float32, device=dev)
    u_f = torch.zeros_like(phi)
    u_d = torch.zeros_like(phi)
    for k in range(n):
        out[k] = phi
        c, s = torch.cos(phi), torch.sin(phi)
        eo_re = xr[k] * c - xi[k] * s
        eo_im = xr[k] * s + xi[k] * c
        if is_pilot[k]:
            t_re, t_im = rr[k], ri[k]
        elif use_grid:
            t_re, t_im = quantize(eo_re), quantize(eo_im)
        else:
            dr = eo_re[:, None] - c_re
            di = eo_im[:, None] - c_im
            best = torch.argmin(dr * dr + di * di, dim=1)
            t_re, t_im = c_re[best], c_im[best]
        u_d_new = eo_im * t_re - eo_re * t_im
        u_f = (a0 * u_f + a1 * u_d) + a2 * u_d_new
        phi = phi - kv * u_f
        u_d = u_d_new
    return out


def _ddpll_cuda(x, ref, pilot, const_np, coefs):
    global launches
    _check(x, ref, pilot)
    lib = _build.load_library()
    x = x.to(torch.complex64).contiguous()
    ref = ref.to(torch.complex64).contiguous()
    pilot = pilot.to(torch.float32).contiguous()
    n, n_cols = x.shape
    const_np = np.asarray(const_np, np.complex64)
    if const_np.shape[0] > _MAX_TABLE:
        raise ValueError(f"ddpll: at most {_MAX_TABLE} constellation points")
    use_grid, lo, step, top = _slicer(const_np)
    c = torch.as_tensor(const_np, device=x.device)
    c_re, c_im = c.real.contiguous(), c.imag.contiguous()
    a0, a1, a2, kv = (float(v) for v in np.asarray(coefs, np.float32))
    out = torch.empty((n, n_cols), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        code = lib.ddpll_launch(
            _build.ptr(x), _build.ptr(ref), _build.ptr(pilot), n, n_cols,
            _build.ptr(c_re), _build.ptr(c_im), int(const_np.shape[0]),
            int(use_grid), lo, step, top, a0, a1, a2,
            kv, _build.ptr(out), _build.stream_ptr(x.device))
    _build.check(code, "ddpll_launch")
    launches += 1
    return out


def ddpll_phases(x, ref, pilot, const_np, ts, kv, tau1, tau2):
    """DD-PLL phases (N, C) of (N, C) ``x``: the kernel on CUDA, the
    reference rule on CPU. ``ref`` (N, C) holds the known symbols, used on
    rows where ``pilot`` (N,) is nonzero."""
    if x.device.type == "cuda":
        return _ddpll_cuda(x, ref, pilot, const_np, loop_coefs(ts, kv, tau1, tau2))
    if x.device.type == "cpu":
        from opticommpy_torch.dsp.carrier_recovery import ddpll

        _check(x, ref, pilot)
        return ddpll(x, ts, kv, tau1, tau2, torch.as_tensor(np.asarray(const_np, np.complex64)),
                     symb_tx=ref, pilot_ind=np.flatnonzero(pilot.numpy()))
    raise ValueError(f"ddpll: unsupported device {x.device}")


def ddpll_kernel(sig, ts, kv, tau1, tau2, const_symb, symb_tx=None, pilot_ind=None):
    """Kernel DD-PLL (drop-in for ``carrier_recovery.ddpll``; port of
    ``ddpll_pallas``): per-symbol phase estimates of (N,) or (N, C) ``sig``.

    Each column is an independent PLL, so a batch of signals packed as
    columns is recovered in one launch. ``symb_tx`` gives the known symbols
    of the ``pilot_ind`` rows (zero columns are added if it has fewer).
    """
    sig = as_device_tensor(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    n, n_cols = sig.shape
    dev = sig.device
    ref = torch.zeros((n, n_cols), dtype=torch.complex64, device=dev)
    if symb_tx is not None:
        r = torch.as_tensor(symb_tx).to(dev, torch.complex64)
        r = r[:, None] if r.ndim == 1 else r
        ref[:, :r.shape[1]] = r
    pilot = torch.zeros(n, dtype=torch.float32, device=dev)
    if pilot_ind is not None:
        pilot[torch.as_tensor(np.asarray(pilot_ind), device=dev)] = 1.0
    est = ddpll_phases(sig.to(torch.complex64), ref, pilot,
                       np.asarray(const_symb, np.complex64), ts, kv, tau1, tau2)
    return est[:, 0] if squeeze else est
