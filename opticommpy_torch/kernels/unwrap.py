"""Phase unwrapping with the derotation fused in: the Hopper kernel
``csrc/unwrap.cu`` (K15) and its plain twin.

No Pallas counterpart: the JAX package unwraps with ``jnp.unwrap``. The
rule is ``jnp.unwrap``'s on ``x = m * phases``, with each step's
correction (:func:`step_corrections`, ``jnp.unwrap``'s operations in the
phases' precision) taken as a whole number of periods
``k_i = round(corr_i * (1 / period))``. The turns are summed as integers,
``K_i = k_1 + ... + k_i``, and the unwrapped phase is
``phases_i + (period / m) * K_i``, formed in float64 and rounded once;
with symbols ``y``, also ``y * exp(1j * theta)``. A step whose correction
is not finite makes its row and every later row of the column NaN, as a
float cumulative sum of the corrections does.

An integer scan is exact and associative, so the kernel's split of a
column over CTAs gives the same bits in every run; the kernel and
:func:`unwrap_derotate_plain` agree bit for bit on the phases, and so on
the turns, which :func:`turns` reads back from them exactly.

:func:`unwrap_derotate_kernel` takes (N, C) float32 CUDA tensors and
launches the kernel or raises. :func:`unwrap_derotate_plain` is the CPU
route of ``dsp/carrier_recovery``'s ``unwrap`` and ``unwrap_derotate``,
along any dim and in any real floating dtype, and the kernel's reference
in the tests. ``launches`` counts the kernel's calls.
"""

import math

import torch

from opticommpy_torch.kernels import _build

__all__ = ["unwrap_derotate_kernel", "unwrap_derotate_plain", "step_corrections", "turns",
           "launches"]

launches = 0  # calls of the kernel (csrc/unwrap.cu, unwrap_launch) by unwrap_derotate_kernel


def step_corrections(p, dim=0, period=2 * math.pi):
    """The correction ``jnp.unwrap`` adds at each step of ``p`` along ``dim``
    (one entry fewer than ``p``), in ``p``'s precision: the jump less its
    remainder into [-period/2, period/2), an exact half period kept with the
    jump's sign, and 0 where the jump is below half a period."""
    # Python numbers rounded to p's dtype: no copy to p's device, which
    # would wait for a CUDA stream
    interval = torch.tensor(period / 2, dtype=p.dtype).item()
    period_ = torch.tensor(period, dtype=p.dtype).item()
    dd = torch.diff(p, dim=dim)
    ddmod = torch.remainder(dd + interval, period_) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    return torch.where(torch.abs(dd) < interval, 0.0, ddmod - dd)


def _rule(m, period, dtype=torch.float32):
    """(m, period/2, period, 1/period), each rounded to ``dtype``, and the
    phase of one turn, the rounded period over the rounded m, in float64."""
    if not period > 0:
        raise ValueError(f"unwrap: period must be > 0, got {period}")
    m_t, period_t = torch.tensor(m, dtype=dtype), torch.tensor(period, dtype=dtype)
    return (m_t.item(), torch.tensor(period / 2, dtype=dtype).item(), period_t.item(),
            (1 / period_t).item(), period_t.item() / m_t.item())


def unwrap_derotate_plain(phases, y=None, m=4.0, period=2 * math.pi, dim=0):
    """The kernel's rule in PyTorch ops, on any device, along ``dim`` of
    real floating ``phases`` of any shape: ``(theta, y_out)``, the unwrapped
    phases in ``phases``' dtype and ``y * exp(1j * theta)`` (or None without
    ``y``). The turns are summed as int32 for float32 phases, as the kernel
    sums them, and as int64 otherwise."""
    m_, _, _, inv, step = _rule(m, period, phases.dtype)
    if phases.shape[dim] == 0:
        return phases.clone(), (None if y is None else y * torch.exp(1j * phases))
    corr = step_corrections(phases * m_, dim, period)
    finite = torch.isfinite(corr)
    itype = torch.int32 if phases.dtype == torch.float32 else torch.int64
    k = torch.where(finite, torch.round(corr * inv), 0.0).to(itype)
    zero = torch.zeros_like(phases.narrow(dim, 0, 1), dtype=itype)
    turns = torch.cat([zero, torch.cumsum(k, dim=dim, dtype=itype)], dim=dim)
    bad = torch.cat([zero, torch.cumsum((~finite).to(itype), dim=dim, dtype=itype)], dim=dim)
    theta = (phases.double() + step * turns.double()).to(phases.dtype)
    theta = torch.where(bad > 0, math.nan, theta)
    return theta, (None if y is None else y * torch.exp(1j * theta))


def turns(theta, phases, m=4.0, period=2 * math.pi):
    """The turn counts ``K`` (int64) of unwrapped phases ``theta``:
    ``round((theta - phases) / (period / m))`` in float64, exact while
    ``theta``'s rounding, half an ulp, stays far below half a turn."""
    step = _rule(m, period)[4]
    return torch.round((theta.double() - phases.double()) / step).to(torch.int64)


def _check_args(phases, y):
    if phases.ndim != 2 or phases.dtype != torch.float32 or not phases.is_contiguous():
        raise ValueError("unwrap kernel: phases must be a contiguous (N, C) float32 tensor, "
                         f"got {tuple(phases.shape)} {phases.dtype}"
                         f"{'' if phases.is_contiguous() else ' (not contiguous)'}")
    if y is not None and (y.shape != phases.shape or y.dtype != torch.complex64
                          or not y.is_contiguous() or y.device != phases.device):
        raise ValueError("unwrap kernel: y must be a contiguous complex64 tensor of the "
                         f"phases' shape and device, got {tuple(y.shape)} {y.dtype} on {y.device}")
    if phases.device.type != "cuda":
        raise ValueError(f"unwrap kernel: needs CUDA tensors, got {phases.device} (the plain "
                         "version is unwrap_derotate_plain)")


def unwrap_derotate_kernel(phases, y=None, m=4.0, period=2 * math.pi):
    """K15 on CUDA ``phases`` (N, C) float32 and optional ``y`` (N, C)
    complex64: ``(theta, y_out)`` as :func:`unwrap_derotate_plain`. One
    call launches two kernels on the current stream (one where N fits one
    chunk) and does not synchronize."""
    global launches
    _check_args(phases, y)
    m32, interval, period32, inv, step = _rule(m, period)
    n, cols = phases.shape
    dev = phases.device
    theta = torch.empty_like(phases)
    y_out = None if y is None else torch.empty_like(y)
    if n == 0 or cols == 0:
        return theta, y_out
    lib = _build.load_library()
    scratch = lib.unwrap_scratch_len(n, cols)
    if scratch < 0:
        raise ValueError(f"unwrap kernel: {n} x {cols} is too large")
    totals = torch.empty(2 * scratch, dtype=torch.int32, device=dev)
    opt = lambda t: None if t is None else _build.ptr(t)  # noqa: E731
    with torch.cuda.device(dev):
        code = lib.unwrap_launch(
            _build.ptr(phases), opt(y), n, cols, m32, interval, period32, inv, step,
            _build.ptr(totals), _build.ptr(theta), opt(y_out), _build.stream_ptr(dev))
    _build.check(code, "unwrap_launch")
    launches += 1
    return theta, y_out
