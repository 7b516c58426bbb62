"""Gardner clock recovery (PI loop + NCO): the Hopper kernel
``csrc/gardner.cu`` and its plain version.

Port of ``opticommpy_tpu/kernels/gardner_pallas.py`` (K6). Per mode, one
iteration at a time while ``n < n_out - 1`` and ``m < n_in - 2``: the
cubic Farrow value at the NCO timing ``t`` from ``x[m-2 : m+2]`` is written
to ``eo[n]``; on even ``n`` the Gardner timing error of ``eo[n-2 : n+1]``
(classic, or the Nyquist form) drives the PI loop filter; then the NCO
skips or stuffs a sample (``n`` moves by -1, +1 or +2, ``m`` by 0 or 1) and
``t_vals[clip(n, 0, n_out - 1)] = t``. The output buffers start at zero,
so an index the NCO stepped over keeps zero, or the value written there
before a backstep, exactly as in the JAX package's ``lax.while_loop``
(``dsp/clock_recovery.py``, ``_gardner_one_mode``).

Both versions do the same float32 operations in the same order (the
interpolator's expression of ``clock_recovery.py:53-58``, ``t**3`` as
``(t*t)*t``), so a skip/stuff decision never parts them. Both stop after
``max_iters(n_in)`` iterations, far more than any finite input needs: a
guard against an input that is not finite, on which the reference's loop
never ends.

:func:`gardner_records` routes by device: a CPU tensor goes to
:func:`gardner_plain`, a CUDA tensor to the kernel, which either launches
or raises. ``launches`` counts kernel launches.
"""

import numpy as np
import torch

from opticommpy_torch.kernels import _build

__all__ = ["gardner_kernel", "gardner_records", "gardner_plain", "max_iters", "launches"]

launches = 0  # kernel launches made by gardner_records on CUDA tensors

_F32 = {name: np.float32(v) for name, v in
        (("m6", -1 / 6), ("p6", 1 / 6), ("p3", 1 / 3), ("h", 1 / 2), ("mh", -1 / 2))}


def max_iters(n_in):
    """The iteration cap of both versions (see the module docstring)."""
    return 2 * n_in + 64


def _check(sig, n_out):
    if sig.ndim != 2 or not sig.is_complex():
        raise ValueError("gardner: sig must be a complex (n_in, modes) tensor")
    if sig.shape[0] < 5 or not 3 <= n_out:
        raise ValueError("gardner: need n_in >= 5 and n_out >= 3")


def gardner_plain(sig, kp, ki, is_nyquist, n_out):
    """Plain PyTorch NCO loop over all modes of ``sig`` (n_in, modes) at once.

    Returns (eo (n_out, modes) complex64, t_vals (n_out, modes) float32,
    n_final (modes,) int64).
    """
    _check(sig, n_out)
    dev = sig.device
    n_in, modes = sig.shape
    sig = sig.to(torch.complex64)
    xr, xi = sig.real.contiguous(), sig.imag.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    c = {k: torch.tensor(v, **f32) for k, v in _F32.items()}
    kp_t = torch.tensor(np.float32(kp), **f32)
    ki_t = torch.tensor(np.float32(ki), **f32)
    one = torch.tensor(1.0, **f32)
    eo_re = torch.zeros((n_out, modes), **f32)
    eo_im = torch.zeros((n_out, modes), **f32)
    tv = torch.zeros((n_out, modes), **f32)
    cols = torch.arange(modes, device=dev)
    taps = torch.arange(4, device=dev)[:, None]
    n = torch.full((modes,), 2, dtype=torch.int64, device=dev)
    m = torch.full((modes,), 2, dtype=torch.int64, device=dev)
    ip = torch.zeros(modes, **f32)
    t = torch.zeros(modes, **f32)
    for it in range(max_iters(n_in)):
        active = (n < n_out - 1) & (m < n_in - 2)
        if it % 64 == 0 and not bool(active.any()):
            break
        rows = m[None, :] - 2 + taps  # x[m-2 : m+2]
        w_re, w_im = xr[rows, cols], xi[rows, cols]
        t2 = t * t
        t3 = t2 * t
        c0 = c["m6"] * t3 + c["p6"] * t
        c1 = (c["h"] * t3 + c["h"] * t2) - t
        c2 = ((c["mh"] * t3 - t2) + c["h"] * t) + one
        c3 = (c["p6"] * t3 + c["h"] * t2) + c["p3"] * t
        v_re = ((w_re[0] * c0 + w_re[1] * c1) + w_re[2] * c2) + w_re[3] * c3
        v_im = ((w_im[0] * c0 + w_im[1] * c1) + w_im[2] * c2) + w_im[3] * c3
        n_w = n.clamp(0, n_out - 1)
        write = active & (n >= 0)
        eo_re[n_w, cols] = torch.where(write, v_re, eo_re[n_w, cols])
        eo_im[n_w, cols] = torch.where(write, v_im, eo_im[n_w, cols])
        # TED on eo[n-2 : n+1] (dynamic_slice clamps the start)
        s = (n - 2).clamp(0, n_out - 3)
        e_re = [eo_re[s + j, cols] for j in range(3)]
        e_im = [eo_im[s + j, cols] for j in range(3)]
        if is_nyquist:
            p = [e_re[j] * e_re[j] + e_im[j] * e_im[j] for j in range(3)]
            ted = p[1] * (p[0] - p[2])
        else:
            ted = e_re[1] * (e_re[2] - e_re[0]) + e_im[1] * (e_im[2] - e_im[0])
        do_ted = active & (n % 2 == 0)
        ip_new = torch.where(do_ted, ki_t * ted + ip, ip)
        t_new = torch.where(do_ted, t - (kp_t * ted + ip_new), t)
        over, under = t_new > 1.0, t_new < -1.0
        t_adj = torch.where(over, t_new - one, torch.where(under, t_new + one, t_new))
        dn = torch.where(over, -1, torch.where(under, 2, 1))
        n_next = torch.where(active, n + dn, n)
        m = torch.where(active, m + torch.where(over, 0, 1), m)
        n_t = n_next.clamp(0, n_out - 1)
        tv[n_t, cols] = torch.where(active, t_adj, tv[n_t, cols])
        n = n_next
        ip = torch.where(active, ip_new, ip)
        t = torch.where(active, t_adj, t)
    return torch.complex(eo_re, eo_im), tv, n


def _gardner_cuda(sig, kp, ki, is_nyquist, n_out):
    global launches
    _check(sig, n_out)
    lib = _build.load_library()
    sig = sig.to(torch.complex64).contiguous()
    n_in, modes = sig.shape
    eo = torch.zeros((n_out, modes), dtype=torch.complex64, device=sig.device)
    tv = torch.zeros((n_out, modes), dtype=torch.float32, device=sig.device)
    n_final = torch.empty(modes, dtype=torch.int32, device=sig.device)
    with torch.cuda.device(sig.device):
        code = lib.gardner_launch(
            _build.ptr(sig), n_in, modes, n_out, float(np.float32(kp)),
            float(np.float32(ki)), int(bool(is_nyquist)), max_iters(n_in),
            _build.ptr(eo), _build.ptr(tv), _build.ptr(n_final),
            _build.stream_ptr(sig.device))
    _build.check(code, "gardner_launch")
    launches += 1
    return eo, tv, n_final.long()


def gardner_records(sig, kp, ki, is_nyquist, n_out):
    """(eo, t_vals, n_final) of the NCO loop: the kernel on CUDA, the plain
    version on CPU. ``sig`` is the (n_in, modes) input, already padded."""
    if sig.device.type == "cuda":
        return _gardner_cuda(sig, kp, ki, is_nyquist, n_out)
    if sig.device.type == "cpu":
        return gardner_plain(sig, kp, ki, is_nyquist, n_out)
    raise ValueError(f"gardner: unsupported device {sig.device}")


def gardner_kernel(sig, config=None, return_timing=False, static_out=False):
    """Gardner clock recovery on K6 (port of ``gardner_pallas``): a drop-in
    for :func:`opticommpy_torch.dsp.clock_recovery.gardner_clock_recovery`
    with ``backend='pallas'``."""
    from opticommpy_torch.dsp.clock_recovery import ClockRecoveryConfig, gardner_clock_recovery

    return gardner_clock_recovery(sig, config if config is not None else ClockRecoveryConfig(),
                                  return_timing, "pallas", static_out)
