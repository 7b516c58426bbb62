"""The adaptive Manakov step's elementwise work: the Hopper kernels of
``csrc/ssfm_pass.cu`` (K16).

No Pallas counterpart: the JAX package leaves the step's elementwise work
to XLA. On a field on the card, ``models/channels.py`` runs a step's start
as :func:`power_kernel` (with the step rule), the forward FFT,
:func:`lin_kernel` (forming the linear half-step operator) and an
unnormalized inverse FFT, and each trapezoidal pass as
:func:`rotate_kernel`, the forward FFT, :func:`lin_kernel`, the
unnormalized inverse FFT and :func:`converge_kernel`. cuFFT
(``torch.fft``) does the transforms. Each kernel has a complex64 and a
complex128 instance: the field's dtype picks it.

The plain twins are the solver's PyTorch ops, its CPU route:
``channels._power_plain``, ``channels._rotate_plain``,
``channels._converge_sums_plain``, ``torch.exp(lin_arg * (hz / 2))`` and
the product by the operator before a normalized inverse FFT. The kernels
round every operation of the rule as those ops round it on the card
(``hypot`` for ``abs``, ``exp`` and ``sincos`` as the complex exponential,
a number over a tensor as the reciprocal times the number), so on the card
they give the complex64 ops' fields, steps and passes bit for bit; only
the two sums differ in their last bits: the kernels take them in double
and in a fixed order, so two runs give the same bits.

Each wrapper checks its arguments before anything is built, and raises
``ValueError`` on a tensor that is not on a CUDA device, not complex64 or
complex128 (float32 or float64 beside them), not contiguous, or not of the
field's shape. A call launches its kernels on the current stream and does
not synchronize. ``launches`` counts the kernels that ran for the caller
and ``passes`` the trapezoidal passes among them (:func:`rotate_kernel`'s
launches): a CUDA graph's replays included (:func:`replayed`), its warm-up
and capture not (:func:`uncounted`). The reducing launches
(:func:`power_kernel`, :func:`converge_kernel`) share one scratch per
device, so they run on one stream at a time.
"""

import ctypes

import torch

from opticommpy_torch.kernels import _build

__all__ = ["power_kernel", "lin_kernel", "rotate_kernel", "converge_kernel", "uncounted",
           "replayed", "launches", "passes"]

launches = 0  # kernels launched for the caller, replays included
passes = 0  # of them, rotate_kernel's: the trapezoidal passes K16 ran
_scratch = {}  # device -> the reducing launches' tickets and partials
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _fail(msg):
    raise ValueError(f"ssfm_pass kernel: {msg}")


def _check(name, t, dtype, shape=None):
    if not isinstance(t, torch.Tensor):
        _fail(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        _fail(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        _fail(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        _fail(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_complex(name, t):
    """The real dtype beside the complex tensor ``t``'s."""
    if not isinstance(t, torch.Tensor):
        _fail(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype not in _REAL:
        _fail(f"{name} must be complex64 or complex128, got {t.dtype}")
    _check(name, t, t.dtype)
    return _REAL[t.dtype]


def _check_field(name, e):
    if isinstance(e, torch.Tensor) and (e.ndim != 3 or e.shape[0] != 2 or e.numel() == 0):
        _fail(f"{name} must be a non-empty (2, B, N) field, got {tuple(e.shape)}")
    return _check_complex(name, e)


def _on_card(**tensors):
    """The one CUDA device of the given tensors (None entries skipped)."""
    dev = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            _fail(f"{name} must be on a CUDA device, got {t.device} (the plain twins are the "
                  "PyTorch ops of models/channels.py)")
        if dev is not None and t.device != dev:
            _fail(f"{name} is on {t.device}, the field on {dev}")
        dev = t.device if dev is None else dev
    return dev


def _f64(t):
    return int(t.dtype == torch.complex128)


def _opt(t):
    return None if t is None else _build.ptr(t)


def _scratch_for(device, lib):
    buf = _scratch.get(device)
    if buf is None:
        buf = _scratch[device] = torch.zeros(lib.ssfm_scratch_bytes(), dtype=torch.uint8,
                                             device=device)
    return buf


def _launched(code, name, pass_=False):
    global launches, passes
    _build.check(code, name)
    launches += 1
    passes += pass_


def uncounted(fn):
    """``(fn(), (launches, passes))``: the K16 launches and passes ``fn``
    made, taken off the counts: a CUDA graph's warm-up, or its capture,
    whose launches run at each replay (:func:`replayed`)."""
    global launches, passes
    before = launches, passes
    out = fn()
    made = launches - before[0], passes - before[1]
    launches, passes = before
    return out, made


def replayed(made, times=1):
    """Count ``times`` replays of a CUDA graph whose capture made ``made``
    (:func:`uncounted`'s counts)."""
    global launches, passes
    launches += made[0] * times
    passes += made[1] * times


def power_kernel(e, gamma, step=None, reduce_max=None):
    """The step's start on the (2, B, N) field ``e``: ``(pch, phi_max, hz)``,
    the start-of-step power ``|ex|^2 + |ey|^2`` (B, N), the maximum of the
    rotation ``(8/9) gamma (pch + |ex|^2 + |ey|^2) / 2`` (a 0-dim tensor)
    and, with ``step = (z, span_end, max_rot, status)``, the step size
    ``min(max_rot / phi_max, span_end - z)`` (0-dim), with ``z`` advanced by
    it in place and ``status[1]`` set to whether ``z < span_end`` after it;
    ``hz`` None without ``step``. ``reduce_max`` (a function that reduces
    ``phi_max`` in place, such as an all-reduce) runs between the maximum
    and the step rule, which then takes a launch of its own."""
    real = _check_field("e", e)
    z = span_end = status = None
    max_rot = 0.0
    if step is not None:
        z, span_end, max_rot, status = step
        _check("z", z, real, ())
        _check("span_end", span_end, real, ())
        _check("status", status, real, (2,))
    dev = _on_card(e=e, z=z, span_end=span_end, status=status)
    lib = _build.load_library()
    pch = torch.empty(e.shape[1:], dtype=real, device=dev)
    phi_max = torch.empty((), dtype=real, device=dev)
    hz = None if step is None else torch.empty((), dtype=real, device=dev)
    fused = reduce_max is None
    with torch.cuda.device(dev):
        code = lib.ssfm_power_launch(
            _f64(e), _build.ptr(e), e.shape[1] * e.shape[2], (8 / 9) * gamma, _build.ptr(pch),
            _build.ptr(_scratch_for(dev, lib)), _build.ptr(phi_max), _opt(z if fused else None),
            _opt(span_end), max_rot, _opt(hz), _opt(status), _build.stream_ptr(dev))
    _launched(code, "ssfm_power_launch")
    if not fused:
        reduce_max(phi_max)
    if step is not None and not fused:
        with torch.cuda.device(dev):
            code = lib.ssfm_step_launch(_f64(e), _build.ptr(phi_max), _build.ptr(z),
                                        _build.ptr(span_end), max_rot, _build.ptr(hz),
                                        _build.ptr(status), _build.stream_ptr(dev))
        _launched(code, "ssfm_step_launch")
    return pch, phi_max, hz


def lin_kernel(spec, lin_op=None, lin_arg=None, hz=None):
    """The spectrum ``spec`` (rows, ..., N) times the linear operator and
    times 1/N, in place, for an unnormalized inverse FFT after it; the
    operator is ``lin_op`` (N,), or, given ``lin_arg`` (N,) and the 0-dim
    step size ``hz``, ``exp(lin_arg * hz / 2)``, formed into a new tensor.
    Returns the operator."""
    if isinstance(spec, torch.Tensor) and (spec.ndim < 1 or spec.numel() == 0):
        _fail(f"spec must be non-empty, got {tuple(spec.shape)}")
    real = _check_complex("spec", spec)
    n = spec.shape[-1]
    if (lin_op is None) == (lin_arg is None):
        _fail("give lin_op, or lin_arg with hz")
    if lin_arg is not None:
        _check("lin_arg", lin_arg, spec.dtype, (n,))
        _check("hz", hz, real, ())
    else:
        _check("lin_op", lin_op, spec.dtype, (n,))
    dev = _on_card(spec=spec, lin_op=lin_op, lin_arg=lin_arg, hz=hz)
    rows = spec.numel() // n
    if rows > 2**31 - 1:
        _fail(f"{rows} rows is too many")
    lib = _build.load_library()
    if lin_op is None:
        lin_op = torch.empty_like(lin_arg)
    with torch.cuda.device(dev):
        code = lib.ssfm_lin_launch(_f64(spec), _build.ptr(spec), n, rows, _opt(lin_arg),
                                   _opt(hz), _build.ptr(lin_op), 1 / n, _build.stream_ptr(dev))
    _launched(code, "ssfm_lin_launch")
    return lin_op


def rotate_kernel(e_conv, e_hd, pch, hz, gamma, nl_sign=1.0):
    """A trapezoidal pass's rotation, ``e_hd * exp(1j * nl_sign * phi * hz)``
    with ``phi = (8/9) gamma (pch + |ex|^2 + |ey|^2) / 2`` of the pass's
    estimate ``e_conv`` (both (2, B, N)); ``pch`` (B, N); ``hz`` a 0-dim
    real tensor or a number. Returns a new field."""
    real = _check_field("e_conv", e_conv)
    _check("e_hd", e_hd, e_conv.dtype, e_conv.shape)
    _check("pch", pch, real, e_conv.shape[1:])
    hz_t = hz if isinstance(hz, torch.Tensor) else None
    if hz_t is not None:
        _check("hz", hz_t, real, ())
    if nl_sign not in (1.0, -1.0):
        _fail(f"nl_sign must be 1 or -1, got {nl_sign}")
    dev = _on_card(e_conv=e_conv, e_hd=e_hd, pch=pch, hz=hz_t)
    lib = _build.load_library()
    out = torch.empty_like(e_conv)
    with torch.cuda.device(dev):
        code = lib.ssfm_rotate_launch(
            _f64(e_conv), _build.ptr(e_conv), _build.ptr(e_hd), _build.ptr(pch),
            e_conv.shape[1] * e_conv.shape[2], (8 / 9) * gamma, float(nl_sign), _opt(hz_t),
            0.0 if hz_t is not None else float(hz), _build.ptr(out), _build.stream_ptr(dev))
    _launched(code, "ssfm_rotate_launch", pass_=True)
    return out


def converge_kernel(e_fd, e_conv, status=None, write=False):
    """The pass's convergence sums, ``sum |e_fd - e_conv|^2`` and
    ``sum |e_conv|^2``, over two fields of one shape. With ``status`` (2,)
    real, its ``[0]`` takes ``sqrt(num) / sqrt(den)`` and None is
    returned; otherwise a (2,) real tensor of the two sums. ``write``
    copies ``e_fd`` over ``e_conv`` in the same pass."""
    if isinstance(e_fd, torch.Tensor) and e_fd.numel() == 0:
        _fail("e_fd must be non-empty")
    real = _check_complex("e_fd", e_fd)
    _check("e_conv", e_conv, e_fd.dtype, e_fd.shape)
    if status is not None:
        _check("status", status, real, (2,))
    dev = _on_card(e_fd=e_fd, e_conv=e_conv, status=status)
    lib = _build.load_library()
    sums = None if status is not None else torch.empty(2, dtype=real, device=dev)
    with torch.cuda.device(dev):
        code = lib.ssfm_converge_launch(
            _f64(e_fd), _build.ptr(e_fd), _build.ptr(e_conv), e_fd.numel(), int(bool(write)),
            _build.ptr(_scratch_for(dev, lib)), _opt(sums), _opt(status),
            _build.stream_ptr(dev))
    _launched(code, "ssfm_converge_launch")
    return sums
