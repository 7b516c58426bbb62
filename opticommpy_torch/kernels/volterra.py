"""Decision-directed Volterra LMS equalizer: the Hopper kernel
``csrc/volterra.cu`` and its plain version.

Port of ``opticommpy_tpu/kernels/volterra_pallas.py`` (K14). On real
samples, every signal of a (B, N) batch runs its own recurrence; per
symbol, with the window ``x`` of ``n1`` samples at stride ``sps`` and its
centred sub-windows ``x2`` (``n2`` samples from ``t2 = (n1 - n2)//2``) and
``x3`` (``n3`` from ``t3``):

- ``y = sum_q h[q] phi[q]`` over the features ``phi``: ``x[t]`` for h1,
  ``x2[j]*x2[i]`` for ``h2[j, i]`` and ``(x3[i]*x3[j])*x3[m]`` for
  ``h3[i, j, m]`` (order 3 only);
- the O(1) PAM slicer ``clip(round((y - lo)/step), 0, L-1)*step + lo``,
  or with ``grid=False`` an argmin over the levels;
- the target: the reference while ``k < n_train``, else the decision;
  ``e = target - y``, ``mse = e*e``;
- while training, or always with ``fulltime``: ``g = e*mu`` and
  ``h[q] += g_q * phi[q]`` with ``g_q = g`` for h1, ``0.5*g`` for h2 and
  ``g/7`` for h3.

The taps are one flat vector per signal, ``[h1, h2 (row-major), h3]``, of
Q entries. Feature ``q`` belongs to lane ``q % 32`` and slot ``q // 32`` of
a warp: the kernel sums each lane's slots in slot order, then the 32 lane
sums by a butterfly, whose result on lane 0 is the pairwise tree
``s[i] += s[i + h]``, h = 16, ..., 1. The plain version computes the same
partial sums in the same order, vectorized over lanes, so the two agree
bit for bit.

:func:`volterra_run` routes by device: a CPU tensor goes to
:func:`volterra_pass_plain`, a CUDA tensor to the kernel, which either
launches or raises. ``launches`` counts kernel launches.
"""

import numpy as np
import torch

from opticommpy_torch.comm.modulation import norm_const
from opticommpy_torch.kernels import _build
from opticommpy_torch.ops.signal import pnorm_rows
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["volterra_run", "volterra_pass_plain", "volterra_kernel", "feature_table",
           "kernel_table", "launches"]

launches = 0  # kernel launches made by volterra_run on CUDA tensors

LANES = 32
MAX_SLOTS = 16  # features per signal the kernel holds: 32 * MAX_SLOTS


def feature_table(n1, n2, n3, order):
    """(idx (3, Q) int64, kind (Q,) int64) of the flat features: ``phi[q] =
    (x[idx[0, q]] * x[idx[1, q]]) * x[idx[2, q]]`` with index ``n1`` standing
    for 1.0; kind 1, 2 or 3 is the order of the tap. h1's features come
    first, then h2's row-major, then h3's."""
    one = n1
    t2, t3 = (n1 - n2) // 2, (n1 - n3) // 2
    rows = [(t, one, one, 1) for t in range(n1)]
    rows += [(t2 + j, t2 + i, one, 2) for j in range(n2) for i in range(n2)]
    if order == 3:
        rows += [(t3 + i, t3 + j, t3 + m, 3)
                 for i in range(n3) for j in range(n3) for m in range(n3)]
    table = np.ascontiguousarray(np.asarray(rows, np.int64).T)
    return table[:3], table[3]


def kernel_table(n1, n2, n3, order):
    """The kernel's (4, Q) int32 table, row-major: the three sample indices
    of every feature and its order (C-contiguous: the kernel reads it by
    row offsets)."""
    idx, kind = feature_table(n1, n2, n3, order)
    return np.ascontiguousarray(np.concatenate([idx, kind[None]]), dtype=np.int32)


def _check(sig_pad, ref, h0, n_sym, sps, n1):
    if sig_pad.ndim != 2 or ref.shape != (sig_pad.shape[0], n_sym):
        raise ValueError("volterra: sig_pad must be (B, N) and ref (B, n_sym)")
    if h0.ndim != 2 or h0.shape[0] != sig_pad.shape[0]:
        raise ValueError("volterra: taps must be (B, Q)")
    if n_sym > 0 and (n_sym - 1) * sps + n1 > sig_pad.shape[1]:
        raise ValueError("volterra: sig_pad is too short for n_sym windows")


def _levels(M, const_type):
    """Sorted real levels of the normalized constellation (the JAX wrapper's
    host-side grid)."""
    const = np.real(norm_const(M, const_type)).astype(np.float32)
    return np.sort(np.unique(const))


def volterra_pass_plain(sig_pad, ref, h0, n_sym, sps, n1, n2, n3, order, levels, mu,
                        n_train, fulltime, grid=True):
    """One pass of B independent recurrences in plain PyTorch (any device).

    ``sig_pad`` (B, N) and ``ref`` (B, n_sym) float32; ``h0`` (B, Q) flat
    taps (see :func:`feature_table`); ``levels`` the sorted PAM levels.
    ``grid=False`` decides by the argmin over the levels (the JAX scan's
    rule). Returns (y (B, n_sym), mse (B, n_sym), h (B, Q)), ``y`` before
    the output ``pnorm``.
    """
    _check(sig_pad, ref, h0, n_sym, sps, n1)
    dev = sig_pad.device
    f32 = dict(dtype=torch.float32, device=dev)
    idx, kind = feature_table(n1, n2, n3, order)
    n_q = idx.shape[1]
    if h0.shape[1] != n_q:
        raise ValueError(f"volterra: taps must be (B, {n_q})")
    n_b = sig_pad.shape[0]
    slots = -(-n_q // LANES)
    pad = slots * LANES - n_q
    # padded features read index n1 + 1, which holds 0.0
    idx = np.concatenate([idx, np.full((3, pad), n1 + 1)], axis=1)
    kind = np.concatenate([kind, np.zeros(pad, np.int64)])
    idx_t = torch.as_tensor(idx, device=dev)
    kind_t = torch.as_tensor(kind, device=dev)
    wins = sig_pad.to(torch.float32).unfold(1, n1, sps)[:, :n_sym]  # (B, n_sym, n1)
    ext = torch.cat([wins, torch.ones((n_b, n_sym, 1), **f32),
                     torch.zeros((n_b, n_sym, 1), **f32)], dim=2)
    ref = ref.to(torch.float32)
    h = torch.cat([h0.to(torch.float32), torch.zeros((n_b, pad), **f32)], dim=1)
    lo, step = float(levels[0]), float(levels[1] - levels[0]) if len(levels) > 1 else 1.0
    top = float(len(levels) - 1)
    step_t = torch.tensor(step, **f32)  # device divisors: true divisions on CUDA
    seven = torch.tensor(7.0, **f32)
    lev_t = torch.as_tensor(np.asarray(levels, np.float32), device=dev)
    y = torch.empty((n_b, n_sym), **f32)
    mse = torch.empty((n_b, n_sym), **f32)
    zero = torch.zeros((n_b, 1), **f32)

    for k in range(n_sym):
        x = ext[:, k][:, idx_t]  # (B, 3, slots*32)
        phi = (x[:, 0] * x[:, 1]) * x[:, 2]
        p = (h * phi).reshape(n_b, slots, LANES)
        part = p[:, 0]
        for s in range(1, slots):
            part = part + p[:, s]
        while part.shape[1] > 1:
            half = part.shape[1] // 2
            part = part[:, :half] + part[:, half:]
        yk = part[:, 0]
        if k < n_train:
            t = ref[:, k]
        elif grid:
            t = torch.clamp(torch.round((yk - lo) / step_t), 0.0, top) * step + lo
        else:
            dl = yk[:, None] - lev_t
            t = lev_t[torch.argmin(dl * dl, dim=1)]
        e = t - yk
        if fulltime or k < n_train:
            g = e * mu
            gq = torch.stack([zero[:, 0], g, 0.5 * g, g / seven], dim=1)[:, kind_t]
            h = h + gq * phi
        y[:, k] = yk
        mse[:, k] = e * e
    return y, mse, h[:, :n_q]


def _volterra_cuda(sig_pad, ref, h0, n_sym, sps, n1, n2, n3, order, levels, mu, n_train,
                   fulltime):
    global launches
    _check(sig_pad, ref, h0, n_sym, sps, n1)
    for name, t in (("sig_pad", sig_pad), ("ref", ref), ("h0", h0)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != sig_pad.device:
            raise ValueError(f"volterra: {name} must be a contiguous float32 tensor on "
                             "the signal's device")
    idx, kind = feature_table(n1, n2, n3, order)
    n_q = idx.shape[1]
    if h0.shape[1] != n_q:
        raise ValueError(f"volterra: taps must be (B, {n_q})")
    if n1 > LANES or n_q > LANES * MAX_SLOTS:
        raise ValueError(f"volterra: the kernel takes n1Taps <= {LANES} and at most "
                         f"{LANES * MAX_SLOTS} taps in all")
    lib = _build.load_library()
    dev = sig_pad.device
    table = torch.as_tensor(kernel_table(n1, n2, n3, order), device=dev)
    lo, step = float(levels[0]), float(levels[1] - levels[0]) if len(levels) > 1 else 1.0
    n_b = sig_pad.shape[0]
    y = torch.empty((n_b, n_sym), dtype=torch.float32, device=dev)
    mse = torch.empty_like(y)
    h_out = torch.empty_like(h0)
    with torch.cuda.device(dev):
        code = lib.volterra_launch(
            n_b, _build.ptr(sig_pad), sig_pad.shape[1], n_sym, sps, _build.ptr(ref), n1,
            n_q, _build.ptr(table), lo, step, float(len(levels) - 1), float(mu),
            int(n_train), int(bool(fulltime)), _build.ptr(h0), _build.ptr(h_out),
            _build.ptr(y), _build.ptr(mse), _build.stream_ptr(dev))
    _build.check(code, "volterra_launch")
    launches += 1
    return y, mse, h_out


def volterra_run(sig_pad, ref, h0, n_sym, sps, n1, n2, n3, order, levels, mu, n_train,
                 fulltime):
    """One pass of the Volterra recurrence over B signals: the kernel for
    CUDA tensors, :func:`volterra_pass_plain` for CPU tensors. Same
    arguments (without ``grid``) and outputs as :func:`volterra_pass_plain`."""
    args = (sig_pad, ref, h0, n_sym, sps, n1, n2, n3, order, levels, mu, n_train, fulltime)
    if sig_pad.device.type == "cuda":
        return _volterra_cuda(*args)
    if sig_pad.device.type == "cpu":
        return volterra_pass_plain(*args)
    raise ValueError(f"volterra: unsupported device {sig_pad.device}")


def prepare(sig, symb_ref, cfg):
    """The JAX wrapper's preprocessing (``volterra_pallas.py:155-199``): per
    row ``anorm(pnorm(.))`` of the signal and ``pnorm`` of the reference,
    padding, the zero-filled reference and the initial flat taps. A tensor
    stays on its device; a NumPy array goes to the CUDA device. Returns
    (sig_pad (B, N') float32, ref (B, n_out), h0 (B, Q), n_out, batched)."""
    if cfg.n1Taps < cfg.n2Taps or cfg.n1Taps < cfg.n3Taps:
        raise ValueError("n1Taps must be >= n2Taps and n3Taps.")
    sig = as_device_tensor(sig)
    batched = sig.ndim == 2
    if not batched:
        sig = sig[None]
    symb_ref = torch.as_tensor(symb_ref).to(sig.device)
    if symb_ref.ndim == 1:
        symb_ref = symb_ref[None]
    sig = pnorm_rows(sig)
    sig = (sig / torch.amax(torch.abs(sig), dim=1, keepdim=True)).real.to(torch.float32)
    symb_ref = pnorm_rows(symb_ref).real.to(torch.float32)
    n1 = cfg.n1Taps
    edge = sig.new_zeros((sig.shape[0], n1 // 2))
    sig_pad = torch.cat([edge, sig, edge], dim=1).contiguous()
    n_out = int((sig_pad.shape[1] - n1 + n1 % 2) // cfg.SpS)
    ref = sig.new_zeros((sig.shape[0], n_out))
    m = min(n_out, symb_ref.shape[1])
    ref[:, :m] = symb_ref[:, :m]
    n_q = feature_table(n1, cfg.n2Taps, cfg.n3Taps, cfg.order)[0].shape[1]
    h0 = sig.new_zeros((sig.shape[0], n_q))
    h0[:, n1 // 2] = 1.0
    return sig_pad, ref, h0, n_out, batched


def unflatten(h, cfg):
    """[h1 (B, n1), h2 (B, n2, n2), h3 (B, n3, n3, n3)] from flat taps (zero
    h3 at order 2, as the JAX kernel returns it)."""
    n1, n2, n3 = cfg.n1Taps, cfg.n2Taps, cfg.n3Taps
    b = h.shape[0]
    h1 = h[:, :n1]
    h2 = h[:, n1:n1 + n2 * n2].reshape(b, n2, n2)
    if cfg.order == 3:
        h3 = h[:, n1 + n2 * n2:].reshape(b, n3, n3, n3)
    else:
        h3 = h.new_zeros((b, n3, n3, n3))
    return [h1, h2, h3]


def equalize(sig, symb_ref, cfg, run=None):
    """``cfg.preconvIters`` passes of ``run`` (by default
    :func:`volterra_run`; the JAX scan passes the plain pass with its argmin
    slicer) on prepared rows; returns (y, [h1, h2, h3], mse) with the
    batching of ``sig``, ``y`` ``pnorm``-ed per row."""
    run = run or volterra_run
    sig_pad, ref, h, n_out, batched = prepare(sig, symb_ref, cfg)
    levels = _levels(cfg.M, cfg.constType)
    y = mse = None
    for _ in range(cfg.preconvIters):
        y, mse, h = run(sig_pad, ref, h, n_out, int(cfg.SpS), cfg.n1Taps, cfg.n2Taps,
                        cfg.n3Taps, int(cfg.order), levels, float(cfg.mu), int(cfg.nTrain),
                        cfg.trainingMode == "fulltime")
    y = pnorm_rows(y)
    hs = unflatten(h, cfg)
    if not batched:
        return y[0], [t[0] for t in hs], mse[0]
    return y, hs, mse


def volterra_kernel(sig, symb_ref, config):
    """Kernel Volterra equalizer (port of ``volterra_pallas``).

    ``sig``: (N,) or (B, N) real samples at ``config.SpS``; ``symb_ref``:
    (nSym,) or (B, nSym). Each row is normalized on its own and equalized by
    its own recurrence, one launch per ``preconvIters`` pass on CUDA (the
    plain version on CPU tensors). Returns (y, [h1, h2, h3], mse) with the
    batching of the input; h2 and h3 in their square and cubic shapes, ``y``
    ``pnorm``-ed per row.
    """
    return equalize(sig, symb_ref, config)
