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
Q entries. The kernel spreads them over ``LANES`` lanes of a warp grouped
by order (h1's lanes, then h2's, then h3's), ``S`` slots each, S the least
of ``SLOT_INSTANCES`` that fits (:func:`lane_layout`); a lane sums its
slots by a pairwise tree, and the lane sums by a butterfly, whose result
is the pairwise tree over the lanes. The plain version computes the same
products and sums them in the same order, vectorized over lanes, so the
two agree bit for bit. The kernel's slicer compares ``y`` with host
thresholds (:func:`slicer_thresholds`) where the plain version divides;
the thresholds decide exactly as the division does.

:func:`volterra_run` routes by device: a CPU tensor goes to
:func:`volterra_pass_plain`, a CUDA tensor to the kernel, which either
launches or raises. ``launches`` counts kernel launches.
"""

from functools import lru_cache

import numpy as np
import torch

from opticommpy_torch.comm.modulation import norm_const
from opticommpy_torch.kernels import _build
from opticommpy_torch.ops.signal import pnorm_rows
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["volterra_run", "volterra_pass_plain", "volterra_kernel", "feature_table",
           "lane_layout", "kernel_table", "slicer_thresholds", "launches"]

launches = 0  # kernel launches made by volterra_run on CUDA tensors

LANES = 32  # lanes of the kernel's adapting loop: one warp
SLOT_INSTANCES = (1, 2, 3, 4, 5, 6, 7, 8, 10, 13, 16, 24, 32)  # the kernel's S
MAX_LEVELS = 16  # slicer levels the kernel decides by thresholds


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


@lru_cache(maxsize=64)
def lane_layout(n1, n2, n3, order):
    """The kernel's layout of the flat taps over ``LANES`` lanes: (S, table
    (LANES, S, 4) int32, lane order (LANES,) int32). Lanes are grouped by
    order, h1's first; order k's taps fill ceil(count / S) lanes in flat
    order, S consecutive taps a lane; S is the least of ``SLOT_INSTANCES``
    that fits every order. ``table[l, s]`` holds the three window indices
    of the feature (``n1`` stands for 1.0, ``n1 + 1`` for 0.0) and the flat
    tap (-1 for a dead slot, whose feature is 0.0); idle lanes have order 0.
    The arrays are shared between calls and must not be written."""
    idx, kind = feature_table(n1, n2, n3, order)
    counts = [int((kind == k).sum()) for k in (1, 2, 3)]
    fits = [S for S in SLOT_INSTANCES if sum(-(-c // S) for c in counts) <= LANES]
    if not fits:
        raise ValueError(f"volterra: {idx.shape[1]} taps do not fit the kernel's {LANES} lanes "
                         f"of at most {SLOT_INSTANCES[-1]} slots")
    S = fits[0]
    table = np.full((LANES, S, 4), n1 + 1, np.int32)
    table[:, :, 3] = -1
    lane_order = np.zeros(LANES, np.int32)
    lane = 0
    for k, c in zip((1, 2, 3), counts):
        taps = np.flatnonzero(kind == k)
        for i, q in enumerate(taps):
            table[lane + i // S, i % S, :3] = idx[:, q]
            table[lane + i // S, i % S, 3] = q
        used = -(-c // S)
        lane_order[lane:lane + used] = k
        lane += used
    table.setflags(write=False)
    lane_order.setflags(write=False)
    return S, table, lane_order


@lru_cache(maxsize=64)
def kernel_table(n1, n2, n3, order):
    """(S, the kernel's int32 table): :func:`lane_layout`'s table, row-major,
    then the lanes' orders (C-contiguous: the kernel reads it by offsets).
    The array is shared between calls and must not be written."""
    S, table, lane_order = lane_layout(n1, n2, n3, order)
    out = np.ascontiguousarray(np.concatenate([table.ravel(), lane_order]), dtype=np.int32)
    out.setflags(write=False)
    return S, out


def _tree_lanes(p):
    """Pairwise tree over the last axis of ``p`` (n entries): s[i] += s[i +
    h] for the live pairs, h from the power of two below n down to 1; the
    kernel's Tree and Butterfly. Returns the sum, the last axis dropped."""
    n = p.shape[-1]
    h = 1
    while h < n:
        h *= 2
    h //= 2
    while h >= 1:
        m = n - h
        if m > 0:
            p = torch.cat([p[..., :m] + p[..., h:h + m], p[..., m:h]], dim=-1)
        else:
            p = p[..., :h]
        n = min(n, h)
        p = p[..., :n]
        h //= 2
    return p[..., 0]


def slicer_thresholds(levels):
    """(n_levels, thr (31,) float32) of the grid slicer ``clip(rint((y -
    lo) / step), 0, L - 1) * step + lo`` over the sorted ``levels``:
    ``thr[i]``, i < 15, is the least float32 y that the slicer takes to
    level i + 1 (NaN past the last), ``thr[15 + i]`` level i's value
    ``i * step + lo`` in float32. The slicer is a monotone step function of
    y, so it takes y to level ``#{i: y >= thr[i]}``; the thresholds are
    found by bisection over the float32 values with the slicer's own
    float32 operations. More than 16 levels: thresholds are not used (the
    kernel divides). The array is shared between calls and must not be
    written."""
    levels = np.asarray(levels, np.float32)
    return _slicer_thresholds(levels.tobytes())


@lru_cache(maxsize=64)
def _slicer_thresholds(levels_bytes):
    levels = np.frombuffer(levels_bytes, np.float32)
    n = len(levels)
    lo = np.float32(levels[0])
    step = np.float32(levels[1] - levels[0]) if n > 1 else np.float32(1.0)
    top = np.float32(n - 1)
    out = np.full(2 * MAX_LEVELS - 1, np.nan, np.float32)
    out[MAX_LEVELS - 1:] = levels[0]
    if n > MAX_LEVELS:
        out.setflags(write=False)
        return n, out

    def decide(keys):
        with np.errstate(over="ignore", invalid="ignore"):
            y = _from_key(keys)
            return np.clip(np.rint((y - lo) / step), np.float32(0), top)

    lo_k = np.full(n - 1, _to_key(np.float32(-np.inf)), np.int64)
    hi_k = np.full(n - 1, _to_key(np.float32(np.inf)), np.int64)
    want = np.arange(1, n, dtype=np.float32)
    while np.any(lo_k < hi_k):  # least key whose decision reaches the level
        mid = (lo_k + hi_k) // 2
        up = decide(mid) >= want
        hi_k = np.where(up, mid, hi_k)
        lo_k = np.where(up, lo_k, mid + 1)
    out[:n - 1] = _from_key(lo_k)
    out[MAX_LEVELS - 1:MAX_LEVELS - 1 + n] = np.arange(n, dtype=np.float32) * step + lo
    out.setflags(write=False)
    return n, out


def _to_key(y):
    """Order-preserving int64 key of float32 values (NaN excluded)."""
    u = np.asarray(y, np.float32).view(np.uint32).astype(np.int64)
    return np.where(u >= 2**31, 2**32 - 1 - u, u + 2**31)


def _from_key(k):
    k = np.asarray(k, np.int64)
    u = np.where(k >= 2**31, k - 2**31, 2**32 - 1 - k)
    return u.astype(np.uint32).view(np.float32)


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
    rule). The taps are summed in the order of the kernel's layout over
    ``LANES`` lanes (:func:`lane_layout`). Returns (y (B, n_sym), mse (B,
    n_sym), h (B, Q)), ``y`` before the output ``pnorm``.
    """
    _check(sig_pad, ref, h0, n_sym, sps, n1)
    dev = sig_pad.device
    f32 = dict(dtype=torch.float32, device=dev)
    n_q = feature_table(n1, n2, n3, order)[0].shape[1]
    if h0.shape[1] != n_q:
        raise ValueError(f"volterra: taps must be (B, {n_q})")
    _, table, lane_order = lane_layout(n1, n2, n3, order)
    idx_t = torch.as_tensor(table[:, :, :3].astype(np.int64), device=dev)  # (lanes, S, 3)
    q = table[:, :, 3]
    live = torch.as_tensor(q >= 0, device=dev)
    q_t = torch.as_tensor(np.where(q >= 0, q, 0).astype(np.int64), device=dev)
    n_b = sig_pad.shape[0]
    wins = sig_pad.to(torch.float32).unfold(1, n1, sps)[:, :n_sym]  # (B, n_sym, n1)
    ext = torch.cat([wins, torch.ones((n_b, n_sym, 1), **f32),
                     torch.zeros((n_b, n_sym, 1), **f32)], dim=2)
    ref = ref.to(torch.float32)
    h = torch.where(live, h0.to(torch.float32)[:, q_t], torch.zeros((), **f32))  # (B, lanes, S)
    lo, step = float(levels[0]), float(levels[1] - levels[0]) if len(levels) > 1 else 1.0
    top = float(len(levels) - 1)
    step_t = torch.tensor(step, **f32)  # device divisors: true divisions on CUDA
    seven = torch.tensor(7.0, **f32)
    lev_t = torch.as_tensor(np.asarray(levels, np.float32), device=dev)
    # a lane's update gain by its order: 0 (idle) and 3 take g / 7, as the kernel
    pick = torch.as_tensor(np.where(lane_order == 0, 3, lane_order).astype(np.int64) - 1,
                           device=dev)
    y = torch.empty((n_b, n_sym), **f32)
    mse = torch.empty((n_b, n_sym), **f32)

    for k in range(n_sym):
        x = ext[:, k]  # (B, n1 + 2)
        phi = (x[:, idx_t[..., 0]] * x[:, idx_t[..., 1]]) * x[:, idx_t[..., 2]]
        yk = _tree_lanes(_tree_lanes(h * phi))
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
            gq = torch.stack([g, 0.5 * g, g / seven], dim=1)[:, pick]  # (B, lanes)
            h = h + gq[:, :, None] * phi
        y[:, k] = yk
        mse[:, k] = e * e
    h_flat = torch.zeros((n_b, n_q), **f32)
    h_flat[:, q_t[live]] = h[:, live]
    return y, mse, h_flat


def _volterra_cuda(sig_pad, ref, h0, n_sym, sps, n1, n2, n3, order, levels, mu, n_train,
                   fulltime):
    global launches
    _check(sig_pad, ref, h0, n_sym, sps, n1)
    for name, t in (("sig_pad", sig_pad), ("ref", ref), ("h0", h0)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != sig_pad.device:
            raise ValueError(f"volterra: {name} must be a contiguous float32 tensor on "
                             "the signal's device")
    n_q = feature_table(n1, n2, n3, order)[0].shape[1]
    if h0.shape[1] != n_q:
        raise ValueError(f"volterra: taps must be (B, {n_q})")
    if n1 > 32:
        raise ValueError("volterra: the kernel takes n1Taps <= 32")
    lib = _build.load_library()
    dev = sig_pad.device
    slots, table = kernel_table(n1, n2, n3, order)
    n_levels, thr = slicer_thresholds(levels)
    table_t, thr_t = _build.device_arrays((table, thr), dev)
    lo, step = float(levels[0]), float(levels[1] - levels[0]) if len(levels) > 1 else 1.0
    n_b = sig_pad.shape[0]
    y = torch.empty((n_b, n_sym), dtype=torch.float32, device=dev)
    mse = torch.empty_like(y)
    h_out = torch.empty_like(h0)
    with torch.cuda.device(dev):
        code = lib.volterra_launch(
            n_b, _build.ptr(sig_pad), sig_pad.shape[1], n_sym, sps, _build.ptr(ref), n1, n2,
            n3, order, n_q, slots, _build.ptr(table_t), n_levels, _build.ptr(thr_t), lo, step,
            float(len(levels) - 1), float(mu), int(n_train), int(bool(fulltime)),
            _build.ptr(h0), _build.ptr(h_out), _build.ptr(y), _build.ptr(mse),
            _build.stream_ptr(dev))
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
