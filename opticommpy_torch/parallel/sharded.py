"""Sharded compute paths: data-, pipeline- and sequence-parallel Manakov
SSFM, time-sharded filtering.

Port of ``opticommpy_tpu/parallel/sharded.py`` on ``torch.distributed``.
Every function takes the whole (global) tensor on every rank and returns
the whole result on every rank, as a JAX global array goes in and comes
out: each rank keeps its own block of the input (the block its mesh
coordinates name), computes on it, and the blocks are all-gathered.

- **Data parallelism** (:func:`manakov_ssf_dp`): the signal batch is split
  over the mesh's ``data`` dim. Fixed-step propagation needs no
  communication; the adaptive step and the trapezoid's convergence test
  read the whole batch through one all-reduce each, so every rank steps as
  the unsplit call does. The EDFA draws the whole batch's noise on every
  rank, so the result equals :func:`manakov_ssf`'s for every ``amp``.
- **Sequence parallelism** (:func:`sharded_fir`, :func:`sharded_edc`,
  :func:`manakov_ssf_sp`): the time axis is split over the ``time`` dim;
  each rank gets halo samples from its neighbours by point-to-point
  messages (``dist.batch_isend_irecv``) and filters or propagates its
  block.
- **Pipeline parallelism** (:func:`manakov_ssf_pp`): spans are split into
  stages, one per rank of a ``stage`` dim; microbatches of the batch go
  from stage to stage by point-to-point messages.

Complex tensors travel as ``torch.view_as_real`` pairs (halos, stage
hand-offs) or as raw bytes (gathers, broadcasts), so no backend sees a
complex dtype. A mesh dim of size 1 posts no message: a circular halo from
oneself is a local copy.
"""

from collections import namedtuple

import numpy as np
import torch
import torch.distributed as dist

from opticommpy_torch.models.channels import (_amplify, _lin_arg, _manakov_span,
                                              _manakov_spans, _to_columns, _to_pol_stacked,
                                              fiber_coefficients)
from opticommpy_torch.ops.filtering import _as_tensor, _fft_conv_same
from opticommpy_torch.parallel.mesh import NamedSharding, P
from opticommpy_torch.utils.profiling import count
from opticommpy_torch.utils.rng import as_device_tensor, ensure_generator

__all__ = [
    "sharded_fir",
    "sharded_edc",
    "manakov_ssf_dp",
    "manakov_ssf_pp",
    "manakov_ssf_sp",
    "shard_batch",
    "default_sp_halo",
]

_Axis = namedtuple("_Axis", "size index ranks group")


def _axis(mesh, name):
    """This rank's view of mesh dim ``name``: its size, this rank's index
    along it, the global ranks along it in order, and its process group
    (None for a dim of size 1). ``name=None`` is a dim of size 1."""
    if name is None:
        return _Axis(1, 0, [dist.get_rank()], None)
    names = mesh.mesh_dim_names
    if name not in names:
        raise ValueError(f"mesh has no dim {name!r} (dims {names})")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    d = names.index(name)
    at = list(coord)
    at[d] = slice(None)
    ranks = mesh.mesh[tuple(at)].tolist()
    group = mesh.get_group(name) if len(ranks) > 1 else None
    return _Axis(len(ranks), coord[d], ranks, group)


def _local_block(x, mesh, spec):
    """This rank's block of the global tensor ``x`` laid out by ``spec``."""
    for d, name in enumerate(spec):
        a = _axis(mesh, name)
        if a.size == 1:
            continue
        if x.shape[d] % a.size:
            raise ValueError(f"axis {d} of length {x.shape[d]} not divisible by the "
                             f"{a.size} ranks of mesh dim {name!r}")
        blk = x.shape[d] // a.size
        x = x.narrow(d, a.index * blk, blk)
    return x


def _as_bytes(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(raw, like):
    return raw.view(like.dtype).reshape(like.shape)


def _gather(x, mesh, spec):
    """The global tensor from every rank's block ``x`` laid out by ``spec``
    (an all-gather along each dim that splits an axis)."""
    for d in reversed(range(len(spec))):
        a = _axis(mesh, spec[d])
        if a.size == 1:
            continue
        raw = _as_bytes(x)
        parts = [torch.empty_like(raw) for _ in range(a.size)]
        dist.all_gather(parts, raw, group=a.group)
        x = torch.cat([_from_bytes(parts[dist.get_group_rank(a.group, r)], x)
                       for r in a.ranks], dim=d)
    return x


def _data_parallel(fn, mesh, in_specs, out_specs):
    """``fn`` run on every rank's blocks of its arguments (``in_specs``, one
    spec per argument), its outputs gathered by ``out_specs`` (a spec, or
    one per output): the JAX package's ``jax.shard_map`` for functions
    whose blocks need no communication."""
    def run(*args):
        out = fn(*(_local_block(a, mesh, s) for a, s in zip(args, in_specs)))
        if isinstance(out_specs, P):
            return _gather(out, mesh, out_specs)
        return tuple(_gather(o, mesh, s) for o, s in zip(out, out_specs))

    return run


def _wire(x):
    """The real tensor a message carries for ``x``."""
    x = x.contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


def _unwire(buf, like):
    return torch.view_as_complex(buf) if like.is_complex() else buf


def _exchange(sends, recvs, group):
    """Post ``sends`` [(tensor, peer, tag)] and ``recvs`` [(like, peer,
    tag)] in one ``batch_isend_irecv`` and wait; returns the received
    tensors, each shaped and typed as its ``like``."""
    bufs = [torch.empty_like(_wire(like)) for like, _, _ in recvs]
    ops = [dist.P2POp(dist.isend, _wire(t), peer, group, tag) for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, b, peer, group, tag)
            for b, (_, peer, tag) in zip(bufs, recvs)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [_unwire(b, like) for b, (like, _, _) in zip(bufs, recvs)]


def _halo_exchange(x_local, halo_left, halo_right, mesh, axis_name, axis=0, circular=False):
    """``x_local`` with ``halo_left`` samples of its left neighbour's tail
    and ``halo_right`` of its right neighbour's head along ``axis``, the
    neighbours being the adjacent ranks of mesh dim ``axis_name``.

    With ``circular=False`` the ranks at the chain's ends get zeros (the
    zero-padded boundary of overlap-save filtering); with ``circular=True``
    the chain wraps around (the periodic boundary of a full-length FFT).
    A neighbour that is this rank itself is a local copy.
    """
    a = _axis(mesh, axis_name)
    n = x_local.shape[axis]
    if max(halo_left, halo_right) > n:
        raise ValueError(f"halo ({halo_left}, {halo_right}) wider than the local block {n}")
    tail = x_local.narrow(axis, n - halo_left, halo_left)
    head = x_local.narrow(axis, 0, halo_right)
    left, right = torch.zeros_like(tail), torch.zeros_like(head)
    if a.size == 1:
        if circular:
            left, right = tail, head
        return torch.cat([left, x_local, right], dim=axis)
    i = a.index
    has_left = circular or i > 0
    has_right = circular or i < a.size - 1
    left_peer = a.ranks[(i - 1) % a.size]
    right_peer = a.ranks[(i + 1) % a.size]
    # my tail is my right neighbour's left halo (tag 1), my head my left
    # neighbour's right halo (tag 2); at size 2 both neighbours are one rank
    # and both sides post in this order, so the messages pair up in order
    get_left, get_right = halo_left and has_left, halo_right and has_right
    sends = [m for m, on in (((tail, right_peer, 1), halo_left and has_right),
                             ((head, left_peer, 2), halo_right and has_left)) if on]
    recvs = [m for m, on in (((tail, left_peer, 1), get_left),
                             ((head, right_peer, 2), get_right)) if on]
    got = iter(_exchange(sends, recvs, a.group))
    left = next(got) if get_left else left
    right = next(got) if get_right else right
    return torch.cat([left, x_local, right], dim=axis)


def sharded_fir(x, h, mesh, time_axis="time", mode_axis=None):
    """'same'-mode FIR filtering with the time axis split over mesh dim
    ``time_axis``.

    Each rank gets ``K//2`` samples from its left neighbour and
    ``(K-1)//2`` from its right one and filters its own block: the
    distributed overlap-save of the reference (core.py:973).

    Parameters
    ----------
    x : (N,) or (N, modes) tensor; N divisible by the size of ``time_axis``.
    h : (K,) filter taps.
    mesh : DeviceMesh with a ``time_axis`` dim.
    mode_axis : optional mesh dim that splits the mode/signal columns too
        (the layout of a batch-split stage upstream).

    Returns the whole filtered tensor on every rank: complex64 if ``x`` or
    ``h`` is complex, else float32.
    """
    x = as_device_tensor(x)
    h = _as_tensor(h, x.device)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k = h.shape[0]
    # 'same' output at position i uses x[i - k//2 .. i + (k-1)//2]
    halo_l, halo_r = k // 2, (k - 1) // 2
    spec = P(time_axis, mode_axis)
    xx = _halo_exchange(_local_block(x, mesh, spec), halo_l, halo_r, mesh, time_axis)
    y = _fft_conv_same(h, xx, x.is_complex() or h.is_complex())
    y = _gather(y[halo_l:xx.shape[0] - halo_r], mesh, spec)
    return y[:, 0] if squeeze else y


def sharded_edc(sig, config, mesh, time_axis="time", mode_axis=None):
    """Chromatic-dispersion compensation with the time axis split.

    The filter of :func:`opticommpy_torch.dsp.equalization.edc`, applied by
    :func:`sharded_fir`: the CD impulse response comes from its
    frequency-domain definition once, on the host in NumPy. An even-length
    impulse gets a zero tap appended, which puts its zero-delay tap at the
    'same' convolution's centre and keeps all its taps, so the result is
    ``edc``'s (the JAX package drops the first tap instead).
    """
    _, beta2 = fiber_coefficients(0.0, config.D, config.Fc)
    n_coeffs = config.NfilterCoeffs
    if n_coeffs is None:
        n_coeffs = int(2 * np.ceil(6.67 * abs(beta2) * config.L * config.Rs**2
                                   * (config.Fs / config.Rs)))
    w = 2 * np.pi * config.Fs * np.fft.fftfreq(n_coeffs)
    H = np.exp(-1j * (beta2 / 2) * (w**2) * config.L)
    h_t = np.fft.fftshift(np.fft.ifft(H)).astype(np.complex64)
    if n_coeffs % 2 == 0:
        # fftshift centres an even-length impulse at k//2; one zero tap after
        # it makes k+1 taps, whose 'same'-convolution centre is k//2
        h_t = np.concatenate([h_t, [0.0]]).astype(np.complex64)
    sig = as_device_tensor(sig)
    return sharded_fir(sig, torch.as_tensor(h_t, device=sig.device), mesh, time_axis,
                       mode_axis)


def shard_batch(mesh, data_axis="data"):
    """The layout of the (N, 2k) interleaved-polarization batch: columns
    split in contiguous blocks of even size, so each signal's x/y pair stays
    on one rank."""
    return NamedSharding(mesh, P(None, data_axis))


def _base_seed(generator, device):
    """One draw from the caller's generator (seed 0 when None) that seeds
    the per-span ASE generators of the pipeline and sequence routes."""
    gen = ensure_generator(generator, device)
    return int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device).item())


def _fold(base, device, *index):
    """A generator on ``device`` seeded from ``base`` and ``index`` (the
    JAX package's ``fold_in``)."""
    hi, lo = np.random.SeedSequence([base, *index]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def manakov_ssf_dp(e_in, config, generator, mesh, data_axis="data"):
    """Data-parallel Manakov SSFM: the signal batch split over ranks.

    ``e_in`` is (N, 2k) with k signals; k must be divisible by the size of
    mesh dim ``data_axis``. Each rank propagates its k/size signals. With
    the adaptive step (``nlprMethod``) the global ``max(phi_rot)`` is one
    all-reduce per step, and with ``trapIters=0`` the convergence test's
    sums one more, so every rank takes the unsplit batch's steps. Each EDFA
    draws the whole batch's noise from ``generator`` (which every rank
    passes in the same state) and adds its own signals' share: the result
    is :func:`~opticommpy_torch.models.channels.manakov_ssf`'s.
    """
    count("ssfm.calls", 1)
    e = _to_pol_stacked(e_in, config)
    a = _axis(mesh, data_axis)
    k = e.shape[1]
    if k % a.size:
        raise ValueError(f"{k} signals not divisible by {a.size} data shards")
    spec = P(None, data_axis, None)
    e_loc = _local_block(e, mesh, spec)
    batch = (k, a.index * (k // a.size))
    for e_loc in _manakov_spans(e_loc, config, generator, a.group, batch):
        pass
    return _to_columns(_gather(e_loc, mesh, spec))


def manakov_ssf_pp(e_in, config, generator, mesh, stage_axis="stage", n_microbatches=None):
    """Pipeline-parallel Manakov SSFM: spans staged across ranks.

    The link's spans are split into ``S`` contiguous stages, one per rank
    of mesh dim ``stage_axis``; the signal batch is split into ``M``
    microbatches that go stage -> stage by point-to-point messages,
    GPipe-style: stage ``s`` integrates microbatch ``j`` at tick ``j + s``
    of ``M + S - 1``. A stage waits for its microbatches instead of
    computing zeros in the fill and drain ticks. Pipeline efficiency is
    ``M / (M + S - 1)``: use ``n_microbatches`` well above ``S``.

    Parameters
    ----------
    e_in : (N, 2*k) interleaved-polarization batch; ``k`` divisible by
        ``n_microbatches``.
    config : SSFMConfig; ``floor(Ltotal/Lspan)`` divisible by ``S``. With the
        adaptive step each microbatch steps on its own peak rotation.
    generator : the ASE noise's source: one generator per (global span,
        microbatch) is seeded from one draw of it, so the statistics match
        the single-device path and the streams differ from it.
    n_microbatches : default ``S``.

    Returns
    -------
    (N, 2*k) output field on every rank, microbatches in input order.
    """
    count("ssfm.calls", 1)
    e = _to_pol_stacked(e_in, config)
    a = _axis(mesh, stage_axis)
    n_stages, stage = a.size, a.index
    m = n_stages if n_microbatches is None else int(n_microbatches)
    n, k = e.shape[-1], e.shape[1]
    if k % m:
        raise ValueError(f"batch size {k} not divisible by {m} microbatches")
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    if n_spans % n_stages:
        raise ValueError(f"{n_spans} spans not divisible by {n_stages} pipeline stages")
    spans_per_stage = n_spans // n_stages
    b_mb = k // m
    lin_arg = _lin_arg(n, config, e.dtype, e.device)
    base = _base_seed(generator, e.device) if config.amp == "edfa" else None
    shape_mb = torch.empty((2, b_mb, n), dtype=e.dtype, device=e.device)
    outs = []
    for j in range(m):
        if stage == 0:
            cur = e[:, j * b_mb:(j + 1) * b_mb]
        else:
            (cur,) = _exchange([], [(shape_mb, a.ranks[stage - 1], 0)], a.group)
        for local in range(spans_per_stage):
            cur = _manakov_span(cur, lin_arg, config.Lspan, config)
            gen = None if base is None else _fold(base, e.device,
                                                  stage * spans_per_stage + local, j)
            cur = _amplify(cur, config, gen)
        if stage < n_stages - 1:
            _exchange([(cur, a.ranks[stage + 1], 0)], [], a.group)
        else:
            outs.append(cur)
    if n_stages == 1:
        return _to_columns(torch.cat(outs, dim=1))
    last = a.ranks[-1]
    final = torch.cat(outs, dim=1) if stage == n_stages - 1 else torch.empty(
        (2, k, n), dtype=e.dtype, device=e.device)
    raw = _as_bytes(final)
    dist.broadcast(raw, last, group=a.group)
    return _to_columns(_from_bytes(raw, final))


def _next_smooth(n):
    """Smallest 2/3/5-smooth integer >= n (an FFT-friendly length)."""
    best = 1 << max(0, n - 1).bit_length()  # the next power of two qualifies
    p3 = 1
    while p3 <= best:
        p35 = p3
        while p35 <= best:
            q = -(-n // p35)  # ceil(n / p35): the power-of-two factor needed
            m = p35 * (1 << max(0, q - 1).bit_length())
            if n <= m < best:
                best = m
            p35 *= 5
        p3 *= 3
    return best


def default_sp_halo(config, spans_per_sync=1, safety=4.0):
    """Halo width (samples) for :func:`manakov_ssf_sp`.

    The linear operator of one sync group spreads energy by at most the
    band-edge group delay ``|beta2| * pi * Fs^2 * Lspan * spans_per_sync``
    samples (the nonlinear rotation is pointwise). ``safety`` times that,
    rounded up to a multiple of 128, puts the truncation error of the
    overlapped-block propagation near float32 round-off.
    """
    _, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    tau = abs(beta2) * np.pi * config.Fs**2 * config.Lspan * spans_per_sync
    return int(max(128, 128 * np.ceil(safety * tau / 128)))


def manakov_ssf_sp(e_in, config, generator=None, mesh=None, time_axis="time",
                   data_axis=None, halo=None, spans_per_sync=1):
    """Sequence-parallel Manakov SSFM: one signal's time axis split.

    One ``hz`` of dispersion moves energy by well under a sample, so a rank
    can propagate its time block given a halo of its neighbours' samples as
    wide as the dispersion spread of a sync group. Each group of
    ``spans_per_sync`` spans runs on the halo-padded block, zero-padded to
    a 2/3/5-smooth FFT length ``_next_smooth(N/T + 2*halo)``; between
    groups the halos are refreshed from the neighbours' interiors,
    cyclically, so the global periodic boundary of the full-length FFT
    holds. The sequence-parallel complement of :func:`manakov_ssf_dp`
    (batch) and :func:`manakov_ssf_pp` (spans).

    Accuracy: the halo must exceed the group's band-edge group delay
    (:func:`default_sp_halo`, 4x the spread by default); the output then
    matches :func:`manakov_ssf` near float32 round-off. Even on one rank the
    block is another FFT length with another boundary than the unsharded
    call's, so it is not bit for bit. Fixed steps follow the single-device
    schedule; the adaptive rule steps each block on its own peak rotation.

    Parameters
    ----------
    e_in : (N, 2*k) interleaved-polarization field; N divisible by the size
        of ``time_axis``.
    config : SSFMConfig.
    generator : the ASE noise's source: one generator per (span, time
        block, data block) is seeded from one draw of it.
    mesh : DeviceMesh with ``time_axis`` (and ``data_axis`` to split the
        batch as well).
    halo : neighbour samples per side (default :func:`default_sp_halo`).
    spans_per_sync : spans per halo refresh; more spans fewer messages,
        a wider halo.

    Returns
    -------
    (N, 2*k) output field on every rank.
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    if mesh is None:
        raise ValueError("manakov_ssf_sp requires a mesh")
    count("ssfm.calls", 1)
    t = _axis(mesh, time_axis)
    e = _to_pol_stacked(e_in, config)
    n = e.shape[-1]
    if n % t.size:
        raise ValueError(f"time length {n} not divisible by {t.size} shards")
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    if n_spans % spans_per_sync:
        raise ValueError(f"{n_spans} spans not divisible by spans_per_sync={spans_per_sync}")
    if halo is None:
        halo = default_sp_halo(config, spans_per_sync)
    n_loc = n // t.size
    if 2 * halo > n_loc:
        raise ValueError(f"halo {halo} too wide for local chunk {n_loc}")
    # the zero pad sits beyond the halos, so the contamination front still
    # crosses a whole halo before it reaches the interior
    n_pad = _next_smooth(n_loc + 2 * halo)
    lin_arg = _lin_arg(n_pad, config, e.dtype, e.device)
    base = _base_seed(generator, e.device) if config.amp == "edfa" else None
    d_index = _axis(mesh, data_axis).index
    spec = P(None, data_axis, time_axis)
    e_loc = _local_block(e, mesh, spec)
    for group_idx in range(n_spans // spans_per_sync):
        e_pad = _halo_exchange(e_loc, halo, halo, mesh, time_axis, axis=-1, circular=True)
        extra = n_pad - e_pad.shape[-1]
        if extra:
            e_pad = torch.cat([e_pad, e_pad.new_zeros(e_pad.shape[:-1] + (extra,))], dim=-1)
        for local in range(spans_per_sync):
            e_pad = _manakov_span(e_pad, lin_arg, config.Lspan, config)
            gen = None if base is None else _fold(
                base, e.device, group_idx * spans_per_sync + local, t.index, d_index)
            e_pad = _amplify(e_pad, config, gen)
        e_loc = e_pad[..., halo:halo + n_loc]
    return _to_columns(_gather(e_loc, mesh, spec))
