"""The port's Volterra equalizer against the JAX package: ``volterra``
against the JAX scan, K14's plain version (``kernels/volterra.py``, behind
``volterra_kernel``) against ``volterra_pallas`` in interpret mode, batch
against single bit for bit, convergence on ``bench_dsp.py``'s signal, the
route to the kernel and, on a card, the kernel against its plain version.

Tolerances: ``y``, ``mse`` and the taps within 1e-5 absolute of JAX (the
JAX package's own pin between its kernel and its scan,
``tests/test_pallas_kernels.py:243-274``); the port sums each lane's taps
as a tree and the lanes as a tree, JAX in its own order. Kernel against
plain on the card and batch against single: equal bit for bit. The
kernel's two exact replacements of a division are held to the division
bit for bit: the slicer's thresholds here on the float32 values around
each threshold and on random ones, the quotient g / 7 on random and edge
values (``chip_smoke.py`` checks both on every float32 input on the card).
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.dsp import equalization as jeq  # noqa: E402
from opticommpy_tpu.kernels.volterra_pallas import volterra_pallas  # noqa: E402
from opticommpy_torch.comm.metrics import fast_ber_calc  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.kernels import volterra as k14  # noqa: E402
from opticommpy_torch.ops.signal import pnorm  # noqa: E402

from _torch_parity import require_cuda, to_np  # noqa: E402

ATOL = 1e-5
TAPS = dict(n1Taps=13, n2Taps=7, n3Taps=5, mu=1e-3, M=4, constType="pam")


def _nl_pam(n_sym, sps=2, seed=4):
    """bench_dsp.py:355-358: PAM4 at sps with noise and a mild square-law
    distortion."""
    rng = np.random.default_rng(seed)
    sym = (2 * rng.integers(0, 4, size=n_sym) - 3).astype(np.float32)
    sig = np.repeat(sym, sps) + 0.1 * rng.normal(size=n_sym * sps)
    return (sig + 0.05 * sig**2).astype(np.float32), sym


def _close(a, b):
    a, b = to_np(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("order", [2, 3])
def test_volterra_matches_jax_scan(order):
    sig, sym = _nl_pam(1200)
    kw = dict(TAPS, SpS=2, nTrain=500, order=order)
    yj, hj, mj = jeq.volterra(jnp.asarray(sig), jnp.asarray(sym), jeq.VolterraConfig(**kw))
    yt, ht, mt = teq.volterra(torch.as_tensor(sig), torch.as_tensor(sym),
                              teq.VolterraConfig(**kw))
    _close(yt, yj)
    _close(mt, mj)
    for a, b in zip(ht, hj):
        _close(a, b)


@pytest.mark.parametrize("order", [2, 3])
def test_volterra_kernel_plain_matches_pallas(order):
    sig, sym = _nl_pam(1200)
    jcfg = jeq.VolterraConfig(**TAPS, SpS=2, nTrain=500, order=order)
    yj, hj, mj = volterra_pallas(jnp.asarray(sig), jnp.asarray(sym), jcfg, block=128,
                                 interpret=True)
    with mock.patch.object(k14, "volterra_pass_plain",
                           wraps=k14.volterra_pass_plain) as plain:
        yt, ht, mt = k14.volterra_kernel(torch.as_tensor(sig), torch.as_tensor(sym),
                                         config_from_jax(jcfg))
    assert plain.call_count == 1
    _close(yt, yj)
    _close(mt, mj)
    for a, b in zip(ht, hj):
        _close(a, b)


def test_batch_equals_single_bit_for_bit():
    sig, sym = _nl_pam(800)
    sig2 = (sig + 0.05 * np.random.default_rng(5).normal(size=sig.shape)).astype(np.float32)
    cfg = teq.VolterraConfig(**TAPS, SpS=2, nTrain=300, order=3, trainingMode="fulltime")
    yb, hb, mb = k14.volterra_kernel(torch.as_tensor(np.stack([sig, sig2])),
                                     torch.as_tensor(np.stack([sym, sym])), cfg)
    ys, hs, ms = k14.volterra_kernel(torch.as_tensor(sig2), torch.as_tensor(sym), cfg)
    assert torch.equal(yb[1], ys) and torch.equal(mb[1], ms)
    for a, b in zip(hb, hs):
        assert torch.equal(a[1], b)
    assert not torch.equal(yb[0], yb[1])


def test_converges_on_bench_dsp_signal():
    """BER 0 after nTrain on bench_dsp.py's Volterra workload (order 3), as
    the JAX scan reaches on the CPU (8,192 of its 16,384 symbols here)."""
    sig, sym = _nl_pam(8192)
    cfg = teq.VolterraConfig(**TAPS, SpS=2, nTrain=4000, order=3)
    y, _, mse = k14.volterra_kernel(torch.as_tensor(sig), torch.as_tensor(sym), cfg)
    ber, _, _ = fast_ber_calc(y[4000:], pnorm(torch.as_tensor(sym))[4000:], 4, "pam")
    assert float(ber[0]) == 0.0
    assert float(mse[-2000:].mean()) < 0.05


def test_feature_table_layout():
    idx, kind = k14.feature_table(5, 3, 2, 3)
    assert idx.shape == (3, 5 + 9 + 8) and list(np.bincount(kind)) == [0, 5, 9, 8]
    # h1 reads x[t] (times 1.0 twice), h2[j, i] reads x2[j] * x2[i]
    assert idx[:, 0].tolist() == [0, 5, 5]
    assert idx[:, 5 + 1 * 3 + 2].tolist() == [1 + 1, 1 + 2, 5]
    assert k14.feature_table(5, 3, 2, 2)[0].shape == (3, 14)
    # the kernel's lane layout: lanes grouped by order, S slots each, every
    # flat tap in exactly one slot, dead slots on the 0.0 entry (n1 + 1)
    S, lay, lane_order = k14.lane_layout(13, 7, 5, 3)
    assert (S, lay.shape) == (7, (32, 7, 4))
    assert lane_order.tolist() == [1] * 2 + [2] * 7 + [3] * 18 + [0] * 5
    q = lay[:, :, 3]
    assert sorted(q[q >= 0].tolist()) == list(range(187))
    idx13, _ = k14.feature_table(13, 7, 5, 3)
    np.testing.assert_array_equal(lay[q >= 0][:, :3], idx13[:, q[q >= 0]].T)
    assert (lay[q < 0][:, :3] == 14).all()
    assert k14.lane_layout(13, 7, 5, 2)[0] == 2
    # the kernel reads its table by offsets: row-major int32, the lanes'
    # orders after the slots
    S, table = k14.kernel_table(13, 7, 5, 3)
    assert table.dtype == np.int32 and table.flags["C_CONTIGUOUS"] and table.shape == (32 * 7 * 4
                                                                                         + 32,)
    flat = np.frombuffer(table.tobytes(), np.int32)
    np.testing.assert_array_equal(flat[:4], lay[0, 0])
    np.testing.assert_array_equal(flat[-32:], lane_order)
    assert torch.as_tensor(table.copy()).is_contiguous()  # as _build.device_arrays uploads it


def _slice_by_division(y, levels):
    """The kernel's division slicer in float32: clip(rint((y - lo) / step),
    0, top) * step + lo, NaN taken to level 0 as fmaxf / fminf do."""
    lo, step = np.float32(levels[0]), np.float32(levels[1] - levels[0])
    with np.errstate(all="ignore"):
        kq = np.fmin(np.fmax(np.rint((y - lo) / step), np.float32(0)), np.float32(len(levels) - 1))
        return kq * step + lo


@pytest.mark.parametrize("M", [2, 4, 8, 16])
def test_slicer_thresholds_decide_as_the_division(M):
    levels = k14._levels(M, "pam")
    n, thr = k14.slicer_thresholds(levels)
    assert n == M and thr.dtype == np.float32
    th = thr[:M - 1]
    assert np.all(np.isfinite(th)) and np.all(np.diff(th) > 0)
    keys = k14._to_key(th)[:, None] + np.arange(-1000, 1001)[None, :]
    around = k14._from_key(keys.ravel())
    rng = np.random.default_rng(M)
    rand = rng.integers(0, 2**32, size=10**6, dtype=np.uint64).astype(np.uint32).view(np.float32)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38],
                       np.float32)
    for y in (around, rand, special):
        kq = (y[:, None] >= th[None, :]).sum(axis=1)  # NaN compares false: level 0
        picked = thr[k14.MAX_LEVELS - 1 + kq]
        ref = _slice_by_division(y, levels)
        np.testing.assert_array_equal(picked.view(np.uint32), ref.view(np.uint32))


def test_quotient_by_seven_equals_the_division():
    """The kernel's g / 7: q0 = RN(g * RN(1/7)), then one FMA on the exact
    remainder (q0 itself where it is zero or infinite), against NumPy's
    float32 division, on random float32 values of every exponent and on
    edge values; exact rationals stand in for the FMA."""
    from fractions import Fraction

    r = np.float32(1) / np.float32(7)
    assert r.view(np.uint32) == 0x3E124925  # the constant in csrc/volterra.cu

    def rn32(x):
        """RN-even of the rational x to float32 (finite range)."""
        a = np.float32(float(x))
        cands = [np.nextafter(a, np.float32(-np.inf)), a, np.nextafter(a, np.float32(np.inf))]
        return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                         int(np.array(c).view(np.uint32)) & 1))

    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2**32, size=3000, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 0x80000000, 1, 0x80000001, 2, 7, 0x00800000, 0x007FFFFF, 0x7F7FFFFF,
                     0xFF7FFFFF, 0x3F800000, 0x40E00000, 0x7F800000, 0xFF800000], np.uint32)
    for g in np.concatenate([bits, edge]).view(np.float32):
        if np.isnan(g):
            continue
        ref = np.float32(g) / np.float32(7)
        with np.errstate(over="ignore"):
            q0 = np.float32(g) * r
        if q0 == 0 or np.isinf(q0):
            q = q0
        else:
            gf, q0f = Fraction(float(g)), Fraction(float(q0))
            rem = rn32(gf - 7 * q0f)
            q = rn32(Fraction(float(rem)) * Fraction(float(r)) + q0f)
        assert np.array(q).view(np.uint32) == np.array(ref).view(np.uint32), g


def test_volterra_raises_on_bad_taps():
    cfg = teq.VolterraConfig(n1Taps=3, n2Taps=5)
    with pytest.raises(ValueError, match="n1Taps"):
        teq.volterra(torch.zeros(100), torch.zeros(50), cfg)
    with pytest.raises(ValueError, match="n1Taps"):
        k14.volterra_kernel(torch.zeros(100), torch.zeros(50), cfg)


def test_volterra_run_routes_cuda_to_the_kernel_without_fallback():
    fake = mock.MagicMock()
    fake.device.type = "cuda"
    args = (None, None, 10, 2, 13, 7, 5, 3, np.array([-1.0, 1.0]), 1e-3, 5, True)
    with mock.patch.object(k14, "_volterra_cuda", return_value="k14") as kern, \
            mock.patch.object(k14, "volterra_pass_plain") as plain:
        assert k14.volterra_run(fake, *args) == "k14"
    assert kern.call_count == 1 and plain.call_count == 0
    with mock.patch.object(k14, "_volterra_cuda", side_effect=RuntimeError("nvcc failed")), \
            mock.patch.object(k14, "volterra_pass_plain") as plain:
        with pytest.raises(RuntimeError, match="nvcc"):
            k14.volterra_run(fake, *args)
    assert plain.call_count == 0


# -- the kernel on the card --------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("order", [2, 3])
def test_kernel_matches_plain_on_gpu(order):
    dev = require_cuda()
    rng = np.random.default_rng(order)
    sig = np.stack([_nl_pam(2048, seed=s)[0] for s in range(8)])
    sym = np.stack([_nl_pam(2048, seed=s)[1] for s in range(8)])
    cfg = teq.VolterraConfig(**TAPS, SpS=2, nTrain=1000, order=order,
                             trainingMode="fulltime" if order == 3 else "data-aided")
    sig_pad, ref, h0, n_out, _ = k14.prepare(torch.as_tensor(sig + 0.01 * rng.normal(
        size=sig.shape).astype(np.float32), device=dev), torch.as_tensor(sym, device=dev), cfg)
    args = (h0, n_out, 2, 13, 7, 5, order, k14._levels(4, "pam"), 1e-3, 1000,
            cfg.trainingMode == "fulltime")
    before = k14.launches
    out_k = k14.volterra_run(sig_pad, ref, *args)
    assert k14.launches == before + 1
    out_p = k14.volterra_pass_plain(sig_pad, ref, *args)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


# (n1, n2, n3, order, the layout's slots S): the default 5 / 3 / 2 and
# 9 / 5 / 3, then a configuration for each other slot instance. None is a
# compiled configuration, so the range with the taps fixed runs the
# run-time layout's loop.
RUNTIME_TAPS = [
    (5, 3, 2, 2, 1), (5, 3, 2, 3, 1), (9, 5, 3, 2, 2), (9, 5, 3, 3, 2), (4, 2, 4, 3, 3),
    (6, 5, 4, 3, 4), (5, 3, 5, 3, 5), (7, 6, 5, 3, 6), (9, 8, 5, 3, 7), (6, 3, 6, 3, 8),
    (7, 6, 6, 3, 10), (7, 3, 7, 3, 13), (9, 8, 7, 3, 16), (8, 3, 8, 3, 24), (9, 3, 9, 3, 32),
]


def test_runtime_taps_reach_every_slot_instance():
    assert [k14.lane_layout(*t[:4])[0] for t in RUNTIME_TAPS] == [t[4] for t in RUNTIME_TAPS]
    assert {t[4] for t in RUNTIME_TAPS} == set(k14.SLOT_INSTANCES)


@pytest.mark.gpu
@pytest.mark.parametrize("n_b, n_sym, n_train, order, fulltime, M, taps", [
    (1, 1000, 300, 3, True, 4, (13, 7, 5)),     # training ends inside the second 256-symbol chunk
    (1, 1000, 300, 2, False, 4, (13, 7, 5)),    # n_sym not a multiple of the chunk
    (132, 700, 257, 3, False, 4, (13, 7, 5)),   # a signal per SM, training one past a chunk
    (132, 700, 256, 2, True, 4, (13, 7, 5)),    # training ends on a chunk edge
    (3, 513, 0, 3, True, 8, (13, 7, 5)),        # odd batch (a spare lane group), 16-level slicer
    (2, 300, 100, 3, True, 32, (13, 7, 5)),     # more levels than thresholds: the division
] + [  # the run-time layouts: training over a chunk edge, then taps fixed or adapting
    (3, 600, 300, order, fulltime, 4, (n1, n2, n3))
    for n1, n2, n3, order, _ in RUNTIME_TAPS for fulltime in (False, True)
])
def test_kernel_edges_match_plain_on_gpu(n_b, n_sym, n_train, order, fulltime, M, taps):
    dev = require_cuda()
    n1, n2, n3 = taps
    rng = np.random.default_rng(n_b + n_sym)
    sig = np.stack([_nl_pam(n_sym, seed=s)[0] for s in range(n_b)])
    sym = np.stack([_nl_pam(n_sym, seed=s)[1] for s in range(n_b)])
    cfg = teq.VolterraConfig(**dict(TAPS, M=M, n1Taps=n1, n2Taps=n2, n3Taps=n3), SpS=2,
                             nTrain=n_train, order=order,
                             trainingMode="fulltime" if fulltime else "data-aided")
    sig_pad, ref, h0, n_out, _ = k14.prepare(torch.as_tensor(sig + 0.01 * rng.normal(
        size=sig.shape).astype(np.float32), device=dev), torch.as_tensor(sym, device=dev), cfg)
    h0 = h0 + 0.01 * torch.as_tensor(rng.normal(size=h0.shape).astype(np.float32), device=dev)
    args = (h0.contiguous(), n_out, 2, n1, n2, n3, order, k14._levels(M, "pam"), 1e-3, n_train,
            fulltime)
    before = k14.launches
    out_k = k14.volterra_run(sig_pad, ref, *args)
    assert k14.launches == before + 1
    out_p = k14.volterra_pass_plain(sig_pad, ref, *args)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert bool(torch.isfinite(b).all())
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_exact_replacements_hold_on_every_float32_on_gpu():
    """The kernel's quotient by 7 and its PAM4 threshold slicer against the
    true division on all 2^32 float32 inputs (volterra_exact_check)."""
    from opticommpy_torch.kernels import _build

    dev = require_cuda()
    lib = _build.load_library()
    levels = k14._levels(4, "pam")
    n, thr = k14.slicer_thresholds(levels)
    thr_t = torch.as_tensor(thr.copy(), device=dev)
    bad = torch.zeros(12, dtype=torch.int64, device=dev)
    step = float(levels[1] - levels[0])
    _build.check(lib.volterra_exact_check(0, 1 << 32, _build.ptr(thr_t), n, float(levels[0]),
                                          step, float(n - 1), _build.ptr(bad),
                                          _build.stream_ptr(dev)), "volterra_exact_check")
    torch.cuda.synchronize()
    assert bad[:2].tolist() == [0, 0], bad.tolist()  # bad[2:10]: inputs that differ
