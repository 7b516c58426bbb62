"""The port's Volterra equalizer against the JAX package: ``volterra``
against the JAX scan, K14's plain version (``kernels/volterra.py``, behind
``volterra_kernel``) against ``volterra_pallas`` in interpret mode, batch
against single bit for bit, convergence on ``bench_dsp.py``'s signal, the
route to the kernel and, on a card, the kernel against its plain version.

Tolerances: ``y``, ``mse`` and the taps within 1e-5 absolute of JAX (the
JAX package's own pin between its kernel and its scan,
``tests/test_pallas_kernels.py:243-274``); the port sums each lane's taps
in slot order and the lanes as a tree, JAX in its own order. Kernel
against plain on the card and batch against single: equal bit for bit.
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
    # the kernel reads its table by row offsets: row-major int32, whatever
    # order NumPy's concatenation would pick
    table = k14.kernel_table(13, 7, 5, 3)
    assert table.dtype == np.int32 and table.flags["C_CONTIGUOUS"] and table.shape == (4, 187)
    flat = np.frombuffer(table.tobytes(), np.int32)
    np.testing.assert_array_equal(flat[3 * 187:3 * 187 + 14], [1] * 13 + [2])
    assert torch.as_tensor(table).is_contiguous()


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
