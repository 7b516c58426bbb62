"""The per-symbol scan routes the port added last: the widely linear
equalizer (``runWL``), coefficient storage (``storeCoeff``), the MLSE
(``comm.modulation.mlse``) and the whitening filter (``ops.whitening``),
against the JAX package on the CPU.

Tolerances: atol 2e-4 on the equalized symbols and squared errors, 1e-3 on
the taps (H, H_ and Hiter), the pins of tests/test_torch_mimo.py; the MLSE
decisions equal; the whitening filter and the autocorrelation within rtol
1e-5, atol 1e-6 (float32 sums of up to 2e5 products in another order).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm.modulation import gray_mapping  # noqa: E402
from opticommpy_tpu.comm.modulation import mlse as jmlse  # noqa: E402
from opticommpy_tpu.dsp import equalization as jeq  # noqa: E402
from opticommpy_tpu.ops import autocorr as jautocorr  # noqa: E402
from opticommpy_tpu.ops import estimate_whitening_filter as jwhiten  # noqa: E402
from opticommpy_tpu.ops import levinson as jlevinson  # noqa: E402
from opticommpy_torch.comm import mlse as tmlse  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.ops import autocorr as tautocorr  # noqa: E402
from opticommpy_torch.ops import estimate_whitening_filter as twhiten  # noqa: E402
from opticommpy_torch.ops import levinson as tlevinson  # noqa: E402

from _torch_parity import cpu, mixed_polmux, require_cuda, to_np  # noqa: E402

Y_ATOL, H_ATOL = 2e-4, 1e-3
W_RTOL, W_ATOL = 1e-5, 1e-6


def _assert_eq_results_close(out_t, out_j):
    """(sigOut, H, H_, errSq, Hiter): every shape equal, each within its pin."""
    for a_t, a_j, atol in zip(out_t, out_j, (Y_ATOL, H_ATOL, H_ATOL, Y_ATOL, H_ATOL)):
        a_j = np.asarray(a_j)
        assert a_t.shape == a_j.shape
        np.testing.assert_allclose(to_np(a_t), a_j, rtol=0, atol=atol)


@pytest.mark.parametrize("algs,mus", [
    (("nlms",), (2e-3,)),
    (("dd-lms",), (1e-3,)),
    (("cma",), (1e-3,)),
    (("rde",), (1e-3,)),
    (("da-rde", "dd-lms"), (5e-3, 1e-3)),
    (("rls",), (1.0,)),
    (("nlms", "dd-rls"), (2e-3, 1.0)),
], ids=["nlms", "dd-lms", "cma", "rde", "da-rde_dd-lms", "rls", "nlms_dd-rls"])
def test_run_wl_matches_jax(algs, mus):
    """runWL under backend='pallas' takes the scan rule: H_ on conj(win)
    joins the output, the gradient rules update it (no conjugate), rls and
    dd-rls leave it as it came in. A non-zero H_ goes in, so every rule's
    use of it shows; numIter=2 passes of the first stage chain H_ on."""
    sig, sym = mixed_polmux(70 + len(algs), 900)
    rng = np.random.default_rng(7)
    H_in = (0.02 * (rng.normal(size=(2, 2, 7)) + 1j * rng.normal(size=(2, 2, 7)))
            ).astype(np.complex64)
    lengths = (900,) if len(algs) == 1 else (400, 500)
    jcfg = jeq.MIMOEqualizerConfig(nTaps=7, SpS=2, mu=mus, alg=algs, L=lengths, M=16,
                                   numIter=2, runWL=True, backend="pallas")
    out_j = jeq.mimo_adapt_equalizer(sig, jcfg, symb_ref=sym, H_=H_in, return_results=True)
    out_t = teq.mimo_adapt_equalizer(cpu(sig), config_from_jax(jcfg), symb_ref=cpu(sym),
                                     H_=cpu(H_in), return_results=True)
    _assert_eq_results_close(out_t, out_j)
    if all(a in ("rls", "dd-rls") for a in algs):
        torch.testing.assert_close(out_t[2], cpu(H_in), rtol=0, atol=0)


@pytest.mark.parametrize("algs,mus,run_wl", [
    (("nlms", "dd-lms"), (2e-3, 1e-3), False),
    (("rls", "dd-lms"), (1.0, 1e-3), False),
    (("cma",), (1e-3,), True),
], ids=["nlms_dd-lms", "rls_dd-lms", "cma_wl"])
def test_store_coeff_matches_jax(algs, mus, run_wl):
    """storeCoeff: Hiter is the taps after every output symbol, the stages'
    histories concatenated, the first stage's from its last of numIter=2
    passes; its last row is the returned H. Under backend='pallas' every
    stage takes the scan rule, as in the JAX package."""
    sig, sym = mixed_polmux(80, 700)
    lengths = (700,) if len(algs) == 1 else (300, 400)
    jcfg = jeq.MIMOEqualizerConfig(nTaps=7, SpS=2, mu=mus, alg=algs, L=lengths, M=16,
                                   numIter=2, storeCoeff=True, runWL=run_wl,
                                   backend="pallas")
    out_j = jeq.mimo_adapt_equalizer(sig, jcfg, symb_ref=sym, return_results=True)
    out_t = teq.mimo_adapt_equalizer(cpu(sig), config_from_jax(jcfg), symb_ref=cpu(sym),
                                     return_results=True)
    _assert_eq_results_close(out_t, out_j)
    assert out_t[4].shape == (700, 2, 2, 7)
    torch.testing.assert_close(out_t[4][-1], out_t[1], rtol=0, atol=0)


def _iq_imbalanced_polmux(seed, n_sym, amp_db, phase):
    """mixed_polmux with an IQ amplitude / phase imbalance on each mode:
    ``k1 x + k2 conj(x)``, the front-end image a linear equalizer cannot
    undo and a widely linear one can."""
    sig, sym = mixed_polmux(seed, n_sym)
    eps = 10 ** (amp_db / 20) - 1
    k1 = (1 - eps) * np.exp(1j * phase / 2) / 2 + (1 + eps) * np.exp(-1j * phase / 2) / 2
    k2 = (1 - eps) * np.exp(-1j * phase / 2) / 2 - (1 + eps) * np.exp(1j * phase / 2) / 2
    return (k1 * sig + k2 * sig.conj()).astype(np.complex64), sym


def test_run_wl_lowers_the_tail_mse_under_iq_imbalance():
    """Property (the JAX package has no runWL test of its own): on a polmux
    signal with 1 dB / 10 degree IQ imbalance, the widely linear NLMS run
    of both packages reaches a lower mean squared error over the last 1000
    of 4000 symbols than the same run with runWL=False. The parameters
    were fixed before the first run."""
    sig, sym = _iq_imbalanced_polmux(90, 4000, 1.0, np.deg2rad(10.0))
    tail = {}
    for wl in (False, True):
        jcfg = jeq.MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(5e-3,), alg=("nlms",), M=16,
                                       runWL=wl)
        e_j = np.asarray(jeq.mimo_adapt_equalizer(sig, jcfg, symb_ref=sym,
                                                  return_results=True)[3])
        e_t = to_np(teq.mimo_adapt_equalizer(cpu(sig), config_from_jax(jcfg),
                                             symb_ref=cpu(sym), return_results=True)[3])
        tail[wl] = (e_j[:, -1000:].mean(), e_t[:, -1000:].mean())
    assert tail[True][0] < tail[False][0], tail
    assert tail[True][1] < tail[False][1], tail


def _isi(seed, n, M, const_type, h, noise):
    rng = np.random.default_rng(seed)
    const = gray_mapping(M, const_type)
    const = const / np.sqrt(np.mean(np.abs(const) ** 2))
    x = const[rng.integers(0, M, size=n)]
    y = np.convolve(x, h)[:n] + noise * rng.normal(size=n)
    if const_type != "pam":
        y = y + 1j * noise * rng.normal(size=n)
    return x, y, const


@pytest.mark.parametrize("M,const_type,h", [
    (4, "pam", [0.9]),
    (4, "pam", [1.0, 0.45]),
    (4, "pam", [1.0, 0.45, 0.2]),
    (16, "qam", [1.0, 0.3 + 0.1j]),
], ids=["pam4_L0", "pam4_L1", "pam4_L2", "qam16_L1"])
def test_mlse_matches_jax(M, const_type, h):
    """Decisions equal to the JAX package's at channel memories 0, 1 and 2
    (the L = 0 branch through min_euclid), with noise that makes errors:
    ties and near-ties in the path metrics decide alike. On the JAX test's
    channel (h = [1, 0.45], tests/test_modulation.py:84-94) more than 98%
    of the symbols come back."""
    x, y, const = _isi(11, 2000, M, const_type, np.array(h), 0.2)
    x_j = np.asarray(jmlse(y, np.array(h), const))
    x_t = tmlse(cpu(y), np.array(h), const)
    assert x_t.dtype == (torch.complex64 if const_type == "qam" else torch.float32)
    np.testing.assert_array_equal(to_np(x_t), x_j)
    if h == [1.0, 0.45]:
        x, y, const = _isi(3, 300, 4, "pam", np.array(h), 0.01)
        x_hat = to_np(tmlse(cpu(y), np.array(h), const))
        assert np.mean(np.abs(x_hat[:-5] - x[:-5]) < 1e-3) > 0.98


@pytest.mark.parametrize("M,h", [(2, [1.0, 1.0]), (4, [1.0, 1.0]), (4, [1.0, 0.0, 1.0])])
def test_mlse_ties_decide_as_jax(M, h):
    """A zero input through h = [1, 1] (or [1, 0, 1]) leaves whole families
    of sequences with equal path metrics: every survivor and the last state
    are chosen among exact ties, and the port takes the first index, as
    jnp.argmin does."""
    const = gray_mapping(M, "pam").astype(np.float64)
    y = np.zeros(40, np.float32)
    x_j = np.asarray(jmlse(y, np.array(h), const))
    np.testing.assert_array_equal(to_np(tmlse(cpu(y), np.array(h), const)), x_j)


def test_autocorr_matches_jax():
    """tests/test_whitening.py:9-14's white noise (1e5 samples, 4 lags), and
    a complex coloured sequence (conjugates and the unbiased divisor)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=100_000).astype(np.float32)
    r_t = tautocorr(cpu(x), 4)
    np.testing.assert_allclose(to_np(r_t), np.asarray(jautocorr(x, 4)), rtol=W_RTOL,
                               atol=W_ATOL)
    assert np.isclose(float(r_t[0]), 1.0, rtol=0.02) and np.all(np.abs(to_np(r_t[1:])) < 0.02)
    z = (rng.normal(size=50_000) + 1j * rng.normal(size=50_000))
    z = np.convolve(z, [1.0, 0.5j, 0.2], mode="same").astype(np.complex64)
    np.testing.assert_allclose(to_np(tautocorr(cpu(z), 5)), np.asarray(jautocorr(z, 5)),
                               rtol=W_RTOL, atol=W_ATOL)


def test_levinson_solves_toeplitz_system():
    """tests/test_whitening.py:17-31: the AR(2) process x[n] = 0.6 x[n-1] -
    0.2 x[n-2] + w[n] (2e5 samples) gives the whitening filter [1, -0.6,
    0.2]; the port equals the JAX package's, and its levinson equals JAX's
    on the same autocorrelation."""
    rng = np.random.default_rng(1)
    a1, a2 = 0.6, -0.2
    n = 200_000
    w = rng.normal(size=n)
    x = np.zeros(n)
    for k in range(2, n):
        x[k] = a1 * x[k - 1] + a2 * x[k - 2] + w[k]
    x = x.astype(np.float32)
    c_t = twhiten(cpu(x), 3)
    np.testing.assert_allclose(to_np(c_t), np.asarray(jwhiten(x, 3)), rtol=W_RTOL,
                               atol=W_ATOL)
    assert np.isclose(float(c_t[0]), 1.0)
    assert np.isclose(float(c_t[1]), -a1, atol=0.02) and np.isclose(float(c_t[2]), -a2,
                                                                     atol=0.02)
    r = np.asarray(jautocorr(x, 3))
    np.testing.assert_allclose(to_np(tlevinson(cpu(r), 3)), np.asarray(jlevinson(r, 3)),
                               rtol=W_RTOL, atol=W_ATOL)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_whitening_filter_whitens(dtype):
    """tests/test_whitening.py:34-45: moving-average coloured noise (1e5
    samples) through the 8-tap filter; the port's filter equals JAX's and
    cuts the lag-1 correlation below 30% of the input's."""
    rng = np.random.default_rng(2)
    n = 100_000
    w = rng.normal(size=n)
    if dtype == np.complex64:
        w = w + 1j * rng.normal(size=n)
    x = np.convolve(w, [1.0, 0.7, 0.3], mode="same").astype(dtype)
    c_t = twhiten(cpu(x), 8)
    np.testing.assert_allclose(to_np(c_t), np.asarray(jwhiten(x, 8)), rtol=W_RTOL,
                               atol=W_ATOL)
    y = np.convolve(x, to_np(c_t), mode="same").astype(dtype)
    r_x, r_y = to_np(tautocorr(cpu(x), 3)), to_np(tautocorr(cpu(y), 3))
    assert abs(r_y[1] / r_y[0]) < 0.3 * abs(r_x[1] / r_x[0])


@pytest.mark.gpu
def test_scan_routes_on_gpu_match_cpu():
    """runWL, storeCoeff, mlse and the whitening filter on CUDA tensors
    against CPU tensors, at the pins above."""
    dev = require_cuda()
    sig, sym = mixed_polmux(95, 600)
    for kw in (dict(alg=("da-rde", "dd-lms"), mu=(5e-3, 1e-3), L=(300, 300), runWL=True),
               dict(alg=("nlms",), mu=(2e-3,), storeCoeff=True)):
        cfg = teq.MIMOEqualizerConfig(nTaps=7, SpS=2, M=16, numIter=2, **kw)
        out_c = teq.mimo_adapt_equalizer(cpu(sig), cfg, symb_ref=cpu(sym),
                                         return_results=True)
        out_g = teq.mimo_adapt_equalizer(cpu(sig).to(dev), cfg, symb_ref=cpu(sym).to(dev),
                                         return_results=True)
        assert all(a.is_cuda for a in out_g)
        _assert_eq_results_close(out_g, [to_np(a) for a in out_c])
    x, y, const = _isi(12, 2000, 16, "qam", np.array([1.0, 0.3 + 0.1j]), 0.2)
    np.testing.assert_array_equal(to_np(tmlse(cpu(y).to(dev), [1.0, 0.3 + 0.1j], const)),
                                  to_np(tmlse(cpu(y), [1.0, 0.3 + 0.1j], const)))
    w = np.convolve(np.random.default_rng(5).normal(size=2**16), [1.0, 0.7, 0.3],
                    mode="same").astype(np.float32)
    np.testing.assert_allclose(to_np(twhiten(cpu(w).to(dev), 8)), to_np(twhiten(cpu(w), 8)),
                               rtol=W_RTOL, atol=W_ATOL)
