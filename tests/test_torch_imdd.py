"""The port's IM-DD path against the JAX package: PRBS and bit sources, the
OOK/PAM metrics and unit helpers, the PAM transmitter's build on JAX's
symbols, the linear fiber, the OOK ``bert`` chain, and
``imdd_dsp_chain_batch`` on JAX-drawn 10 km PAM4 currents
(``tests/test_end_to_end_imdd.py``), with its route to K13.

Tolerances:
- PRBS and ``bit_source('prbs')``: equal bit for bit.
- ``qfunc`` on tensors, ``ber2qfactor``, ``llr2bit_prob``, ``bert``: 1e-6
  relative (float32 in both packages). ``qfunc`` on NumPy input and
  ``theory_ber`` are float64 in the port and float32 in JAX (x64 off):
  1e-6 relative plus 1e-7 absolute, as JAX's ``0.5 - 0.5*erf`` in float32
  loses ~4e-8 to cancellation where ``erf`` nears 1.
- ``pam_tx_build`` and ``linear_fiber_channel``: 2e-6 of the peak (float32
  FFT convolutions in both; the fiber's float32 dispersion phase, up to
  ~40 rad at 10 km, is computed as JAX computes it).
- The chain: the JAX gates (BER < 1e-3 after 2 nTrain, tail MSE < 0.05)
  per signal, ``y`` within 1e-4 of the JAX chain (the DC mean and the
  per-row ``pnorm`` reduce in another order, and the LMS recurrence carries
  those ulps along), and single equal to batch bit for bit.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import metrics as jmetrics  # noqa: E402
from opticommpy_tpu.comm import sources as jsources  # noqa: E402
from opticommpy_tpu.models import (  # noqa: E402
    LinearFiberConfig,
    PhotodiodeConfig,
    linear_fiber_channel,
    photodiode,
)
from opticommpy_tpu.models.tx import PAMTxConfig, pam_transmitter  # noqa: E402
from opticommpy_tpu.ops import signal as jsig  # noqa: E402
from opticommpy_tpu.pipelines import IMDDConfig, imdd_dsp_chain_batch  # noqa: E402
from opticommpy_tpu.utils import units as junits  # noqa: E402
from opticommpy_torch import pipelines as tpipe  # noqa: E402
from opticommpy_torch.comm import metrics as tmetrics  # noqa: E402
from opticommpy_torch.comm import sources as tsources  # noqa: E402
from opticommpy_torch.comm.modulation import modulate_gray  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.kernels import dfe as k13  # noqa: E402
from opticommpy_torch.kernels import volterra as k14  # noqa: E402
from opticommpy_torch.models import channels as tch  # noqa: E402
from opticommpy_torch.models import config as tcfg  # noqa: E402
from opticommpy_torch.models import devices as tdev  # noqa: E402
from opticommpy_torch.models import tx as ttx  # noqa: E402
from opticommpy_torch.ops import signal as tsig  # noqa: E402
from opticommpy_torch.ops.filtering import fir_filter, pulse_shape  # noqa: E402
from opticommpy_torch.utils import units as tunits  # noqa: E402

from _torch_parity import rel_err, to_np  # noqa: E402

CHAIN_Y_ATOL = 1e-4
CPU = torch.device("cpu")


@pytest.mark.parametrize("order", [7, 9, 11, 13, 15, 23, 31])
def test_prbs_generator_equals_jax(order):
    n = min(2**order - 1, 70000)
    for seed in (1, 0x55):
        ref = np.asarray(jsources.prbs_generator(order, n, seed))
        got = tsources.prbs_generator(order, n, seed, device=CPU)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(to_np(got), ref)


@pytest.mark.parametrize("n_bits,seed", [(1000, 7), (300, 0)])
def test_bit_source_prbs_equals_jax(n_bits, seed):
    """Order 7 repeats its 127-bit period; seed 0 starts the register at 1."""
    ref = np.asarray(jsources.bit_source(seed, n_bits, mode="prbs", order=7))
    got = tsources.bit_source(seed, n_bits, mode="prbs", order=7, device=CPU)
    np.testing.assert_array_equal(to_np(got), ref)


def test_bit_source_random_and_seeded_entries():
    gen = torch.Generator().manual_seed(3)
    bits = tsources.bit_source(gen, 20000)
    assert bits.dtype == torch.int32 and set(bits.unique().tolist()) == {0, 1}
    assert abs(float(bits.float().mean()) - 0.5) < 0.02
    assert torch.equal(tsources.bit_source(5, 64, device=CPU),
                       tsources.bit_source(5, 64, device=CPU))
    with pytest.raises(ValueError):
        tsources.bit_source(0, 10, mode="other", device=CPU)
    with pytest.raises(ValueError):
        tsources.prbs_generator(8, 10, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsources.bit_source(1, 10)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttx.pam_transmitter(1, ttx.PAMTxConfig(nBits=64, SpS=4))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsources.prbs_generator(7, 10)


def test_unit_helpers_and_qfunc_match_jax():
    ber = np.array([1e-9, 1e-6, 1e-3, 0.01, 0.2], np.float32)
    np.testing.assert_allclose(to_np(tunits.ber2qfactor(torch.as_tensor(ber))),
                               np.asarray(junits.ber2qfactor(jnp.asarray(ber))), rtol=1e-6)
    assert abs(tunits.ber2qfactor(1e-3) - float(junits.ber2qfactor(1e-3))) < 1e-5
    llr = np.linspace(-40, 40, 101).astype(np.float32)
    np.testing.assert_allclose(to_np(tunits.llr2bit_prob(torch.as_tensor(llr))),
                               np.asarray(junits.llr2bit_prob(jnp.asarray(llr))), rtol=1e-6)
    x = np.linspace(-3, 2, 41).astype(np.float32)
    np.testing.assert_allclose(to_np(tmetrics.qfunc(torch.as_tensor(x))),
                               np.asarray(jmetrics.qfunc(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(tmetrics.qfunc(x), np.asarray(jmetrics.qfunc(x)), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("M,kind", [(4, "pam"), (16, "qam"), (8, "psk")])
def test_theory_ber_matches_jax(M, kind):
    ebn0 = np.arange(0.0, 14.0, 1.0)
    ref = np.asarray(jmetrics.theory_ber(M, ebn0, kind), np.float64)
    got = tmetrics.theory_ber(M, ebn0, kind)
    assert got.dtype == np.float64 and (got[1:] < got[:-1]).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tmetrics.theory_ber(M, ebn0, "ook")


def test_bert_matches_jax():
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=5000).astype(np.int32)
    i_rx = (bits * 1.0 + 0.2 + 0.18 * rng.normal(size=5000)).astype(np.float32)
    ber_j, q_j = jmetrics.bert(jnp.asarray(i_rx), jnp.asarray(bits))
    ber_t, q_t = tmetrics.bert(torch.as_tensor(i_rx), torch.as_tensor(bits))
    assert float(ber_j) > 0
    np.testing.assert_allclose(float(ber_t), float(ber_j), rtol=1e-6)
    np.testing.assert_allclose(float(q_t), float(q_j), rtol=1e-6)


def test_anorm_and_signal_power_match_jax():
    rng = np.random.default_rng(12)
    x = (rng.normal(size=(500, 2)) + 1j * rng.normal(size=(500, 2))).astype(np.complex64)
    np.testing.assert_allclose(to_np(tsig.anorm(torch.as_tensor(x))),
                               np.asarray(jsig.anorm(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(float(tsig.signal_power(torch.as_tensor(x))),
                               float(jsig.signal_power(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("n_pol", [1, 2])
def test_pam_tx_build_and_fiber_on_jax_symbols(n_pol):
    jcfg = PAMTxConfig(M=4, Rs=25e9, SpS=8, nBits=2**12, pulseType="nrz", power=3.0,
                       nPolModes=n_pol)
    sig_j, symb_j = pam_transmitter(jax.random.PRNGKey(3), jcfg)
    cfg = config_from_jax(jcfg)
    symb = torch.as_tensor(np.array(symb_j).reshape(cfg.nSymbols, n_pol))
    sig_t = ttx.pam_tx_build(symb, cfg)
    sig_t = sig_t[:, 0] if n_pol == 1 else sig_t
    peak = float(np.abs(np.asarray(sig_j)).max())
    np.testing.assert_allclose(to_np(sig_t), np.asarray(sig_j), rtol=0, atol=2e-6 * peak)
    fcfg = LinearFiberConfig(L=10, alpha=0.2, D=17, Fs=cfg.Fs)
    rx_j = linear_fiber_channel(sig_j, fcfg)
    rx_t = tch.linear_fiber_channel(torch.as_tensor(np.array(sig_j)), config_from_jax(fcfg))
    assert rx_t.shape == rx_j.shape and rx_t.dtype == torch.complex64
    np.testing.assert_allclose(to_np(rx_t), np.asarray(rx_j), rtol=0, atol=2e-6 * peak)
    with pytest.raises(ValueError, match="Fs"):
        tch.linear_fiber_channel(rx_t, tcfg.LinearFiberConfig())


def test_pam_transmitter_draws_on_the_generator_device():
    cfg = ttx.PAMTxConfig(M=4, SpS=8, nBits=8000, power=0.0)
    sig, symb = ttx.pam_transmitter(torch.Generator().manual_seed(1), cfg)
    assert sig.shape == (cfg.nSymbols * 8,) and symb.shape == (cfg.nSymbols,)
    assert sig.dtype == torch.complex64 and not sig.is_cuda
    np.testing.assert_allclose(float(tsig.sig_pow(sig)), 1e-3, rtol=1e-5)
    assert len(np.unique(np.round(to_np(symb), 4))) == 4


def _ook_chain(prx_dbm, n_bits=20000, seed=0):
    """tests/test_end_to_end_imdd.py:29-67 on the port: 10G OOK, MZM ->
    linear fiber -> EDFA preamp -> pin PD, noise from one generator."""
    gen = torch.Generator().manual_seed(seed)
    sps, fs = 16, 10e9 * 16
    bits = tsources.bit_source(gen, n_bits)
    symb = modulate_gray(bits, 2, "ook").real.to(torch.float32)
    sig = fir_filter(pulse_shape("nrz", sps), tsig.upsample(symb, sps))
    vpi = 2.0
    sig_txo = tdev.mzm(torch.ones_like(sig) + 0j, 0.25 * vpi * (2 * sig - 1),
                       tcfg.MZMConfig(Vpi=vpi, Vb=-vpi / 2, ER=60))
    sig_txo = sig_txo * torch.sqrt(tunits.dbm2w(prx_dbm) / torch.mean(torch.abs(sig_txo) ** 2))
    sig_rx = tch.linear_fiber_channel(sig_txo, tcfg.LinearFiberConfig(L=0.1, alpha=0.0, D=17,
                                                                       Fs=fs))
    sig_rx = tdev.edfa(sig_rx, tcfg.EDFAConfig(G=20.0, NF=4.5, Fs=fs), gen)
    i_rx = tdev.photodiode(sig_rx, tcfg.PhotodiodeConfig(Fs=fs, B=10e9), gen)
    i_rx = i_rx / torch.mean(i_rx) / 2
    return tmetrics.bert(i_rx[0::sps][:n_bits][8:-8], bits[8:-8])


def test_ook_bert_chain_on_the_port():
    ber_low, q_low = _ook_chain(-30.0)
    ber_high, q_high = _ook_chain(-20.0)
    assert float(q_high) > float(q_low) and float(ber_high) <= float(ber_low)
    assert float(ber_high) < 1e-3
    ber, q = _ook_chain(-15.0)
    assert float(ber) == 0.0 and float(q) > 6.0


@pytest.fixture(scope="module")
def jax_links():
    """Four JAX-drawn 10 km PAM4 links (test_end_to_end_imdd.py:141-154)."""
    cfg_tx = PAMTxConfig(M=4, Rs=25e9, SpS=8, nBits=2**15, pulseType="nrz", power=3.0)
    fs = cfg_tx.Fs
    currents, refs = [], []
    for seed in range(4):
        k_tx, k_pd = jax.random.split(jax.random.PRNGKey(100 + seed))
        sig, symb = pam_transmitter(k_tx, cfg_tx)
        rx = linear_fiber_channel(sig, LinearFiberConfig(L=10, alpha=0.2, D=17, Fs=fs))
        currents.append(np.asarray(photodiode(rx, PhotodiodeConfig(Fs=fs, B=20e9), k_pd)))
        refs.append(np.asarray(symb))
    return np.stack(currents).astype(np.float32), np.stack(refs).astype(np.float32)


@pytest.mark.parametrize("eq", ["dfe", "ffe"])
def test_imdd_chain_matches_jax_and_passes_its_gates(jax_links, eq):
    i_b, ref_b = jax_links
    jcfg = IMDDConfig(SpS_in=8, nTapsFF=15, nTapsFB=5, mu=2e-3, nTrain=6000, eq=eq)
    y_j, mse_j = imdd_dsp_chain_batch(jnp.asarray(i_b), jnp.asarray(ref_b), jcfg)
    with mock.patch.object(k13, "dfe_run", wraps=k13.dfe_run) as route:
        y, mse = tpipe.imdd_dsp_chain_batch(torch.as_tensor(i_b), torch.as_tensor(ref_b),
                                            config_from_jax(jcfg))
    assert route.call_count == 1  # every signal in one pass (one K13 launch on CUDA)
    assert route.call_args.args[0].shape[0] == 4
    assert y.shape == ref_b.shape
    assert y.dtype == (torch.complex64 if eq == "dfe" else torch.float32)
    np.testing.assert_allclose(to_np(y), np.asarray(y_j), rtol=0, atol=CHAIN_Y_ATOL)
    assert rel_err(mse, mse_j) < 1e-3
    post = slice(2 * jcfg.nTrain, None)
    for b in range(4):
        ber, _, _ = tmetrics.fast_ber_calc(y[b, post].real,
                                           tsig.pnorm(torch.as_tensor(ref_b[b]))[post], 4, "pam")
        assert float(ber[0]) < 1e-3, (b, float(ber[0]))
        assert float(mse[b, -4000:].mean()) < 0.05


def test_imdd_chain_single_equals_batch(jax_links):
    i_b, ref_b = jax_links
    cfg = tpipe.IMDDConfig(SpS_in=8, nTapsFF=15, nTapsFB=5, mu=2e-3, nTrain=3000)
    n = 8 * 8192
    y_b, mse_b = tpipe.imdd_dsp_chain_batch(torch.as_tensor(i_b[:2, :n]),
                                            torch.as_tensor(ref_b[:2, :8192]), cfg)
    y_1, mse_1 = tpipe.imdd_dsp_chain_batch(torch.as_tensor(i_b[1, :n]),
                                            torch.as_tensor(ref_b[1, :8192]), cfg)
    assert torch.equal(y_b[1], y_1) and torch.equal(mse_b[1], mse_1)


# a NumPy input means the default device, the card; only a CPU tensor asks
# for the CPU
NUMPY_ENTRIES = {
    "imdd_dsp_chain_batch": lambda x, s: tpipe.imdd_dsp_chain_batch(
        x, s, tpipe.IMDDConfig(SpS_in=1, nTrain=50)),
    "dfe_kernel": lambda x, s: k13.dfe_kernel(x, s, teq.DFEConfig(nTrain=50)),
    "ffe_kernel": lambda x, s: k13.ffe_kernel(x, s, teq.FFEConfig(nTrain=50)),
    "volterra_kernel": lambda x, s: k14.volterra_kernel(x, s, teq.VolterraConfig(nTrain=50)),
    "dfe": lambda x, s: teq.dfe(x, s, teq.DFEConfig(nTrain=50)),
    "ffe": lambda x, s: teq.ffe(x, s, teq.FFEConfig(nTrain=50)),
    "volterra": lambda x, s: teq.volterra(x, s, teq.VolterraConfig(nTrain=50)),
}


@pytest.mark.parametrize("entry", sorted(NUMPY_ENTRIES))
def test_numpy_input_raises_without_a_card(entry, monkeypatch):
    rng = np.random.default_rng(0)
    s = (2 * rng.integers(0, 4, size=200) - 3).astype(np.float32)
    x = s + 0.1 * rng.normal(size=200).astype(np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NUMPY_ENTRIES[entry](x, s)
    NUMPY_ENTRIES[entry](torch.as_tensor(x), torch.as_tensor(s))  # a CPU tensor runs


@pytest.mark.parametrize("n,cplx", [(1, False), (1000, False), (4096, False), (777, True)])
def test_row_reductions_are_batch_invariant(n, cplx):
    """``row_mean`` and ``pnorm_rows`` (the chain's DC removal and per-row
    normalization) against NumPy and JAX, and a row's result equal bit for
    bit alone and in a batch."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, n)) + 2.0
    if cplx:
        x = x + 1j * rng.normal(size=(3, n))
    x = x.astype(np.complex64 if cplx else np.float32)
    t = torch.as_tensor(x)
    np.testing.assert_allclose(to_np(tsig.row_mean(t)), x.astype(np.complex128).mean(1)
                               if cplx else x.astype(np.float64).mean(1), rtol=1e-6)
    p = tsig.pnorm_rows(t)
    for b in range(3):
        assert torch.equal(p[b], tsig.pnorm_rows(t[b]))
        assert torch.equal(tsig.row_mean(t)[b], tsig.row_mean(t[b]))
        np.testing.assert_allclose(to_np(p[b]), np.asarray(jsig.pnorm(jnp.asarray(x[b]))),
                                   rtol=1e-6, atol=1e-7)
