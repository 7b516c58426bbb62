"""Batched receiving: the batched MIMO equalizer (K3's plain version), the
batched trainer and the batch chain of the port against the JAX package,
and against the port's own single-signal paths.

Tolerances: atol 2e-4 on the equalized symbols and 1e-3 on the taps for the
gradient rules, the JAX package's pins between its scan rules and its
kernels (tests/test_mimo_pallas.py); 3e-4 for schedules with rls stages
and 1e-4 at 4 modes (its batch-vs-single pin, whose sum order depends on B
there). The chain: symbols within 1e-4 on all but 0.1% of them (a BPS
near-tie may turn a symbol by pi/128), BER within 2x + 1e-4 of JAX. Batch
against single in the port is bit-exact.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import metrics as jmetrics  # noqa: E402
from opticommpy_tpu.dsp import EDCConfig, edc  # noqa: E402
from opticommpy_tpu.dsp import equalization as jeq  # noqa: E402
from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas_batch  # noqa: E402
from opticommpy_tpu.models import (  # noqa: E402
    LaserConfig,
    PDMFrontendConfig,
    SSFMConfig,
    basic_laser_model,
    manakov_ssf,
    pdm_coherent_receiver,
)
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx  # noqa: E402
from opticommpy_tpu.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync  # noqa: E402
from opticommpy_tpu.pipelines import CoherentDSPConfig, coherent_dsp_chain_batch  # noqa: E402
from opticommpy_torch import pipelines as tpipe  # noqa: E402
from opticommpy_torch.comm import metrics as tmetrics  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.kernels import bps, mimo_eq, rls  # noqa: E402

from _torch_parity import mixed_polmux, norm_qam, require_cuda, to_np  # noqa: E402

Y_ATOL, H_ATOL, RLS_ATOL, MODES4_ATOL = 2e-4, 1e-3, 3e-4, 1e-4
RULES = ["lms", "nlms", "cma", "rde", "da-rde"]
CHAIN_Y_ATOL, MAX_FLIPPED = 1e-4, 1e-3


def _batch(seed, n_batch, n_sym):
    pairs = [mixed_polmux(seed + b, n_sym) for b in range(n_batch)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _modes(seed, n_sym, n_modes):
    """n_modes-mode 16-QAM at 2 samples/symbol through a random mixing matrix."""
    rng = np.random.default_rng(seed)
    sym = norm_qam(16)[rng.integers(0, 16, size=(n_sym, n_modes))]
    x = np.zeros((2 * n_sym, n_modes), complex)
    x[::2] = sym
    h = np.eye(n_modes) + 0.1 * (rng.normal(size=(n_modes, n_modes))
                                 + 1j * rng.normal(size=(n_modes, n_modes)))
    sig = x @ h.T + 0.01 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    return sig.astype(np.complex64), sym.astype(np.complex64)


def _kernel_args(alg):
    return dict(alg=alg, n_taps=15, sps=2, mu=1e-3, n_train=300)


@pytest.mark.parametrize("alg", RULES)
def test_batch_plain_recurrence_matches_pallas(alg):
    sig, sym = _batch(100 + 10 * RULES.index(alg), 3, 900)
    const = norm_qam(16)
    ref = None if alg in ("cma", "rde") else sym
    y_j, h_j = mimo_eq_pallas_batch(sig, ref, const, block=256, interpret=True,
                                    **_kernel_args(alg))
    y_t, h_t = mimo_eq.mimo_eq_kernel_batch(
        torch.as_tensor(sig), None if ref is None else torch.as_tensor(ref), const,
        **_kernel_args(alg))
    assert y_t.shape == (3, 900, 2) and h_t.shape == (3, 2, 2, 15)
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(to_np(h_t), np.asarray(h_j), rtol=0, atol=H_ATOL)


@pytest.mark.parametrize("alg", RULES)
def test_batch_plain_recurrence_matches_single(alg):
    """The batched plain pass equals the single-signal one per signal, bit for bit."""
    sig, sym = _batch(200 + 10 * RULES.index(alg), 3, 700)
    const = norm_qam(16)
    ref = None if alg in ("cma", "rde") else torch.as_tensor(sym)
    y_b, h_b = mimo_eq.mimo_eq_kernel_batch(torch.as_tensor(sig), ref, const,
                                            **_kernel_args(alg))
    for b in range(3):
        y_s, h_s = mimo_eq.mimo_eq_kernel(torch.as_tensor(sig[b]),
                                          None if ref is None else ref[b], const,
                                          **_kernel_args(alg))
        torch.testing.assert_close(y_b[b], y_s, rtol=0, atol=0)
        torch.testing.assert_close(h_b[b], h_s, rtol=0, atol=0)


def test_batch_custom_h0_and_odd_length():
    const = norm_qam(4)
    rng = np.random.default_rng(1)
    b, n_sym, n_taps = 2, 333, 7
    sig = (0.5 * (rng.normal(size=(b, n_sym * 2, 2))
                  + 1j * rng.normal(size=(b, n_sym * 2, 2)))).astype(np.complex64)
    ref = const[rng.integers(0, 4, size=(b, n_sym, 2))]
    h0 = np.zeros((b, 2, 2, n_taps), np.complex64)
    h0[:, 0, 0, 3] = 0.9
    h0[:, 1, 1, 3] = 1.1
    kw = dict(alg="lms", n_taps=n_taps, sps=2, mu=1e-3, n_train=100)
    y_j, h_j = mimo_eq_pallas_batch(sig, ref, const, block=128, H0=h0, interpret=True, **kw)
    y_t, h_t = mimo_eq.mimo_eq_kernel_batch(torch.as_tensor(sig), torch.as_tensor(ref),
                                            const, H0=torch.as_tensor(h0), **kw)
    assert y_t.shape == (b, n_sym, 2) and torch.isfinite(y_t).all()
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(to_np(h_t), np.asarray(h_j), rtol=0, atol=H_ATOL)


def test_batch_three_modes():
    pairs = [_modes(300 + b, 800, 3) for b in range(3)]
    sig = np.stack([p[0] for p in pairs])
    sym = np.stack([p[1] for p in pairs])
    const = norm_qam(16)
    kw = dict(alg="lms", n_taps=5, sps=2, mu=1e-3, n_train=400)
    y_j, h_j = mimo_eq_pallas_batch(sig, sym, const, block=256, interpret=True, **kw)
    y_t, h_t = mimo_eq.mimo_eq_kernel_batch(torch.as_tensor(sig), torch.as_tensor(sym),
                                            const, **kw)
    assert y_t.shape == (3, 800, 3) and h_t.shape == (3, 3, 3, 5)
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(to_np(h_t), np.asarray(h_j), rtol=0, atol=H_ATOL)


@pytest.mark.parametrize("algs,mus,backend", [
    (("nlms", "dd-lms"), (2e-3, 1e-3), "pallas"),
    (("rls", "dd-rls"), (1e-3, 1e-3), "pallas"),
    (("da-rde", "dd-lms"), (5e-3, 1e-3), "scan"),
    (("rls", "dd-lms"), (1e-3, 1e-3), "scan"),
], ids=["nlms_ddlms-pallas", "rls_ddrls-pallas", "darde_ddlms-scan", "rls_ddlms-scan"])
def test_adapt_equalizer_batch_matches_single_and_jax(algs, mus, backend):
    """The batched trainer equals the port's per-signal trainer bit for bit,
    and the JAX batched trainer within tolerance."""
    rng = np.random.default_rng(7)
    n_sym, B = 1500, 3
    const = norm_qam(16)
    sigs, syms = [], []
    for _ in range(B):
        sym = const[rng.integers(0, 16, size=(n_sym, 2))]
        x = np.zeros((n_sym * 2, 2), complex)
        x[::2] = sym
        h = np.eye(2) + 0.1 * (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))
        sigs.append(x @ h.T + 0.01 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)))
        syms.append(sym)
    sig_b = np.stack(sigs).astype(np.complex64)
    sym_b = np.stack(syms).astype(np.complex64)
    jcfg = jeq.MIMOEqualizerConfig(nTaps=9, SpS=2, mu=mus, alg=algs, L=(700, n_sym - 700),
                                   M=16, numIter=2, backend=backend)
    cfg = config_from_jax(jcfg)
    yb, Hb, eb = teq.mimo_adapt_equalizer_batch(torch.as_tensor(sig_b), cfg,
                                                symb_ref=torch.as_tensor(sym_b),
                                                return_results=True)
    assert yb.shape == (B, n_sym, 2) and Hb.shape == (B, 2, 2, 9) and eb.shape == (B, 2, n_sym)
    for b in range(B):
        y, H, _, es, _ = teq.mimo_adapt_equalizer(torch.as_tensor(sig_b[b]), cfg,
                                                  symb_ref=torch.as_tensor(sym_b[b]),
                                                  return_results=True)
        torch.testing.assert_close(yb[b], y, rtol=0, atol=0)
        torch.testing.assert_close(Hb[b], H, rtol=0, atol=0)
        torch.testing.assert_close(eb[b], es, rtol=0, atol=0)
    yj, Hj, ej = jeq.mimo_adapt_equalizer_batch(sig_b, jcfg, symb_ref=sym_b,
                                                return_results=True)
    atol = RLS_ATOL if "rls" in algs[0] else Y_ATOL
    np.testing.assert_allclose(to_np(yb), np.asarray(yj), rtol=0, atol=atol)
    np.testing.assert_allclose(to_np(Hb), np.asarray(Hj), rtol=0,
                               atol=RLS_ATOL if "rls" in algs[0] else H_ATOL)
    np.testing.assert_allclose(to_np(eb), np.asarray(ej), rtol=0, atol=atol)


@pytest.mark.parametrize("algs", [("nlms", "dd-lms"), ("rls", "dd-lms")],
                         ids=["nlms_ddlms", "rls_ddlms"])
def test_adapt_equalizer_batch_4x4(algs):
    """4 modes: batch == single in the port (exact at any mode count); both
    within 1e-4 of the JAX batched trainer."""
    pairs = [_modes(400 + b, 1200, 4) for b in range(2)]
    sig_b = np.stack([p[0] for p in pairs])
    sym_b = np.stack([p[1] for p in pairs])
    jcfg = jeq.MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(1e-3, 1e-3), alg=algs,
                                   L=(500, 700), M=16, lambdaRLS=0.999, backend="pallas")
    yb = teq.mimo_adapt_equalizer_batch(torch.as_tensor(sig_b), config_from_jax(jcfg),
                                        symb_ref=torch.as_tensor(sym_b))
    for b in range(2):
        y = teq.mimo_adapt_equalizer(torch.as_tensor(sig_b[b]), config_from_jax(jcfg),
                                     symb_ref=torch.as_tensor(sym_b[b]))
        torch.testing.assert_close(yb[b], y, rtol=0, atol=0)
    yj = jeq.mimo_adapt_equalizer_batch(sig_b, jcfg, symb_ref=sym_b)
    np.testing.assert_allclose(to_np(yb), np.asarray(yj), rtol=0, atol=MODES4_ATOL)


def test_gradient_stages_reach_k3_once_per_pass():
    sig, sym = _batch(500, 2, 600)
    cfg = teq.MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(5e-3, 1e-3), alg=("da-rde", "dd-lms"),
                                  L=(300, 300), M=16, numIter=2, backend="pallas")
    with mock.patch.object(mimo_eq, "mimo_eq_stage_batch",
                           wraps=mimo_eq.mimo_eq_stage_batch) as k3, \
            mock.patch.object(mimo_eq, "mimo_eq_stage", wraps=mimo_eq.mimo_eq_stage) as k2:
        y = teq.mimo_adapt_equalizer_batch(torch.as_tensor(sig), cfg,
                                           symb_ref=torch.as_tensor(sym))
    assert (k3.call_count, k2.call_count) == (3, 0)
    assert [c.args[5] for c in k3.call_args_list] == ["da-rde", "da-rde", "lms"]
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("change,error", [
    (dict(storeCoeff=True), ValueError),
])
def test_adapt_equalizer_batch_rejects(change, error):
    """storeCoeff has no history return in the batch API: the JAX package's
    ValueError, mirrored."""
    sig, sym = _batch(510, 2, 128)
    cfg = teq.MIMOEqualizerConfig(nTaps=7, M=16, backend="pallas", **change)
    with pytest.raises(error, match="storeCoeff"):
        teq.mimo_adapt_equalizer_batch(torch.as_tensor(sig), cfg,
                                       symb_ref=torch.as_tensor(sym))


@pytest.mark.parametrize("change", [
    dict(runWL=True), dict(blockUpdate=16), dict(blockUpdate=4, alg=("nlms",))],
    ids=["runWL", "block16", "block4_nlms"])
def test_adapt_equalizer_batch_formerly_unported_match_jax(change):
    """The batch trainer's options that raised NotImplementedError before
    the port had them: the same configurations (2 signals of 64 symbols)
    now match the JAX package's batch trainer, outputs, taps and errors."""
    sig, sym = _batch(510, 2, 128)
    jcfg = jeq.MIMOEqualizerConfig(nTaps=7, M=16, backend="pallas", **change)
    y_j, H_j, e_j = jeq.mimo_adapt_equalizer_batch(sig, jcfg, symb_ref=sym,
                                                   return_results=True)
    y_t, H_t, e_t = teq.mimo_adapt_equalizer_batch(
        torch.as_tensor(sig), config_from_jax(jcfg), symb_ref=torch.as_tensor(sym),
        return_results=True)
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(to_np(H_t), np.asarray(H_j), rtol=0, atol=H_ATOL)
    np.testing.assert_allclose(to_np(e_t), np.asarray(e_j), rtol=0, atol=Y_ATOL)


# -- the batch chain on two small links (tests/test_pipelines.py:342-388) --

@pytest.fixture(scope="module")
def links():
    """(received waveforms (2, N, 2), synchronized references (2, nSym, 2)), NumPy."""
    sigs, refs = [], []
    for seed in (41, 42):
        k_tx, k_ch, k_lo, k_rx = jax.random.split(jax.random.PRNGKey(seed), 4)
        cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=2**15, nChannels=1,
                             nPolModes=2, nFilterTaps=512, pulseRollOff=0.01,
                             powerPerChannel=(0.0,), laserLinewidth=50e3)
        fs = cfg_tx.Fs
        sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
        cfg_ch = SSFMConfig(Ltotal=50, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fs=fs,
                            amp="edfa", nlprMethod=False, hz=1.0)
        sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
        lo = basic_laser_model(LaserConfig(P=10.0, lw=50e3, Ns=sig_ch.shape[0], Fs=fs,
                                           freqShift=50e6, RIN_var=0.0), k_lo)
        sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), key=k_rx)
        pre = decimate(fir_filter(pulse_shape("rrc", cfg_tx.SpS, 512, 0.01), sig_rx),
                       cfg_tx.SpS, 2)
        pre = edc(pre, EDCConfig(L=50, D=16, Fs=2 * 32e9, Rs=32e9))
        refs.append(np.asarray(pnorm(symbol_sync(pre, symb_tx[:, :, 0], 2))))
        sigs.append(np.asarray(sig_rx))
    return np.stack(sigs), np.stack(refs)


def _chain_cfg(**kw):
    return CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=3000, **kw)


@pytest.mark.parametrize("kw", [dict(mu=(2e-3,)),
                                dict(mu=(5e-3, 2e-3), eqBackend="pallas"),
                                dict(mu=(5e-3, 1e-3), eqBackend="pallas", blockUpdate=16)],
                         ids=["lms", "pallas-schedule", "blocked-schedule"])
def test_chain_batch_matches_jax(links, kw):
    sig_b, ref_b = links
    cfg = _chain_cfg(**kw)
    y_j, ph_j = coherent_dsp_chain_batch(sig_b, ref_b, cfg)
    y_t, ph_t = tpipe.coherent_dsp_chain_batch(torch.as_tensor(sig_b),
                                               torch.as_tensor(ref_b), config_from_jax(cfg))
    assert y_t.shape == ref_b.shape and ph_t.shape == (ref_b.shape[1], 4)
    d = np.abs(to_np(y_t) - np.asarray(y_j))
    assert np.mean(d > CHAIN_Y_ATOL) <= MAX_FLIPPED, np.mean(d > CHAIN_Y_ATOL)
    assert d.max() < 0.05, d.max()
    disc = 4000
    for i in range(2):
        ref = ref_b[i][disc:-100]
        ber_j, _, _ = jmetrics.fast_ber_calc(np.asarray(y_j)[i, disc:-100], ref, 16, "qam")
        ber_t, _, _ = tmetrics.fast_ber_calc(y_t[i, disc:-100], torch.as_tensor(ref), 16, "qam")
        assert np.all(np.asarray(ber_j) < 1e-2)
        assert np.all(to_np(ber_t) <= 2 * np.asarray(ber_j) + 1e-4), (to_np(ber_t), ber_j)


@pytest.mark.parametrize("algs,wrapped,passes", [
    (("da-rde", "dd-lms"), "mimo_eq_stage_batch", 3),
    (("rls", "dd-rls"), "rls_stage_batch", 3),
    (None, "mimo_eq_stage_batch", 1),
], ids=["darde_ddlms", "rls_ddrls", "lms"])
def test_chain_batch_reaches_kernels_once_per_pass(links, algs, wrapped, passes):
    """The batch chain calls the batched equalizer wrapper once per training
    pass (K3 or K5; never the single-signal K2) and the BPS kernel entry
    once for all signals."""
    sig_b, ref_b = links
    n = 2048
    kw = dict(alg=algs, eqBackend="pallas") if algs else {}
    cfg = tpipe.CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=1000,
                                  mu=(5e-3, 2e-3), **kw)
    module = mimo_eq if wrapped.startswith("mimo") else rls
    with mock.patch.object(module, wrapped, wraps=getattr(module, wrapped)) as eq, \
            mock.patch.object(mimo_eq, "mimo_eq_stage", wraps=mimo_eq.mimo_eq_stage) as k2, \
            mock.patch.object(bps, "bps_kernel", wraps=bps.bps_kernel) as k1:
        y, phases = tpipe.coherent_dsp_chain_batch(
            torch.as_tensor(sig_b[:, :n * 8]), torch.as_tensor(ref_b[:, :n]), cfg)
    assert (eq.call_count, k2.call_count, k1.call_count) == (passes, 0, 1)
    assert k1.call_args.args[0].shape == (n, 4)  # the batch folded into the columns
    assert y.shape == (2, n, 2) and phases.shape == (n, 4)


def test_chain_batch_clock_recovery_not_ported(links):
    """The batch chain takes feedforward clock recovery only: Gardner raises
    the JAX package's NotImplementedError (no batched NCO), mirrored as it
    is (tests/test_pipelines.py:209-212)."""
    sig_b, ref_b = links
    cfg = tpipe.CoherentDSPConfig(SpS_in=8, runCR=True, crMethod="gardner")
    with pytest.raises(NotImplementedError, match="crMethod='ffw'"):
        tpipe.coherent_dsp_chain_batch(torch.as_tensor(sig_b), torch.as_tensor(ref_b), cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("alg", RULES)
def test_batched_kernel_matches_plain_on_gpu(alg):
    dev = require_cuda()
    sig, sym = _batch(600, 3, 4096)
    const = norm_qam(16)
    sig_pad, ref, h0 = mimo_eq._kernel_inputs(torch.as_tensor(sig, device=dev),
                                              torch.as_tensor(sym, device=dev), None, 15, 2,
                                              None)
    args = (sig_pad, ref, mimo_eq._flat(h0), const, mimo_eq.stage_aux(alg, const), alg,
            1e-3, 1000 if alg == "lms" else 4096, 2, 15, 0, 4096)
    before = mimo_eq.batch_launches
    y_k, h_k = mimo_eq.mimo_eq_stage_batch(*args)
    assert mimo_eq.batch_launches == before + 1
    y_p, h_p = mimo_eq.mimo_eq_stage_batch_plain(*args)
    torch.cuda.synchronize()
    assert float((y_k - y_p).abs().max()) < Y_ATOL
    assert float((h_k - h_p).abs().max()) < H_ATOL


@pytest.mark.gpu
def test_batched_kernel_bit_identical_to_single_on_gpu():
    dev = require_cuda()
    sig, sym = _batch(700, 4, 4096)
    const = norm_qam(16)
    y_b, h_b = mimo_eq.mimo_eq_kernel_batch(torch.as_tensor(sig, device=dev),
                                            torch.as_tensor(sym, device=dev), const,
                                            alg="lms", n_train=1000)
    for b in range(4):
        y_s, h_s = mimo_eq.mimo_eq_kernel(torch.as_tensor(sig[b], device=dev),
                                          torch.as_tensor(sym[b], device=dev), const,
                                          alg="lms", n_train=1000)
        assert torch.equal(y_b[b], y_s) and torch.equal(h_b[b], h_s)


@pytest.mark.gpu
@pytest.mark.parametrize("n_batch", [1, 11])
@pytest.mark.parametrize("alg", RULES)
def test_batched_kernel_b1_b11_bit_identical_to_k2_on_gpu(alg, n_batch):
    """K3 on B = 1 and B = 11 signals (the batch chain's width): each signal
    equals K2 on it alone bit for bit, and the batch the plain version."""
    dev = require_cuda()
    sig, sym = _batch(800, n_batch, 1000)
    const = norm_qam(16)
    sig_pad, ref, h0 = mimo_eq._kernel_inputs(torch.as_tensor(sig, device=dev),
                                              torch.as_tensor(sym, device=dev), None, 15, 2,
                                              None)
    args = (const, mimo_eq.stage_aux(alg, const), alg, 1e-3, 300, 2, 15, 0, 1000)
    h_flat = mimo_eq._flat(h0)
    y_b, h_b = mimo_eq.mimo_eq_stage_batch(sig_pad, ref, h_flat, *args)
    y_p, h_p = mimo_eq.mimo_eq_stage_batch_plain(sig_pad, ref, h_flat, *args)
    torch.cuda.synchronize()
    assert float((y_b - y_p).abs().max()) < Y_ATOL
    assert float((h_b - h_p).abs().max()) < H_ATOL
    for b in range(n_batch):
        y_s, h_s = mimo_eq.mimo_eq_stage(sig_pad[b], ref[b], h_flat[b], *args)
        assert torch.equal(y_b[b], y_s) and torch.equal(h_b[b], h_s)
