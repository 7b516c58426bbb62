"""Clock recovery of the port against the JAX package: the resampling
impairment model, the Gardner loop (its reference rule and K6's plain
version), feedforward retiming, and runCR in both chains.

Tolerances:
- clock_sampling_interp: 1e-6 (float32 time axes in both; the port's
  interpolation rounds like jnp.interp up to FMA contraction in XLA).
- Gardner: 1e-5 on samples and timing with equal output length (the JAX
  package's own pin between its kernel and its while_loop). Both run the
  same float32 recurrence; XLA may contract a multiply-add into an FMA,
  which moves a value by an ulp but must not flip a skip/stuff decision.
- FFW: ppm estimate within 0.1 ppm of JAX; retimed samples within 2e-5
  (the band-edge sums reduce in another order, which moves the fitted
  timing by ~1e-7 samples).
- Chains: the equalized symbols within 1e-4 on all but 0.1% of them (a BPS
  near-tie may turn a symbol by pi/128), no cycle slip, BER within 2x +
  1e-4 of JAX.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import metrics as jmetrics  # noqa: E402
from opticommpy_tpu.comm import modulate_gray  # noqa: E402
from opticommpy_tpu.dsp import EDCConfig, edc  # noqa: E402
from opticommpy_tpu.dsp import clock_recovery as jcr  # noqa: E402
from opticommpy_tpu.models import (  # noqa: E402
    LaserConfig,
    PDMFrontendConfig,
    SSFMConfig,
    basic_laser_model,
    manakov_ssf,
    pdm_coherent_receiver,
)
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx  # noqa: E402
from opticommpy_tpu.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync, upsample  # noqa: E402
from opticommpy_tpu.ops.signal import clock_sampling_interp  # noqa: E402
from opticommpy_tpu.pipelines import (  # noqa: E402
    CoherentDSPConfig,
    coherent_dsp_chain,
    coherent_dsp_chain_batch,
)
from opticommpy_torch import pipelines as tpipe  # noqa: E402
from opticommpy_torch.comm import metrics as tmetrics  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.dsp import clock_recovery as tcr  # noqa: E402
from opticommpy_torch.kernels import gardner  # noqa: E402
from opticommpy_torch.ops import signal as tsig  # noqa: E402

from _torch_parity import require_cuda, to_np  # noqa: E402

CSI_ATOL, CR_ATOL, FFW_ATOL, PPM_ATOL = 1e-6, 1e-5, 2e-5, 0.1
CHAIN_Y_ATOL, MAX_FLIPPED = 1e-4, 1e-3


def _qpsk_wave(rng, n_sym, sps=2, rolloff=0.2):
    symb = pnorm(modulate_gray(jnp.asarray(rng.integers(0, 2, size=2 * n_sym)), 4, "qam"))
    return fir_filter(jnp.asarray(pulse_shape("rrc", sps, 512, rolloff)), upsample(symb, sps))


# -- the resampling impairment model ----------------------------------------

@pytest.mark.parametrize("ratio", [1 + 300e-6, 1 - 150e-6, 0.37])
def test_clock_sampling_interp_matches_jax(ratio):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3001, 2)) + 1j * rng.normal(size=(3001, 2))).astype(np.complex64)
    ref = np.asarray(clock_sampling_interp(x, 1.0, ratio))
    out = tsig.clock_sampling_interp(torch.as_tensor(x), 1.0, ratio)
    assert out.shape == ref.shape and out.dtype == torch.complex64
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=CSI_ATOL)
    real = tsig.clock_sampling_interp(torch.as_tensor(x[:, 0].real), 2.0, 2.0 * ratio)
    np.testing.assert_allclose(to_np(real), np.asarray(
        clock_sampling_interp(x[:, 0].real, 2.0, 2.0 * ratio)), rtol=0, atol=CSI_ATOL)


def test_clock_sampling_interp_jitter():
    """Jitter comes from the explicit generator; without one it raises, as
    the JAX package does without a key. The jittered output is the
    interpolation at the jittered times."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor((rng.normal(size=(500, 2)) + 1j * rng.normal(size=(500, 2)))
                        .astype(np.complex64))
    with pytest.raises(ValueError, match="generator"):
        tsig.clock_sampling_interp(x, 1.0, 1.001, jitter_rms=0.1)
    y = tsig.clock_sampling_interp(x, 1.0, 1.001, jitter_rms=0.1,
                                   generator=torch.Generator().manual_seed(3))
    draw = torch.randn(y.shape[0], generator=torch.Generator().manual_seed(3))
    t_out = (torch.arange(y.shape[0], dtype=torch.float32) * torch.tensor(1 / 1.001)
             + torch.tensor(0.1) * draw).numpy()
    t_in = np.arange(500, dtype=np.float32)
    ref = np.stack([np.interp(t_out, t_in, x[:, m].real.numpy())
                    + 1j * np.interp(t_out, t_in, x[:, m].imag.numpy()) for m in range(2)], 1)
    np.testing.assert_allclose(to_np(y), ref, rtol=0, atol=1e-5)
    y2 = tsig.clock_sampling_interp(x, 1.0, 1.001, jitter_rms=0.1,
                                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(y, y2)


# -- the Gardner loop --------------------------------------------------------

def _gardner_inputs(case):
    """The inputs of tests/test_carrier_clock.py:130-195."""
    if case == "classic_1mode":  # :130-146, a 300-ppm offset
        x = _qpsk_wave(np.random.default_rng(7), 5000)
        return (np.asarray(clock_sampling_interp(x, 1.0, 1.0 / (1 + 300e-6))),
                jcr.ClockRecoveryConfig(kp=2e-3, ki=1e-5, isNyquist=False))
    if case == "nyquist_2modes_odd":  # :177-195, -150 ppm, odd length
        rng = np.random.default_rng(8)
        x = jnp.stack([_qpsk_wave(rng, 3001) for _ in range(2)], axis=1)
        return (np.asarray(clock_sampling_interp(x, 1.0, 1.0 / (1 - 150e-6))),
                jcr.ClockRecoveryConfig())
    x = _qpsk_wave(np.random.default_rng(8), 4000)  # :149-174, 200 ppm
    return (np.asarray(clock_sampling_interp(x, 1.0, 1.0 / (1 + 200e-6))),
            jcr.ClockRecoveryConfig(kp=2e-3, ki=1e-5, isNyquist=False))


@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("case", ["classic_1mode", "nyquist_2modes_odd", "static_out"])
def test_gardner_matches_jax(case, backend):
    sig, cfg = _gardner_inputs(case)
    static = case == "static_out"
    rec_j, tv_j = jcr.gardner_clock_recovery(sig, cfg, return_timing=True, static_out=static)
    rec_t, tv_t = tcr.gardner_clock_recovery(torch.as_tensor(sig), config_from_jax(cfg),
                                             return_timing=True, backend=backend,
                                             static_out=static)
    assert rec_t.shape == rec_j.shape and tv_t.shape == tv_j.shape
    assert rec_t.dtype == torch.complex64 and tv_t.dtype == torch.float32
    np.testing.assert_allclose(to_np(rec_t), np.asarray(rec_j), rtol=0, atol=CR_ATOL)
    np.testing.assert_allclose(to_np(tv_t), np.asarray(tv_j), rtol=0, atol=CR_ATOL)
    if static:
        assert rec_t.shape[0] == int((1 - cfg.maxPPM / 1e6) * (sig.shape[0] + cfg.lpad))
        dyn = tcr.gardner_clock_recovery(torch.as_tensor(sig), config_from_jax(cfg),
                                         backend=backend)
        nl = min(dyn.shape[0], rec_t.shape[0])
        assert torch.equal(dyn[:nl], rec_t[:nl])  # the static output's prefix
    # the drift estimate of the same timing, as the JAX package computes it
    np.testing.assert_allclose(tcr.calc_clock_drift(tv_t), jcr.calc_clock_drift(tv_j),
                               rtol=1e-6)


def test_gardner_scan_and_kernel_plain_are_one_rule():
    """On the CPU both backends run the same loop: bit-identical records."""
    sig, cfg = _gardner_inputs("nyquist_2modes_odd")
    x = torch.as_tensor(sig[:2000])
    a = gardner.gardner_plain(x, cfg.kp, cfg.ki, True, 1990)
    b = gardner.gardner_records(x, cfg.kp, cfg.ki, True, 1990)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert a[2].shape == (2,) and int(a[2].max()) <= 1990


def _backstep_then_stuff():
    """A short input on which, at a high loop gain, the NCO stuffs a sample
    two iterations after a backstep: the case where the TPU kernel's
    ring-slot zeroing and the while_loop's buffer part ways."""
    rng = np.random.default_rng(34)
    x = (rng.normal(size=(400, 1)) + 1j * rng.normal(size=(400, 1))).astype(np.complex64)
    return x, jcr.ClockRecoveryConfig(kp=0.2, ki=0.0, isNyquist=False)


def test_gardner_stuff_keeps_the_value_written_before_a_backstep():
    """The reference's buffer semantics: an index the NCO stuffs over keeps
    zero, or the value written there before a backstep. The port follows
    the while_loop on an input that reaches that case, where the JAX
    package's TPU kernel (ring slot zeroed) does not."""
    from opticommpy_tpu.kernels.gardner_pallas import gardner_pallas

    x, cfg = _backstep_then_stuff()
    rec_j, tv_j = jcr.gardner_clock_recovery(x, cfg, return_timing=True)
    rec_t, tv_t = tcr.gardner_clock_recovery(torch.as_tensor(x), config_from_jax(cfg),
                                             return_timing=True, backend="pallas")
    assert rec_t.shape == rec_j.shape
    np.testing.assert_allclose(to_np(rec_t), np.asarray(rec_j), rtol=0, atol=CR_ATOL)
    np.testing.assert_allclose(to_np(tv_t), np.asarray(tv_j), rtol=0, atol=CR_ATOL)
    rec_ring = np.asarray(gardner_pallas(x, cfg, interpret=True))
    nl = min(rec_ring.shape[0], rec_j.shape[0])
    assert np.abs(rec_ring[:nl] - np.asarray(rec_j)[:nl]).max() > CR_ATOL


def test_ted_and_interpolator_match_jax():
    rng = np.random.default_rng(10)
    seg = (rng.normal(size=(4, 7)) + 1j * rng.normal(size=(4, 7))).astype(np.complex64)
    t = rng.uniform(-1, 1, size=7).astype(np.float32)
    st, tt = torch.as_tensor(seg), torch.as_tensor(t)
    np.testing.assert_allclose(to_np(tcr.gardner_ted(st[:3])), np.asarray(jcr.gardner_ted(seg[:3])),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(tcr.gardner_ted_nyquist(st[:3])),
                               np.asarray(jcr.gardner_ted_nyquist(seg[:3])), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(tcr.interpolator(st, tt)),
                               np.asarray(jcr.interpolator(seg, t)), rtol=1e-6, atol=1e-6)


# -- feedforward retiming ----------------------------------------------------

def _ffw_signal(rng, n_sym, rolloff, sps=2, noise=0.05):
    """tests/test_carrier_clock.py:238-248 (any sps)."""
    from opticommpy_tpu.comm.modulation import gray_mapping

    const = gray_mapping(16, "qam")
    const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)
    sym = const[rng.integers(0, 16, size=(n_sym, 2))]
    pulse = jnp.asarray(pulse_shape("rrc", sps, 1025, rolloff).astype(np.float32))
    x = pnorm(fir_filter(pulse, upsample(jnp.asarray(sym), sps)))
    return x + (noise * (rng.standard_normal(x.shape)
                         + 1j * rng.standard_normal(x.shape))).astype(np.complex64)


@pytest.mark.parametrize("rolloff,ppm,fit,sps", [
    (0.01, 200.0, "linear", 2), (0.2, -120.0, "linear", 2), (0.1, 80.0, "pwl", 2),
    (0.1, 150.0, "linear", 4)], ids=["r0.01", "r0.2", "pwl", "sps4"])
def test_ffw_matches_jax(rolloff, ppm, fit, sps):
    rng = np.random.default_rng(11)
    x = _ffw_signal(rng, 2**13, rolloff, sps)
    x_off = np.asarray(clock_sampling_interp(x, float(sps), sps * (1 + ppm * 1e-6)))
    jcfg = jcr.FFWClockRecoveryConfig(blockLen=1024, rollOff=rolloff, fit=fit, sps=sps)
    y_j, (ppm_j, tau_j) = jcr.ffw_clock_recovery(x_off, jcfg, return_est=True)
    y_t, (ppm_t, tau_t) = tcr.ffw_clock_recovery(torch.as_tensor(x_off), config_from_jax(jcfg),
                                                 return_est=True)
    assert y_t.shape == y_j.shape and tau_t.shape == tau_j.shape
    assert abs(float(ppm_t) - float(ppm_j)) < PPM_ATOL, (float(ppm_t), float(ppm_j))
    assert abs(float(ppm_t) - ppm) < 10.0
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=FFW_ATOL)


def test_ffw_resampler_is_the_cubic_at_every_output():
    """``y[i] = x(i + off[i])`` by the Lagrange cubic at every output, at a
    length (6,000 in, 5,997 out) where the JAX package's block form pads its
    last 2048-output block past the end of its padded input: its
    dynamic_slice then clamps the window's start and that block reads
    shifted samples. The port's gather agrees with the JAX package on every
    earlier output and with the direct formula on all of them."""
    rng = np.random.default_rng(12)
    n_in, n_out = 6000, 5997
    x = (rng.standard_normal((n_in, 2)) + 1j * rng.standard_normal((n_in, 2))).astype(np.complex64)
    off = (np.arange(n_out, dtype=np.float32) * np.float32(150e-6) - np.float32(0.3))
    y_t = to_np(tcr._resample_cubic(torch.as_tensor(x), torch.as_tensor(off)))
    y_j = np.asarray(jcr._resample_cubic_blocks(jnp.asarray(x), jnp.asarray(off)))
    o = off.astype(np.float64)
    base = np.clip(np.arange(n_out) + np.floor(o).astype(int), 1, n_in - 3)
    f = (o - np.floor(o))[:, None]
    c = (-f * (f - 1) * (f - 2) / 6, (f + 1) * (f - 1) * (f - 2) / 2,
         -f * (f + 1) * (f - 2) / 2, f * (f + 1) * (f - 1) / 6)
    direct = sum(c[tap] * x[base - 1 + tap] for tap in range(4))
    np.testing.assert_allclose(y_t, direct, rtol=0, atol=CSI_ATOL * 10)
    last = (n_out - 1) // 2048 * 2048
    np.testing.assert_allclose(y_t[:last], y_j[:last], rtol=0, atol=FFW_ATOL)


def test_ffw_rejects_short_input_and_unknown_fit():
    x = torch.zeros((100, 2), dtype=torch.complex64)
    with pytest.raises(ValueError, match="samples"):
        tcr.ffw_clock_recovery(x, tcr.FFWClockRecoveryConfig(blockLen=64))
    with pytest.raises(ValueError, match="fit"):
        tcr.ffw_clock_recovery(x, tcr.FFWClockRecoveryConfig(blockLen=32, fit="spline"))


# -- runCR in both chains (tests/test_pipelines.py:93-212) -------------------

@pytest.fixture(scope="module")
def offset_link():
    """(clean received waveform, fs, signal 200 ppm fast with jitter, its
    reference trimmed to what clock recovery keeps), NumPy."""
    k_tx, k_ch, k_lo, k_rx, k_j = jax.random.split(jax.random.PRNGKey(35), 5)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=2**15, nChannels=1, nPolModes=2,
                         nFilterTaps=512, pulseRollOff=0.01, powerPerChannel=(0.0,),
                         laserLinewidth=50e3)
    fs = cfg_tx.Fs
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    cfg_ch = SSFMConfig(Ltotal=50, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fs=fs, amp="edfa",
                        nlprMethod=False, hz=1.0)
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    lo = basic_laser_model(LaserConfig(P=10.0, lw=50e3, Ns=sig_ch.shape[0], Fs=fs,
                                       freqShift=50e6, RIN_var=0.0), k_lo)
    sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), key=k_rx)
    pulse = jnp.asarray(pulse_shape("rrc", cfg_tx.SpS, 512, 0.01))
    pre = edc(decimate(fir_filter(pulse, sig_rx), cfg_tx.SpS, 2),
              EDCConfig(L=50, D=16, Fs=2 * 32e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(pre, symb_tx[:, :, 0], 2))
    sig_off = clock_sampling_interp(sig_rx, fs, fs * (1 + 200e-6), jitter_rms=1e-3 / fs,
                                    key=k_j)
    n_sym_cr = (sig_off.shape[0] // 4 * 999) // 1000 // 2 * 2
    return (np.asarray(sig_rx), fs, np.asarray(sig_off),
            np.asarray(d_ref[:min(8000, n_sym_cr)]))


def _assert_chain_close(y_t, y_j, ref):
    d = np.abs(to_np(y_t) - y_j)
    assert np.mean(d > CHAIN_Y_ATOL) <= MAX_FLIPPED, np.mean(d > CHAIN_Y_ATOL)
    assert d.max() < 0.05, d.max()
    disc = 5000
    ber_j, _, _ = jmetrics.fast_ber_calc(y_j[disc:-100], ref[disc:-100], 16, "qam")
    ber_t, _, _ = tmetrics.fast_ber_calc(y_t[disc:-100], torch.as_tensor(ref[disc:-100]),
                                         16, "qam")
    assert np.all(np.asarray(ber_j) < 1e-2)
    assert np.all(to_np(ber_t) <= 2 * np.asarray(ber_j) + 1e-4), (to_np(ber_t), ber_j)


@pytest.mark.parametrize("kw", [
    dict(crMethod="gardner", crBackend="scan", crNyquist=True, crKp=2e-3, crKi=1e-5),
    dict(crMethod="ffw")], ids=["gardner_scan", "ffw"])
def test_chain_clock_recovery_matches_jax(offset_link, kw):
    _, _, sig_off, d_cr = offset_link
    cfg = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=4000, runCR=True, **kw)
    y_j, _ = coherent_dsp_chain(sig_off, d_cr, cfg)
    y_t, ph_t = tpipe.coherent_dsp_chain(torch.as_tensor(sig_off), torch.as_tensor(d_cr),
                                         config_from_jax(cfg))
    assert y_t.shape == d_cr.shape and ph_t.shape == y_t.shape
    _assert_chain_close(y_t, np.asarray(y_j), d_cr)


def test_chain_batch_ffw_matches_jax(offset_link):
    """Two signals at different clock offsets (+200 / -150 ppm) through one
    batch chain, each with its own feedforward estimate."""
    sig_rx, fs, sig_off, d_cr = offset_link
    sig_off2 = np.asarray(clock_sampling_interp(sig_rx, fs, fs * (1 - 150e-6),
                                                jitter_rms=1e-3 / fs,
                                                key=jax.random.PRNGKey(77)))
    n = min(sig_off.shape[0], sig_off2.shape[0])
    sig_b = np.stack([sig_off[:n], sig_off2[:n]])
    d_b = np.stack([d_cr, d_cr])
    cfg = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=4000, runCR=True,
                            crMethod="ffw")
    y_j, _ = coherent_dsp_chain_batch(sig_b, d_b, cfg)
    y_t, ph_t = tpipe.coherent_dsp_chain_batch(torch.as_tensor(sig_b), torch.as_tensor(d_b),
                                               config_from_jax(cfg))
    assert y_t.shape == d_b.shape and ph_t.shape == (d_b.shape[1], 4)
    for b in range(2):
        _assert_chain_close(y_t[b], np.asarray(y_j)[b], d_cr)


def test_chain_rejects_a_reference_longer_than_retained(offset_link):
    _, _, sig_off, d_cr = offset_link
    cfg = tpipe.CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=4000, runCR=True,
                                  crMethod="ffw")
    n_dsp = -(-sig_off.shape[0] // 4)
    long_ref = np.concatenate([d_cr, d_cr])[: n_dsp // 2]
    with pytest.raises(ValueError, match="trim the reference"):
        tpipe.coherent_dsp_chain(torch.as_tensor(sig_off), torch.as_tensor(long_ref), cfg)
    with pytest.raises(ValueError, match="trim the reference"):
        tpipe.coherent_dsp_chain_batch(torch.as_tensor(sig_off[None]),
                                       torch.as_tensor(long_ref[None]), cfg)


def test_run_cr_pallas_reaches_k6_once(offset_link):
    """runCR with crBackend='pallas' calls the K6 entry once for both modes
    (on the CPU it runs the plain version), and 'scan' never calls it."""
    _, _, sig_off, d_cr = offset_link
    n = 2600
    sig, ref = torch.as_tensor(sig_off[: 8 * n]), torch.as_tensor(d_cr[: n - 30])
    for backend, calls in (("pallas", 1), ("scan", 0)):
        cfg = tpipe.CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=1000,
                                      runCR=True, crBackend=backend, crNyquist=True,
                                      crKp=2e-3, crKi=1e-5)
        with mock.patch.object(gardner, "gardner_records",
                               wraps=gardner.gardner_records) as k6:
            y, _ = tpipe.coherent_dsp_chain(sig, ref, cfg)
        assert k6.call_count == calls, backend
        if calls:
            assert k6.call_args.args[0].shape[1] == 2  # both modes in one call
        assert y.shape == ref.shape and torch.isfinite(y).all()


# -- the kernel on the card --------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("nyquist", [False, True])
def test_gardner_kernel_matches_plain_on_gpu(nyquist):
    dev = require_cuda()
    rng = np.random.default_rng(12)
    x = torch.stack([torch.as_tensor(np.asarray(_qpsk_wave(rng, 4096)))] * 2, dim=1)
    x = tsig.clock_sampling_interp(x.to(dev), 1.0, 1.0 / (1 + 250e-6))
    n_out = int((1 - 5e-4) * x.shape[0])
    before = gardner.launches
    eo_k, tv_k, n_k = gardner.gardner_records(x, 2e-3, 1e-5, nyquist, n_out)
    assert gardner.launches == before + 1
    eo_p, tv_p, n_p = gardner.gardner_plain(x, 2e-3, 1e-5, nyquist, n_out)
    torch.cuda.synchronize()
    assert torch.equal(n_k.cpu(), n_p.cpu())
    assert float((eo_k - eo_p).abs().max()) < CR_ATOL
    assert float((tv_k - tv_p).abs().max()) < CR_ATOL


@pytest.mark.gpu
def test_gardner_kernel_backstep_then_stuff_on_gpu():
    """The kernel's register cache and output-buffer reads give the
    while_loop's semantics where a stuff follows a backstep."""
    dev = require_cuda()
    x, cfg = _backstep_then_stuff()
    x = torch.as_tensor(np.concatenate([x, np.zeros((1, 1), np.complex64)]), device=dev)
    n_out = int((1 - cfg.maxPPM / 1e6) * x.shape[0])
    eo_k, tv_k, n_k = gardner.gardner_records(x, cfg.kp, cfg.ki, False, n_out)
    eo_p, tv_p, n_p = gardner.gardner_plain(x, cfg.kp, cfg.ki, False, n_out)
    torch.cuda.synchronize()
    assert torch.equal(n_k.cpu(), n_p.cpu())
    assert torch.equal(eo_k, eo_p) and torch.equal(tv_k, tv_p)


# csrc/gardner.cu stages its input 1024 samples at a time (kChunk)
GARDNER_CHUNK = 1024


def _k6_equals_plain(x, kp, ki, nyquist, n_out):
    """K6 against its plain version on the same CUDA tensor: equal outputs
    (NaN where the plain version has NaN) and equal final pointers."""
    before = gardner.launches
    out_k = gardner.gardner_records(x, kp, ki, nyquist, n_out)
    assert gardner.launches == before + 1
    out_p = gardner.gardner_plain(x, kp, ki, nyquist, n_out)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    return out_k


def _noise_columns(seeds, n_in):
    """(n_in, len(seeds)) complex64 Gaussian noise, one seed per mode."""
    cols = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        cols.append(rng.normal(size=n_in) + 1j * rng.normal(size=n_in))
    return np.stack(cols, axis=1).astype(np.complex64)


@pytest.mark.gpu
@pytest.mark.parametrize("n_in, modes, nyquist", [
    (5, 1, False), (GARDNER_CHUNK - 1, 2, True), (GARDNER_CHUNK, 2, False),
    (GARDNER_CHUNK + 1, 4, True), (2 * GARDNER_CHUNK + 1, 1, False),
    (3 * GARDNER_CHUNK + 3, 2, True)])
def test_gardner_kernel_chunk_edges_on_gpu(n_in, modes, nyquist):
    """Inputs that end before, on and after a staged chunk, 1-4 modes, both
    TEDs, at 250 ppm."""
    dev = require_cuda()
    rng = np.random.default_rng(40 + n_in)
    waves = [np.asarray(_qpsk_wave(rng, n_in // 2 + 8))[:n_in] for _ in range(modes)]
    x = torch.as_tensor(np.stack(waves, axis=1).astype(np.complex64), device=dev)
    x = tsig.clock_sampling_interp(x, 1.0, 1.0 / (1 + 250e-6))[:n_in].contiguous()
    n_out = max(3, int((1 - 5e-4) * n_in))
    _, _, n_k = _k6_equals_plain(x, 2e-3, 1e-5, nyquist, n_out)
    assert n_k.shape == (modes,)


@pytest.mark.gpu
def test_gardner_kernel_skip_and_stuff_across_a_ring_slot_on_gpu():
    """At a high loop gain on noise the NCO skips and stuffs often. On these
    four columns (seeds found with the plain loop) a skip (seeds 5, 15) and
    a stuff (seeds 30, 9) fall where the sample entering the window, x[m+2],
    is the first or last of a staged chunk (m + 2 = 1024, 1023; 3072, 3071)."""
    dev = require_cuda()
    x = torch.as_tensor(_noise_columns((5, 30, 15, 9), 3100), device=dev)
    eo, tv, n_k = _k6_equals_plain(x, 0.2, 0.0, False, 3099)
    assert torch.isfinite(eo).all() and torch.isfinite(tv).all()


@pytest.mark.gpu
@pytest.mark.parametrize("nyquist", [False, True])
def test_gardner_kernel_non_finite_input_stops_at_max_iters_on_gpu(nyquist):
    """A non-finite input, with the iteration cap lowered to 1500 for both
    versions so that it falls inside the second staged chunk: both stop at
    the cap, short of the end of the input, with equal records."""
    dev = require_cuda()
    x = _noise_columns((50, 51), 3000) * 0.3
    x[600, 0] = np.inf
    x[900, 1] = np.nan
    x = torch.as_tensor(x, device=dev)
    with mock.patch.object(gardner, "max_iters", return_value=1500):
        _, _, n_k = _k6_equals_plain(x, 2e-3, 1e-5, nyquist, 2990)
    assert int(n_k.max()) < 2989
