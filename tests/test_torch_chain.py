"""The slice as a whole: the coherent DSP chain of the port against the JAX
package's, on a received waveform that the JAX package generates.

Link (tests/test_pipelines.py): 1 channel of 16-QAM polmux at SpS 8,
2**15 bits, 2 x 50 km of Manakov fiber with EDFAs, a 50 kHz / 50 MHz-offset
LO and the PDM coherent receiver; AWGN drawn with NumPy brings the
post-DSP SNR to ~13 dB so that the BER is not zero.

Tolerances: the equalized symbols agree to atol 1e-4 (float32 rounding
through FFTs and the equalizer recurrence) on all but 0.1% of the symbols,
where a BPS near-tie between test phases may turn the phase by pi/128; BER
within 2x + 1e-4 of the JAX BER and GMI within 0.02 bit.
"""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import metrics as jmetrics  # noqa: E402
from opticommpy_tpu.dsp import EDCConfig, edc  # noqa: E402
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
from opticommpy_tpu.pipelines import CoherentDSPConfig, coherent_dsp_chain  # noqa: E402
from opticommpy_torch import pipelines as tpipe  # noqa: E402
from opticommpy_torch.comm import metrics as tmetrics  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.kernels import bps as tbps  # noqa: E402
from opticommpy_torch.kernels import mimo_eq as tmimo  # noqa: E402

from _torch_parity import to_np  # noqa: E402

Y_ATOL = 1e-4
MAX_FLIPPED = 1e-3  # share of symbols a BPS near-tie may move beyond Y_ATOL
N_TRAIN = 6000
DISC = N_TRAIN + 1000


@pytest.fixture(scope="module")
def link():
    """(received waveform (N, 2), synchronized reference (nSym, 2)), NumPy."""
    k_tx, k_ch, k_lo, k_rx = jax.random.split(jax.random.PRNGKey(34), 4)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=2**15, nChannels=1,
                         nPolModes=2, nFilterTaps=512, pulseRollOff=0.01,
                         powerPerChannel=(0.0,), laserLinewidth=50e3)
    fs = cfg_tx.Fs
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    cfg_ch = SSFMConfig(Ltotal=100, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fs=fs,
                        amp="edfa", nlprMethod=True)
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    lo = basic_laser_model(LaserConfig(P=10.0, lw=50e3, Ns=sig_ch.shape[0], Fs=fs,
                                       freqShift=50e6, RIN_var=0.0), k_lo)
    sig_rx = np.array(pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs),
                                            key=k_rx))
    rng = np.random.default_rng(34)
    sigma = np.sqrt(np.mean(np.abs(sig_rx) ** 2) * 10 ** -0.8 / 2)
    sig_rx = (sig_rx + sigma * (rng.normal(size=sig_rx.shape)
                                + 1j * rng.normal(size=sig_rx.shape))).astype(np.complex64)
    pulse = pulse_shape("rrc", cfg_tx.SpS, 512, 0.01)
    pre = decimate(fir_filter(pulse, sig_rx), cfg_tx.SpS, 2)
    pre = edc(pre, EDCConfig(L=100, D=16, Fs=2 * 32e9, Rs=32e9))
    d_ref = np.array(pnorm(symbol_sync(pre, symb_tx[:, :, 0], 2)))
    return sig_rx, d_ref


def _run_both(link, **kw):
    sig_rx, d_ref = link
    cfg = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=100, nTrain=N_TRAIN,
                            mu=(2e-3, 1e-3), **kw)
    y_j, _ = coherent_dsp_chain(sig_rx, d_ref, cfg)
    y_t, ph_t = tpipe.coherent_dsp_chain(torch.as_tensor(sig_rx),
                                         torch.as_tensor(d_ref), config_from_jax(cfg))
    assert y_t.shape == (d_ref.shape[0], 2) and ph_t.shape == y_t.shape
    assert torch.isfinite(y_t).all()
    return np.asarray(y_j), y_t


def _assert_symbols_close(y_t, y_j):
    d = np.abs(to_np(y_t) - y_j)
    assert np.mean(d > Y_ATOL) <= MAX_FLIPPED, np.mean(d > Y_ATOL)
    assert d.max() < 0.05, d.max()  # no cycle slip: a near-tie turns by pi/128


def test_chain_kernel_backends_match_jax(link):
    _, d_ref = link
    counts = (tbps.launches, tmimo.launches)
    y_j, y_t = _run_both(link, eqBackend="pallas", cprBackend="pallas")
    # CPU tensors take the kernels' plain versions: no launch
    assert (tbps.launches, tmimo.launches) == counts
    _assert_symbols_close(y_t, y_j)

    ref = d_ref[DISC:-100]
    ber_j, _, _ = jmetrics.fast_ber_calc(y_j[DISC:-100], ref, 16, "qam")
    gmi_j, _ = jmetrics.monte_carlo_gmi(y_j[DISC:-100], ref, 16, "qam")
    ber_t, _, _ = tmetrics.fast_ber_calc(y_t[DISC:-100], torch.as_tensor(ref), 16, "qam")
    gmi_t, _ = tmetrics.monte_carlo_gmi(y_t[DISC:-100], torch.as_tensor(ref), 16, "qam")
    ber_j, gmi_j = np.asarray(ber_j), np.asarray(gmi_j)
    assert np.all(ber_j > 0) and np.all(ber_j < 2e-2), ber_j  # a BER worth comparing
    assert np.all(to_np(ber_t) <= 2 * ber_j + 1e-4), (to_np(ber_t), ber_j)
    assert np.all(np.abs(to_np(gmi_t) - gmi_j) <= 0.02), (to_np(gmi_t), gmi_j)
    evm = tmetrics.calc_evm(y_t[DISC:-100], 16, "qam", symb_tx=torch.as_tensor(ref))
    np.testing.assert_allclose(
        to_np(evm), np.asarray(jmetrics.calc_evm(y_j[DISC:-100], 16, "qam", symb_tx=ref)),
        rtol=1e-3)


@pytest.mark.parametrize("backends", [
    dict(eqBackend="scan", cprBackend="xla"),
    dict(eqBackend="pallas-lms", cprBackend="xla"),
], ids=["scan-xla", "pallas_lms-xla"])
def test_chain_other_backends_match_jax(link, backends):
    y_j, y_t = _run_both(link, **backends)
    _assert_symbols_close(y_t, y_j)


def test_chain_clock_recovery_not_ported(link):
    """runCR keeps (1 - crMaxPPM/1e6) of the samples, so a reference of
    every symbol outruns what clock recovery retains: both packages raise
    ValueError and ask for a trimmed reference (tests/test_torch_clock.py
    holds the chain with clock recovery to JAX)."""
    sig_rx, d_ref = link
    for method in ("gardner", "ffw"):
        cfg = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=100, nTrain=N_TRAIN,
                                runCR=True, crMethod=method, crBackend="scan")
        with pytest.raises(ValueError, match="trim the reference"):
            coherent_dsp_chain(sig_rx[: 8 * 4096], d_ref[:4096], cfg)
        with pytest.raises(ValueError, match="trim the reference"):
            tpipe.coherent_dsp_chain(torch.as_tensor(sig_rx[: 8 * 4096]),
                                     torch.as_tensor(d_ref[:4096]), config_from_jax(cfg))


def test_chain_blocked_matches_jax(link):
    """The chain with blockUpdate 16 (the JAX package's blocked main-path
    test, tests/test_pipelines.py:52-58, on this link): the training stages
    take the blocked route in both packages; the same symbol, BER and GMI
    pins as the per-symbol chain."""
    sig_rx, d_ref = link
    cfg = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=100, nTrain=N_TRAIN,
                            mu=(5e-3, 1e-3), blockUpdate=16, eqBackend="pallas",
                            cprBackend="pallas")
    y_j = np.asarray(coherent_dsp_chain(sig_rx, d_ref, cfg)[0])
    counts = (tbps.launches, tmimo.launches, tmimo.batch_launches)
    y_t, _ = tpipe.coherent_dsp_chain(torch.as_tensor(sig_rx), torch.as_tensor(d_ref),
                                      config_from_jax(cfg))
    assert (tbps.launches, tmimo.launches, tmimo.batch_launches) == counts
    _assert_symbols_close(y_t, y_j)
    ref = d_ref[DISC:-100]
    ber_j, _, _ = jmetrics.fast_ber_calc(y_j[DISC:-100], ref, 16, "qam")
    gmi_j, _ = jmetrics.monte_carlo_gmi(y_j[DISC:-100], ref, 16, "qam")
    ber_t, _, _ = tmetrics.fast_ber_calc(y_t[DISC:-100], torch.as_tensor(ref), 16, "qam")
    gmi_t, _ = tmetrics.monte_carlo_gmi(y_t[DISC:-100], torch.as_tensor(ref), 16, "qam")
    ber_j, gmi_j = np.asarray(ber_j), np.asarray(gmi_j)
    assert np.all(ber_j < 2e-2), ber_j
    assert np.all(to_np(ber_t) <= 2 * ber_j + 1e-4), (to_np(ber_t), ber_j)
    assert np.all(np.abs(to_np(gmi_t) - gmi_j) <= 0.02), (to_np(gmi_t), gmi_j)
