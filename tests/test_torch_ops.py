"""opticommpy_torch ops, EDC, FOE, unwrap and metrics against opticommpy_tpu.

Tolerances: relative error <= 1e-5 for the FFT-based ops (float32 FFT
rounding differs between the two FFT libraries), exact agreement for
integer decisions (sampling phase, delays, argmax bins).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import metrics as jmetrics  # noqa: E402
from opticommpy_tpu.dsp import carrier_recovery as jcr  # noqa: E402
from opticommpy_tpu.dsp import equalization as jeq  # noqa: E402
from opticommpy_tpu.ops import filtering as jfilt  # noqa: E402
from opticommpy_tpu.ops import signal as jsig  # noqa: E402
from opticommpy_torch.comm import metrics as tmetrics  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.dsp import carrier_recovery as tcr  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.ops import filtering as tfilt  # noqa: E402
from opticommpy_torch.ops import noise as tnoise  # noqa: E402
from opticommpy_torch.ops import signal as tsig  # noqa: E402
from opticommpy_torch.utils import scan  # noqa: E402

from _torch_parity import noisy_symbols, norm_qam, rel_err, require_cuda, to_np  # noqa: E402

FFT_TOL = 1e-5


def _shaped_polmux(seed, n_sym=2048, sps=8):
    rng = np.random.default_rng(seed)
    const = norm_qam(16)
    sym = const[rng.integers(0, 16, size=(n_sym, 2))]
    up = np.zeros((n_sym * sps, 2), np.complex64)
    up[::sps] = sym
    pulse = jfilt.pulse_shape("rrc", sps, 256, 0.1).astype(np.float32)
    sig = np.asarray(jfilt.fir_filter(pulse, up))
    noise = 0.01 * (rng.normal(size=sig.shape) + 1j * rng.normal(size=sig.shape))
    return (sig + noise).astype(np.complex64), sym


@pytest.mark.parametrize("kind", ["complex", "real", "1d"])
def test_fir_filter(kind):
    sig, _ = _shaped_polmux(0)
    x = {"complex": sig, "real": sig.real.copy(), "1d": sig[:, 0].copy()}[kind]
    h = jfilt.pulse_shape("rrc", 8, 301, 0.2).astype(np.float32)
    ref = np.asarray(jfilt.fir_filter(h, x))
    out = tfilt.fir_filter(h, torch.as_tensor(x))
    assert to_np(out).dtype == ref.dtype and out.shape == ref.shape
    assert rel_err(out, ref) <= FFT_TOL


def test_overlap_save():
    sig, _ = _shaped_polmux(1)
    h = jfilt.pulse_shape("rrc", 8, 127, 0.2).astype(np.float32)
    ref = np.asarray(jfilt.overlap_save(sig, h, nfft=1024))
    out = tfilt.overlap_save(torch.as_tensor(sig), h, nfft=1024)
    assert rel_err(out, ref) <= FFT_TOL


def test_pnorm_upsample_decimate():
    sig, _ = _shaped_polmux(2)
    # a per-mode delay so the max-variance phase pick differs between modes
    sig[:, 1] = np.roll(sig[:, 1], 3)
    x = torch.as_tensor(sig)
    assert rel_err(tsig.pnorm(x), jsig.pnorm(sig)) <= 1e-6
    assert rel_err(tsig.upsample(x, 3), jsig.upsample(sig, 3)) == 0.0
    for sps_out in (1, 2):
        ref = np.asarray(jsig.decimate(sig, 8, sps_out))
        assert rel_err(tsig.decimate(x, 8, sps_out), ref) == 0.0


def test_symbol_sync_and_finddelay():
    rng = np.random.default_rng(3)
    sig, sym = _shaped_polmux(3)
    rx = np.roll(sig, 40, axis=0)[:, ::-1].copy()  # delayed, modes swapped
    ref = np.asarray(jsig.symbol_sync(rx, sym, 8))
    out = tsig.symbol_sync(torch.as_tensor(rx), torch.as_tensor(sym), 8)
    np.testing.assert_array_equal(to_np(out), ref)
    a = rng.normal(size=500).astype(np.float32)
    b = np.roll(a, 17)
    assert int(tsig.finddelay(torch.as_tensor(a), torch.as_tensor(b))) == int(
        jsig.finddelay(a, b))


def test_edc():
    sig, _ = _shaped_polmux(4, n_sym=4096, sps=2)
    for jcfg in (jeq.EDCConfig(L=200, D=16, Fs=64e9, Rs=32e9),
                 jeq.EDCConfig(L=80, D=17, Fs=64e9, Rs=32e9, Nfft=2048)):
        ref = np.asarray(jeq.edc(sig, jcfg))
        out = teq.edc(torch.as_tensor(sig), config_from_jax(jcfg))
        assert rel_err(out, ref) <= FFT_TOL


def test_fourth_power_foe():
    sig, _ = _shaped_polmux(5, n_sym=4096, sps=2)
    t = np.arange(sig.shape[0])[:, None] / 64e9
    x = (sig * np.exp(2j * np.pi * 1.3e8 * t)).astype(np.complex64)
    ref, fo_ref = jcr.fourth_power_foe(x, 64e9, 4)
    out, fo = tcr.fourth_power_foe(torch.as_tensor(x), 64e9, 4)
    np.testing.assert_array_equal(to_np(fo), np.asarray(fo_ref))
    assert rel_err(out, ref) <= FFT_TOL


def test_unwrap_matches_jnp():
    rng = np.random.default_rng(6)
    p = np.cumsum(rng.normal(scale=1.5, size=(3000, 3)), axis=0)
    wrapped = (np.angle(np.exp(1j * p))).astype(np.float32)
    wrapped[10, 0] = np.pi  # an exact half-period step
    ref = np.asarray(jnp.unwrap(4 * wrapped, axis=0) / 4)
    out = tcr.unwrap(4 * torch.as_tensor(wrapped), dim=0) / 4
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=1e-4)


def test_unwrap_long_1d_matches_jnp():
    """A 1-D phase record longer than one scan block (the blocked cumsum)."""
    rng = np.random.default_rng(9)
    p = np.cumsum(rng.normal(scale=1.5, size=5000))
    wrapped = np.angle(np.exp(1j * p)).astype(np.float32)
    ref = np.asarray(jnp.unwrap(wrapped))
    out = tcr.unwrap(torch.as_tensor(wrapped), dim=0)
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape,dim", [((5,), 0), ((1024,), 0), ((1025,), 0),
                                       ((70001,), 0), ((3000, 1), 0), ((1, 3000), 1),
                                       ((3000, 3), 0)])
def test_scan_cumsum_matches_cumsum(shape, dim):
    """The run-independent cumsum sums in blocks; it agrees with a float64
    cumulative sum to float32 rounding (relative 1e-6 of the largest sum)."""
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    ref = np.cumsum(x.astype(np.float64), axis=dim)
    out = scan.cumsum(torch.as_tensor(x), dim)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max() + 1e-6)


@pytest.mark.gpu
def test_phase_noise_is_reproducible_on_gpu():
    """One seed, one walk: torch.cumsum of a whole CUDA tensor is not
    run-to-run reproducible, the phase noise's scan is."""
    dev = require_cuda()
    walks = [tnoise.phase_noise(torch.Generator(device=dev).manual_seed(0), 100e3, 2**20,
                                1 / 512e9) for _ in range(4)]
    assert all(torch.equal(walks[0], w) for w in walks[1:])


def test_gaussian_complex_noise_variance():
    gen = torch.Generator().manual_seed(0)
    for var in (1.0, 3e-3):
        n = tnoise.gaussian_complex_noise(gen, (2**16,), var)
        assert n.dtype == torch.complex64
        assert abs(float(torch.mean(torch.abs(n) ** 2)) / var - 1) < 0.05
        assert abs(float(torch.var(n.real)) / (var / 2) - 1) < 0.05


def test_phase_noise_increment_variance():
    gen = torch.Generator().manual_seed(1)
    lw, ts = 100e3, 1 / 64e9
    phi = tnoise.phase_noise(gen, lw, 2**16, ts)
    assert phi.dtype == torch.float32 and float(phi[0]) == 0.0
    var = float(torch.var(torch.diff(phi)))
    assert abs(var / (2 * np.pi * lw * ts) - 1) < 0.05


def test_metrics_match_jax():
    const = norm_qam(16)
    tx = noisy_symbols(7, 4000, 2, const, snr_db=60.0, lw_ts=0.0)
    rx = noisy_symbols(7, 4000, 2, const, snr_db=14.0, lw_ts=0.0) * np.exp(1j * 0.1)
    rx = rx.astype(np.complex64)
    ber_j, ser_j, snr_j = jmetrics.fast_ber_calc(rx, tx, 16, "qam")
    ber_t, ser_t, snr_t = tmetrics.fast_ber_calc(torch.as_tensor(rx), torch.as_tensor(tx),
                                                 16, "qam")
    # same error counts; the means differ only in float32 summation order
    np.testing.assert_allclose(to_np(ber_t), np.asarray(ber_j), rtol=1e-6)
    np.testing.assert_allclose(to_np(ser_t), np.asarray(ser_j), rtol=1e-6)
    np.testing.assert_allclose(to_np(snr_t), np.asarray(snr_j), rtol=1e-5)
    gmi_j, ngmi_j = jmetrics.monte_carlo_gmi(rx, tx, 16, "qam")
    gmi_t, ngmi_t = tmetrics.monte_carlo_gmi(torch.as_tensor(rx), torch.as_tensor(tx),
                                             16, "qam")
    np.testing.assert_allclose(to_np(gmi_t), np.asarray(gmi_j), rtol=1e-4)
    np.testing.assert_allclose(to_np(ngmi_t), np.asarray(ngmi_j), rtol=1e-4)
    for ref_tx in (tx, None):
        evm_j = jmetrics.calc_evm(rx, 16, "qam", symb_tx=ref_tx)
        evm_t = tmetrics.calc_evm(torch.as_tensor(rx), 16, "qam",
                                  symb_tx=None if ref_tx is None else torch.as_tensor(ref_tx))
        np.testing.assert_allclose(to_np(evm_t), np.asarray(evm_j), rtol=1e-4)
