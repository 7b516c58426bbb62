"""The serving path of the port against the JAX package: resampling to the
DSP rate, the DD-PLL (its reference rule, which is also K7's plain
version), Viterbi & Viterbi, the frozen-tap equalizer (mimo_apply,
mimo_apply_fused, the static rule) and coherent_dsp_serve.

Tolerances:
- DD-PLL: the port's reference rule within 1e-5 rad of JAX ``ddpll``; K7
  (on the card) and ``ddpll_kernel`` (on the CPU, the reference rule)
  within 2e-4 rad of ``ddpll_pallas`` and of each other (the JAX package's
  pin between its scan and its kernel: the loop coefficients are rounded
  from float64 there and from float32 arithmetic in the scan, and the
  kernel quantizes where the scan takes an argmin); columns packed side by
  side bit-identical to each signal alone. K7's plain twin ``ddpll_plain``
  (the kernel's own rule in torch ops) within 2e-4 rad of ``ddpll_pallas``
  on the CPU (the same pin: its sine and cosine are torch's, the JAX
  interpreter's are XLA's), and K7 equal to it bit for bit on the card.
- Viterbi: 1e-5 rad (the moving average is a cumulative-sum difference in
  both, summed in another order).
- mimo_apply / mimo_apply_fused: relative error 1e-5 against JAX (float32
  FFTs of 2^13-2^14 points in another order); the JAX package's own bounds
  against the staged composition (3e-4, 1e-2 with the Parseval scale).
- coherent_dsp_serve: symbols within 1e-4 of JAX on all but 1% of them (a
  BPS near-tie turns a symbol by a test-phase step), and the JAX package's
  5e-2 relative bound against the staged mimo_apply + BPS composition.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import modulate_gray  # noqa: E402
from opticommpy_tpu.dsp import carrier_recovery as jcr  # noqa: E402
from opticommpy_tpu.dsp import equalization as jeq  # noqa: E402
from opticommpy_tpu.kernels.ddpll_pallas import ddpll_pallas  # noqa: E402
from opticommpy_tpu.ops import pnorm  # noqa: E402
from opticommpy_tpu.ops.filtering import fir_filter, pulse_shape  # noqa: E402
from opticommpy_tpu.ops.signal import moving_average, resample  # noqa: E402
from opticommpy_tpu.pipelines import CoherentDSPConfig, coherent_dsp_serve  # noqa: E402
from opticommpy_torch import pipelines as tpipe  # noqa: E402
from opticommpy_torch.convert import config_from_jax, taps_from_numpy  # noqa: E402
from opticommpy_torch.dsp import carrier_recovery as tcr  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.kernels import bps as tbps  # noqa: E402
from opticommpy_torch.kernels import ddpll as tddpll  # noqa: E402
from opticommpy_torch.ops import filtering as tfilt  # noqa: E402
from opticommpy_torch.ops import signal as tsig  # noqa: E402

from _torch_parity import norm_qam, rel_err, require_cuda, to_np  # noqa: E402

PLL_ATOL, KERNEL_ATOL, VITERBI_ATOL, APPLY_REL = 1e-5, 2e-4, 1e-5, 1e-5
TS, TAU = 1 / 32e9, 1 / (2 * np.pi * 10e6)


def _rotated(seed, n, M, snr_db=25.0, lw_ts=1e-7, modes=1):
    """Gray-mapped QAM with a random-walk phase and AWGN (NumPy draws):
    (received (n, modes), transmitted (n, modes), phase (n, modes))."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=n * modes * int(np.log2(M)))
    tx = np.asarray(pnorm(modulate_gray(jnp.asarray(bits), M, "qam"))).reshape(n, modes)
    phi = np.cumsum(rng.normal(scale=np.sqrt(2 * np.pi * lw_ts), size=(n, modes)), axis=0)
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    noise = sigma * (rng.normal(size=(n, modes)) + 1j * rng.normal(size=(n, modes)))
    return ((tx * np.exp(1j * phi) + noise).astype(np.complex64), tx.astype(np.complex64),
            phi)


def _psk8():
    c = np.exp(2j * np.pi * np.arange(8) / 8)
    return (c / np.sqrt(np.mean(np.abs(c) ** 2))).astype(np.complex64)


# -- DD-PLL ------------------------------------------------------------------

@pytest.mark.parametrize("M,pilots", [(4, False), (16, True)])
def test_ddpll_matches_jax(M, pilots):
    sig, tx, _ = _rotated(20 + M, 1500, M, modes=2)
    const = norm_qam(M)
    kw = dict(symb_tx=tx, pilot_ind=np.arange(0, 1500, 20)) if pilots else {}
    ref = np.asarray(jcr.ddpll(sig, TS, 0.1, TAU, TAU, jnp.asarray(const), **kw))
    out = tcr.ddpll(torch.as_tensor(sig), TS, 0.1, TAU, TAU, torch.as_tensor(const),
                    **{k: torch.as_tensor(v) if k == "symb_tx" else v for k, v in kw.items()})
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=PLL_ATOL)


@pytest.mark.parametrize("kind", ["qam4", "qam16_pilots", "psk8"])
def test_ddpll_kernel_plain_matches_pallas(kind):
    """K7's plain version against ddpll_pallas in interpret mode
    (tests/test_pallas_kernels.py:84-113): the square-QAM quantizer with and
    without pilots, and the argmin slicer on 8-PSK."""
    if kind == "qam4":
        sig, _, _ = _rotated(4, 2000, 4)
        sig = np.concatenate([sig, sig * np.exp(1j * 0.1)], axis=1).astype(np.complex64)
        const, kw = norm_qam(4), {}
    elif kind == "qam16_pilots":
        sig, tx, phi = _rotated(5, 3000, 16)
        const = norm_qam(16)
        kw = dict(symb_tx=(sig * np.exp(-1j * phi)).astype(np.complex64),
                  pilot_ind=np.arange(0, 3000, 20))
    else:
        const = _psk8()
        rng = np.random.default_rng(6)
        sym = const[rng.integers(0, 8, size=(1200, 3))]
        phase = np.cumsum(rng.normal(0, 0.005, size=(1200, 1)), axis=0)
        sig, kw = (sym * np.exp(1j * phase)).astype(np.complex64), {}
    ref = np.asarray(ddpll_pallas(sig, TS, 0.1, TAU, TAU, const, block=256, interpret=True,
                                  **kw))
    out = tddpll.ddpll_kernel(torch.as_tensor(sig), TS, 0.1, TAU, TAU, const, **kw)
    assert out.shape == ref.shape
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=KERNEL_ATOL)
    if kind == "qam16_pilots":
        err = np.angle(np.exp(1j * 4 * (to_np(out)[:, 0] + phi[:, 0]))) / 4
        assert np.std(err[1000:]) < 0.08


def test_ddpll_packed_columns_equal_each_signal():
    """B signals packed as columns give exactly the per-signal phases
    (tests/test_pallas_kernels.py:115-136)."""
    const = norm_qam(4)
    rng = np.random.default_rng(0)
    b, n = 4, 700
    sym = const[rng.integers(0, 4, size=(n, 2 * b))]
    phase = np.cumsum(rng.normal(0, 0.01, size=(n, 1)), axis=0)
    sig = torch.as_tensor((sym * np.exp(1j * phase)).astype(np.complex64))
    args = (1 / 32e9, 0.1, 1 / (2 * np.pi * 1e6), 1e-9, const)
    packed = tddpll.ddpll_kernel(sig, *args)
    assert packed.shape == (n, 2 * b)
    for i in range(b):
        assert torch.equal(packed[:, 2 * i:2 * i + 2],
                           tddpll.ddpll_kernel(sig[:, 2 * i:2 * i + 2], *args))
    ref = np.asarray(ddpll_pallas(to_np(sig), *args, interpret=True))
    np.testing.assert_allclose(to_np(packed), ref, rtol=0, atol=KERNEL_ATOL)


def _twin_case(kind, n=1500, n_cols=3, seed=7):
    """(x, ref, pilot, const) for the twin: 16-QAM with a pilot every 20th
    symbol, or 8-PSK without pilots; NumPy draws."""
    if kind == "qam16_pilots":
        sig, tx, _ = _rotated(seed, n, 16, modes=n_cols)
        const, pilot = norm_qam(16), np.zeros(n, np.float32)
        pilot[::20] = 1.0
    else:
        const = _psk8()
        rng = np.random.default_rng(seed)
        tx = const[rng.integers(0, 8, size=(n, n_cols))]
        phase = np.cumsum(rng.normal(0, 0.005, size=(n, 1)), axis=0)
        sig, pilot = (tx * np.exp(1j * phase)).astype(np.complex64), np.zeros(n, np.float32)
    return sig, tx.astype(np.complex64), pilot, const


@pytest.mark.parametrize("kind", ["qam16_pilots", "psk8"])
def test_ddpll_plain_twin_matches_pallas(kind):
    """K7's plain twin (the kernel's grid quantizer on 16-QAM, the argmin on
    8-PSK) against ddpll_pallas in interpret mode, pilots as the JAX
    kernel's mask."""
    sig, tx, pilot, const = _twin_case(kind)
    kw = dict(symb_tx=tx, pilot_ind=np.flatnonzero(pilot)) if kind == "qam16_pilots" else {}
    ref = np.asarray(ddpll_pallas(sig, TS, 0.1, TAU, TAU, const, block=256, interpret=True,
                                  **kw))
    out = tddpll.ddpll_plain(torch.as_tensor(sig), torch.as_tensor(tx), torch.as_tensor(pilot),
                             const, tddpll.loop_coefs(TS, 0.1, TAU, TAU))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=KERNEL_ATOL)


def test_ddpll_plain_twin_packed_columns_equal_each_signal():
    """The twin's packed columns equal each signal alone, bit for bit."""
    sig, tx, pilot, const = _twin_case("qam16_pilots", n=600, n_cols=6, seed=8)
    args = (const, tddpll.loop_coefs(1 / 32e9, 0.1, 1 / (2 * np.pi * 1e6), 1e-9))
    x, r, p = torch.as_tensor(sig), torch.as_tensor(tx), torch.as_tensor(pilot)
    packed = tddpll.ddpll_plain(x, r, p, *args)
    for i in range(3):
        cols = slice(2 * i, 2 * i + 2)
        assert torch.equal(packed[:, cols], tddpll.ddpll_plain(x[:, cols], r[:, cols], p, *args))


@pytest.mark.parametrize("alg", ["ddpll", "ddpll-pallas", "viterbi"])
def test_cpr_matches_jax(alg):
    """cpr with each PLL / Viterbi branch; the JAX package's 'ddpll-pallas'
    calls its kernel without interpret mode, so the port's 'ddpll-pallas'
    is held to JAX 'ddpll', as its scan pins its kernel."""
    sig, tx, _ = _rotated(30, 2000, 16, lw_ts=1e-6, modes=2)
    t = np.arange(2000)[:, None] / 32e9
    sig = (sig * np.exp(2j * np.pi * 1e8 * t)).astype(np.complex64)
    kw = dict(symb_tx=tx, pilot_ind=np.arange(0, 2000, 32)) if "ddpll" in alg else {}
    jcfg = jcr.CPRConfig(alg="ddpll" if "ddpll" in alg else alg, M=16, N=35)
    y_j, ph_j = jcr.cpr(sig, jcfg, return_phases=True, **kw)
    tkw = {k: torch.as_tensor(v) if k == "symb_tx" else v for k, v in kw.items()}
    y_t, ph_t = tcr.cpr(torch.as_tensor(sig), tcr.CPRConfig(alg=alg, M=16, N=35),
                        return_phases=True, **tkw)
    atol = KERNEL_ATOL if alg == "ddpll-pallas" else (
        VITERBI_ATOL if alg == "viterbi" else PLL_ATOL)
    np.testing.assert_allclose(to_np(ph_t), np.asarray(ph_j), rtol=0, atol=atol)
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=10 * atol)


def test_viterbi_and_moving_average_match_jax():
    sig, _, _ = _rotated(31, 3000, 4, lw_ts=1e-6, modes=2)
    np.testing.assert_allclose(to_np(tsig.moving_average(torch.as_tensor(sig), 35)),
                               np.asarray(moving_average(sig, 35)), rtol=0, atol=1e-6)
    psk = _psk8()
    rng = np.random.default_rng(32)
    s8 = (psk[rng.integers(0, 8, size=(3000, 1))] * np.exp(0.05j)).astype(np.complex64)
    for x, m in ((sig, 4), (s8, 8)):
        np.testing.assert_allclose(to_np(tcr.viterbi(torch.as_tensor(x), 35, m)),
                                   np.asarray(jcr.viterbi(x, 35, m)), rtol=0,
                                   atol=VITERBI_ATOL)


def test_cpr_ddpll_pallas_reaches_k7_once():
    """cpr('ddpll-pallas') calls the K7 entry once for all columns; 'ddpll'
    (the reference rule) never."""
    sig, tx, _ = _rotated(33, 600, 16, modes=4)
    for alg, calls in (("ddpll-pallas", 1), ("ddpll", 0)):
        with mock.patch.object(tddpll, "ddpll_phases", wraps=tddpll.ddpll_phases) as k7:
            out = tcr.cpr(torch.as_tensor(sig), tcr.CPRConfig(alg=alg, M=16, runFOE=False),
                          symb_tx=torch.as_tensor(tx), pilot_ind=np.arange(0, 600, 32))
        assert k7.call_count == calls, alg
        if calls:
            assert k7.call_args.args[0].shape == (600, 4)
        assert out.shape == sig.shape and torch.isfinite(out).all()


# -- resampling to the DSP rate ----------------------------------------------

@pytest.mark.parametrize("in_fs,out_fs", [(8.0, 2.0), (2.0, 3.0)], ids=["down", "up"])
def test_resample_matches_jax(in_fs, out_fs):
    rng = np.random.default_rng(40)
    x = (rng.normal(size=(4096, 2)) + 1j * rng.normal(size=(4096, 2))).astype(np.complex64)
    ref = np.asarray(resample(x, in_fs, out_fs))
    out = tsig.resample(torch.as_tensor(x), in_fs, out_fs)
    assert out.shape == ref.shape
    assert rel_err(out, ref) < 1e-5


# -- frozen taps -------------------------------------------------------------

def _taps(rng, b=None, scale=0.1):
    shape = (2, 2, 15) if b is None else (b, 2, 2, 15)
    H = (scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))).astype(np.complex64)
    H[..., 0, 0, 7] += 1
    H[..., 1, 1, 7] += 1
    return H


@pytest.mark.parametrize("n,sps", [(2**11, 2), (3001, 2), (2**11, 3)],
                         ids=["folded", "odd_length", "sps3"])
def test_mimo_apply_matches_jax(n, sps):
    rng = np.random.default_rng(1)
    sig = (rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))).astype(np.complex64)
    H = _taps(rng, scale=0.2)
    ref = np.asarray(jeq.mimo_apply(jnp.asarray(H), jnp.asarray(sig), sps))
    out = teq.mimo_apply(taps_from_numpy(H, device="cpu"), torch.as_tensor(sig), sps)
    assert out.shape == ref.shape and out.dtype == torch.complex64
    assert rel_err(out, ref) < APPLY_REL


def test_mimo_apply_equals_the_static_rule():
    """mimo_apply is the output of the equalizer's 'static' rule (frozen
    taps), in the single and batch trainers; the static rule keeps its taps."""
    rng = np.random.default_rng(2)
    sig = (rng.normal(size=(800, 2)) + 1j * rng.normal(size=(800, 2))).astype(np.complex64)
    H = _taps(rng)
    cfg = teq.MIMOEqualizerConfig(nTaps=15, alg=("static",), M=16, backend="pallas")
    y_s, H_s, _, err, _ = teq.mimo_adapt_equalizer(torch.as_tensor(sig), cfg,
                                                   H=torch.as_tensor(H), return_results=True)
    y_a = teq.mimo_apply(torch.as_tensor(H), torch.as_tensor(sig), 2)
    assert torch.equal(H_s, torch.as_tensor(H)) and y_s.shape == y_a.shape
    assert rel_err(y_a, y_s) < APPLY_REL
    # without symb_ref the reference is the input itself, as in the JAX package
    np.testing.assert_allclose(to_np(err), np.abs(sig[:400] - to_np(y_s)).T ** 2,
                               rtol=1e-5, atol=1e-6)
    y_j = np.asarray(jeq.mimo_adapt_equalizer(
        sig, jeq.MIMOEqualizerConfig(nTaps=15, alg=("static",), M=16), H=jnp.asarray(H)))
    np.testing.assert_allclose(to_np(y_s), y_j, rtol=0, atol=1e-5)
    y_b = teq.mimo_adapt_equalizer_batch(torch.as_tensor(np.stack([sig, sig])), cfg,
                                         H=torch.as_tensor(np.stack([H, H])))
    assert torch.equal(y_b[0], y_s) and torch.equal(y_b[1], y_s)


@pytest.fixture(scope="module")
def fused_case():
    """(signal (2^13, 2), taps, matched filter, EDC config) of
    tests/test_equalization.py:206-247."""
    rng = np.random.default_rng(0)
    sig = (0.2 * (rng.normal(size=(2**13, 2)) + 1j * rng.normal(size=(2**13, 2)))
           ).astype(np.complex64)
    pulse = pulse_shape("rrc", 2, 128, 0.1).astype(np.float32)
    H = (0.1 * (rng.normal(size=(2, 2, 15)) + 1j * rng.normal(size=(2, 2, 15)))
         ).astype(np.complex64)
    H[0, 0, 7] += 1
    H[1, 1, 7] += 1
    return sig, H, pulse, jeq.EDCConfig(L=100, D=16, Fs=64e9, Rs=32e9)


@pytest.mark.parametrize("with_scale", [True, False], ids=["scale", "parseval"])
def test_mimo_apply_fused_matches_staged_and_jax(fused_case, with_scale):
    sig, H, pulse, jcfg = fused_case
    tcfg = config_from_jax(jcfg)
    x = teq.edc(tfilt.fir_filter(pulse, torch.as_tensor(sig)), tcfg)
    s = torch.sqrt(torch.mean((x * x.conj()).real))
    y_staged = to_np(teq.mimo_apply(torch.as_tensor(H), x / s, 2))
    scale = float(s) if with_scale else None
    y = to_np(teq.mimo_apply_fused(torch.as_tensor(H), torch.as_tensor(sig), 2, pre=pulse,
                                   edc_config=tcfg, scale=scale))
    lo, hi = 16, y_staged.shape[0] - (pulse.shape[0] + 300) // 2
    err = np.linalg.norm(y[lo:hi] - y_staged[lo:hi]) / np.linalg.norm(y_staged[lo:hi])
    assert err < (3e-4 if with_scale else 1e-2), err
    ref = np.asarray(jeq.mimo_apply_fused(jnp.asarray(H), jnp.asarray(sig), 2, pre=pulse,
                                          edc_config=jcfg, scale=scale))
    assert y.shape == ref.shape and rel_err(y, ref) < APPLY_REL
    # taps given as a tensor: the response is built on the device in complex64
    y_dev = teq.mimo_apply_fused(torch.as_tensor(H), torch.as_tensor(sig), 2,
                                 pre=torch.as_tensor(pulse), edc_config=tcfg, scale=scale)
    assert rel_err(y_dev, ref) < 1e-4


def test_mimo_apply_fused_without_prefilter_equals_mimo_apply():
    rng = np.random.default_rng(1)
    sig = (rng.normal(size=(2**11, 2)) + 1j * rng.normal(size=(2**11, 2))).astype(np.complex64)
    H = _taps(rng, scale=0.2)
    y = teq.mimo_apply(torch.as_tensor(H), torch.as_tensor(sig), 2)
    f = teq.mimo_apply_fused(torch.as_tensor(H), torch.as_tensor(sig), 2, scale=1.0)
    assert rel_err(f, y) < 1e-5


# -- coherent_dsp_serve (tests/test_pipelines.py:251-311) ---------------------

@pytest.fixture(scope="module")
def serve_case():
    rng = np.random.default_rng(3)
    cfg = CoherentDSPConfig(nFilterTaps=128, L=50, cpr_window=33, cpr_phases=32)
    sig_b = (0.3 * (rng.normal(size=(3, 2**12, 2)) + 1j * rng.normal(size=(3, 2**12, 2)))
             ).astype(np.complex64)
    return sig_b, _taps(rng, b=3), cfg


def _staged(sig, H, cfg):
    """The staged composition of the port: fir_filter, edc, pnorm, mimo_apply,
    then BPS (K1's entry), unwrap and derotation."""
    fs = cfg.Rs * cfg.SpS_dsp
    pulse = pulse_shape(cfg.pulseType, cfg.SpS_dsp, cfg.nFilterTaps, cfg.rollOff)
    x = teq.edc(tfilt.fir_filter(pulse.astype(np.float32), sig),
                teq.EDCConfig(L=cfg.L, D=cfg.D, Fc=cfg.Fc, Fs=fs, Rs=cfg.Rs))
    y = teq.mimo_apply(H, x / torch.sqrt(torch.mean((x * x.conj()).real)), cfg.SpS_dsp)
    ph = tbps.bps_kernel(y, cfg.cpr_window // 2, norm_qam(cfg.M), cfg.cpr_phases)
    ph = tcr.unwrap(4 * ph, dim=0) / 4
    return y * torch.exp(1j * ph)


@pytest.mark.parametrize("with_scale", [False, True], ids=["parseval", "scale"])
def test_coherent_dsp_serve_matches_jax_and_staged(serve_case, with_scale):
    sig_b, H_b, cfg = serve_case
    scale = None
    if with_scale:
        fs = cfg.Rs * cfg.SpS_dsp
        pulse = pulse_shape(cfg.pulseType, cfg.SpS_dsp, cfg.nFilterTaps, cfg.rollOff)
        edc_cfg = jeq.EDCConfig(L=cfg.L, D=cfg.D, Fc=cfg.Fc, Fs=fs, Rs=cfg.Rs)
        scale = np.array([float(np.sqrt(np.mean(np.abs(np.asarray(jeq.edc(
            fir_filter(pulse.astype(np.float32), s), edc_cfg))) ** 2))) for s in sig_b],
            np.float32)
    out_j, ph_j = coherent_dsp_serve(jnp.asarray(sig_b), jnp.asarray(H_b), cfg, scale)
    with mock.patch.object(tbps, "bps_kernel", wraps=tbps.bps_kernel) as k1:
        out_t, ph_t = tpipe.coherent_dsp_serve(torch.as_tensor(sig_b),
                                               taps_from_numpy(H_b, device="cpu"),
                                               config_from_jax(cfg), scale)
    assert k1.call_count == 1 and k1.call_args.args[0].shape == (2**11, 6)
    assert out_t.shape == out_j.shape and ph_t.shape == ph_j.shape == (2**11, 6)
    d = np.abs(to_np(out_t) - np.asarray(out_j))
    assert np.mean(d > 1e-4) < 0.01, np.mean(d > 1e-4)
    ref0 = to_np(_staged(torch.as_tensor(sig_b[0]), torch.as_tensor(H_b[0]),
                         config_from_jax(cfg)))
    got0 = to_np(out_t[0])
    lo, hi = 32, ref0.shape[0] - (cfg.nFilterTaps + 200) // cfg.SpS_dsp
    err = np.linalg.norm(got0[lo:hi] - ref0[lo:hi]) / np.linalg.norm(ref0[lo:hi])
    assert err < 5e-2, err


def test_coherent_dsp_serve_single_signal():
    rng = np.random.default_rng(4)
    cfg = CoherentDSPConfig(nFilterTaps=64, L=20, cpr_window=17, cpr_phases=16)
    sig = (0.3 * (rng.normal(size=(2**11, 2)) + 1j * rng.normal(size=(2**11, 2)))
           ).astype(np.complex64)
    H = np.zeros((2, 2, 15), dtype=np.complex64)
    H[0, 0, 7] = H[1, 1, 7] = 1
    out_j, ph_j = coherent_dsp_serve(jnp.asarray(sig), jnp.asarray(H), cfg)
    out_t, ph_t = tpipe.coherent_dsp_serve(torch.as_tensor(sig), torch.as_tensor(H),
                                           config_from_jax(cfg))
    assert out_t.shape == out_j.shape and ph_t.shape == ph_j.shape
    assert torch.isfinite(out_t).all()
    assert np.mean(np.abs(to_np(out_t) - np.asarray(out_j)) > 1e-4) < 0.01


# -- the kernel on the card --------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["qam16_pilots", "psk8"])
def test_ddpll_kernel_matches_plain_on_gpu(kind):
    dev = require_cuda()
    if kind == "qam16_pilots":
        sig, tx, _ = _rotated(50, 8192, 16, modes=22)
        const, pilot = norm_qam(16), torch.zeros(8192, device=dev)
        pilot[::32] = 1.0
    else:
        const = _psk8()
        rng = np.random.default_rng(51)
        tx = const[rng.integers(0, 8, size=(4096, 5))]
        sig = (tx * np.exp(1j * np.cumsum(rng.normal(0, 0.005, size=(4096, 1)), axis=0))
               ).astype(np.complex64)
        pilot = torch.zeros(4096, device=dev)
    x = torch.as_tensor(sig, device=dev)
    ref = torch.as_tensor(tx.astype(np.complex64), device=dev)
    before = tddpll.launches
    est_k = tddpll.ddpll_phases(x, ref, pilot, const, TS, 0.1, TAU, TAU)
    assert tddpll.launches == before + 1
    est_p = tcr.ddpll(x, TS, 0.1, TAU, TAU, torch.as_tensor(const, device=dev), symb_tx=ref,
                      pilot_ind=np.flatnonzero(pilot.cpu().numpy()))
    assert tddpll.launches == before + 1
    torch.cuda.synchronize()
    assert float((est_k - est_p).abs().max()) < KERNEL_ATOL


# K7's staging edges: n not a multiple of the 256-row chunk, pilots on a
# chunk's first and last rows, n below 16, 1 to 70 columns (a partial warp
# of 16 columns, several warps), and the argmin slicer
K7_EDGES = [("qam16_pilots", 300, 22), ("qam16_pilots", 7, 1), ("qam16_pilots", 1000, 33),
            ("qam16_pilots", 515, 70), ("psk8", 400, 5), ("psk8", 129, 22)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n,n_cols", K7_EDGES)
def test_ddpll_kernel_equals_twin_on_gpu(kind, n, n_cols):
    """K7 against its plain twin on the card, bit for bit, one launch."""
    dev = require_cuda()
    sig, tx, pilot, const = _twin_case(kind, n, n_cols, seed=n + n_cols)
    if kind == "qam16_pilots":
        pilot[:] = 0.0
        for r in (0, 127, 128, 255, 256, 511, 512, n - 1):
            if r < n:
                pilot[r] = 1.0
        pilot[::31] = 1.0
    x, ref = torch.as_tensor(sig, device=dev), torch.as_tensor(tx, device=dev)
    p = torch.as_tensor(pilot, device=dev)
    before = tddpll.launches
    est_k = tddpll.ddpll_phases(x, ref, p, const, TS, 0.1, TAU, TAU)
    assert tddpll.launches == before + 1
    est_p = tddpll.ddpll_plain(x, ref, p, const, tddpll.loop_coefs(TS, 0.1, TAU, TAU))
    torch.cuda.synchronize()
    assert est_k.shape == (n, n_cols) and torch.equal(est_k, est_p)
