"""The port's single-polarization link against opticommpy_tpu: the scalar
SSFM, AWGN, the phase modulator, attenuator, ADC and DAC, the quantizer,
the frequency shift and the parallel-power rescale.

Tolerances: the SSFM's relative error <= 1e-4 in complex64 and <= 1e-9 in
complex128 (rounding over the split steps); the deterministic devices
within 1e-6 (float32 rounding of the same operations); the quantizer's
levels exactly. Noise is checked by its statistics (torch cannot reproduce
``jax.random``): sample variances within 2% at 2**16 samples or more,
where the estimate's own spread is ~0.6%.
"""

import jax
import numpy as np
import pytest
import scipy.constants as sconst
import torch

torch.set_num_threads(1)

from opticommpy_tpu.models import channels as jch  # noqa: E402
from opticommpy_tpu.models import config as jcfg  # noqa: E402
from opticommpy_tpu.models import devices as jdev  # noqa: E402
from opticommpy_tpu.models import tx as jtx  # noqa: E402
from opticommpy_tpu.ops import signal as jsig  # noqa: E402
from opticommpy_torch.comm import metrics as tmet  # noqa: E402
from opticommpy_torch.comm import modulation as tmod  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.models import channels as tch  # noqa: E402
from opticommpy_torch.models import devices as tdev  # noqa: E402
from opticommpy_torch.models import tx as ttx  # noqa: E402
from opticommpy_torch.ops import signal as tsig  # noqa: E402

from _torch_parity import rel_err, to_np  # noqa: E402
from test_torch_tx_channel import _field  # noqa: E402

FS = 32e9 * 8
# (fusedLinear, amp, prec, batched): every value of each factor at least
# once, one JAX build per case
SSFM_CASES = [
    (True, "ideal", "c64", False),
    (True, None, "c64", True),
    (False, "ideal", "c64", True),
    (False, None, "c64", False),
    (True, "ideal", "c128", True),
    (False, None, "c128", False),
]


@pytest.mark.parametrize("fused,amp,prec,batched", SSFM_CASES)
def test_ssfm_matches_jax(fused, amp, prec, batched):
    # hz 0.7 does not divide Lspan: the ideal gain is exp(alpha/2*n_steps*hz)
    cfg = jcfg.SSFMConfig(Ltotal=100, Lspan=50, hz=0.7, alpha=0.2, D=16, gamma=1.3, Fs=FS,
                          amp=amp, prec=prec, fusedLinear=fused)
    dtype = np.complex128 if prec == "c128" else np.complex64
    x = _field().astype(dtype)
    x = x if batched else x[:, 0]
    with jax.enable_x64(prec == "c128"):
        ref = np.asarray(jch.ssfm(x, cfg))
    out = tch.ssfm(torch.as_tensor(x), config_from_jax(cfg))
    tol = 1e-9 if prec == "c128" else 1e-4
    assert to_np(out).dtype == ref.dtype and out.shape == ref.shape
    assert rel_err(out, ref) <= tol, rel_err(out, ref)


def test_ssfm_edfa_adds_the_amplifier_noise_per_span():
    """A dark input: after n spans (Lspan a multiple of hz, so gain = loss)
    the field holds n spans of ASE, each of the EDFA model's power."""
    cfg = tch.SSFMConfig(Ltotal=100, Lspan=50, hz=5.0, alpha=0.2, D=16, gamma=1.3, Fs=64e9,
                         amp="edfa", NF=4.5, fusedLinear=True)
    out = tch.ssfm(torch.zeros((2**16, 2), dtype=torch.complex64), cfg,
                   torch.Generator().manual_seed(1))
    g, nf = 10.0, 10**0.45
    p_ase = (g - 1) * (g * nf - 1) / (2 * (g - 1)) * sconst.h * cfg.Fc * cfg.Fs
    assert abs(float(torch.mean(torch.abs(out) ** 2)) / (2 * p_ase) - 1) < 0.02


@pytest.mark.parametrize("complex_noise", [True, False])
def test_awgn_noise_power_and_types(complex_noise):
    rng = np.random.default_rng(2)
    cfg = jcfg.AWGNConfig(snr=15.0, Fs=4.0, B=1.0, complexNoise=complex_noise)
    if complex_noise:
        sig = (rng.normal(size=(2**16, 2)) + 1j * rng.normal(size=(2**16, 2))).astype(np.complex64)
    else:
        sig = rng.normal(size=2**17).astype(np.float32)
    ref = jch.awgn(sig, jax.random.PRNGKey(0), cfg)
    sig_t = torch.as_tensor(sig)
    out = tch.awgn(sig_t, torch.Generator().manual_seed(0), config_from_jax(cfg))
    assert to_np(out).dtype == ref.dtype and out.shape == ref.shape
    var = 4.0 * np.mean(np.abs(sig) ** 2) / 10**1.5
    got = float(torch.mean(torch.abs(out - sig_t) ** 2))
    assert abs(got / (var if complex_noise else var / 2) - 1) < 0.02


def test_seeded_draws_need_cuda_or_a_named_device():
    """awgn, adc and dac with a seed or no generator draw on the card; given
    NumPy input and no card they raise, and device='cpu' runs them here."""
    sig = np.ones(64, np.complex64)
    cfg = tdev.ADCConfig(nBits=8, ENOB=6)
    calls = [lambda **kw: tch.awgn(sig, 3, **kw), lambda **kw: tdev.adc(sig, cfg, 3, **kw),
             lambda **kw: tdev.dac(sig + 0.1j * np.arange(64), tdev.DACConfig(), **kw)]
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        assert call(device="cpu").device.type == "cpu"


_C16 = tmod.gray_mapping(16, "qam") / np.sqrt(10)
_SYMB = _C16[np.arange(64) % 16]
_LLR = np.linspace(-3, 3, 256).astype(np.float32)
# each entry point of the single-polarization slice, called on NumPy input
NUMPY_INPUT_CALLS = {
    "quantizer": lambda: tsig.quantizer(np.linspace(-1, 1, 64, dtype=np.float32)),
    "freq_shift": lambda: tsig.freq_shift(_SYMB, 1e9, 64e9),
    "detector": lambda: tmod.detector(_SYMB, 0.1, _C16)[0],
    "soft_estimator": lambda: tmod.soft_estimator(
        _LLR.reshape(-1, 4), tmod.bit_map(16, "qam"), _C16)[0],
    "soft_mapper": lambda: tmod.soft_mapper(_LLR, 16, "qam")[0],
    "calc_extr_llr": lambda: tmet.calc_extr_llr(
        _LLR, _SYMB, np.ones(64, np.float32), np.full(64, 0.1, np.float32), _C16,
        tmod.bit_map(16, "qam")),
    "calc_mi": lambda: tmet.calc_mi(_SYMB, _SYMB, 0.1, _C16, np.ones(16) / 16),
    "monte_carlo_mi": lambda: tmet.monte_carlo_mi(_SYMB, _SYMB, 16, "qam"),
}


@pytest.mark.parametrize("name", sorted(NUMPY_INPUT_CALLS))
def test_numpy_input_goes_to_the_card(name):
    """Given NumPy input, each function runs on the card, and without one it
    raises: only a CPU tensor asks for the CPU."""
    call = NUMPY_INPUT_CALLS[name]
    if torch.cuda.is_available():
        assert call().is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_quantizer_matches_jax():
    """Equal levels; the level value within a float32 rounding (the JAX
    package's ``min + idx*delta`` may be one fused multiply-add)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.3, 1.3, size=4096).astype(np.float32)
    x[:9] = [-1.0, 1.0, 0.0, -2.0, 2.0, 1 / 255, -1 / 255, 3 / 255, 0.5]
    for n_bits, hi, lo in ((3, 1.0, -1.0), (8, 1.0, -1.0), (12, 0.7, -0.2)):
        ref = np.asarray(jsig.quantizer(x, n_bits, hi, lo))
        out = tsig.quantizer(torch.as_tensor(x), n_bits, hi, lo)
        assert out.dtype == torch.float32
        # 1e-6 is far below half a level (>= 2.2e-4 here): the levels are equal
        np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=1e-6)


def test_freq_shift_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2**14, 2)) + 1j * rng.normal(size=(2**14, 2))).astype(np.complex64)
    for xi, df in ((x, 1.5e9), (x[:, 0], -7.3e8)):
        ref = np.asarray(jsig.freq_shift(xi, df, 64e9))
        out = tsig.freq_shift(torch.as_tensor(xi), df, 64e9)
        assert out.shape == ref.shape and out.dtype == torch.complex64
        np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_pm_voa_and_parallel_power_match_jax():
    rng = np.random.default_rng(5)
    e = (rng.normal(size=(4096, 4)) + 1j * rng.normal(size=(4096, 4))).astype(np.complex64)
    u = rng.uniform(-2, 2, size=(4096, 4)).astype(np.float32)
    out = tdev.pm(torch.as_tensor(e), torch.as_tensor(u), 2.0)
    np.testing.assert_allclose(to_np(out), np.asarray(jdev.pm(e, u, 2.0)), rtol=0, atol=1e-6 * 5)
    np.testing.assert_array_equal(to_np(tdev.voa(torch.as_tensor(e), 3.0)),
                                  np.asarray(jdev.voa(e, 3.0)))
    powers = np.array([-2.0, 3.5])
    ref = np.asarray(jtx.set_power_for_par_ssfm(e, powers))
    out = ttx.set_power_for_par_ssfm(torch.as_tensor(e), powers)
    assert rel_err(out, ref) <= 1e-6
    pair = to_np(out)[:, 2:].astype(np.complex128)
    assert abs(np.sum(np.mean(np.abs(pair) ** 2, axis=0)) / (1e-3 * 10**0.35) - 1) < 1e-5


ADC_CASES = {
    "complex-aaf-down": dict(cfg=dict(inFs=4.0, outFs=2.0, nBits=8, ENOB=8), cplx=True),
    "real-no-aaf": dict(cfg=dict(inFs=1.0, outFs=1.0, nBits=6, ENOB=6, AAF=False), cplx=False),
    "real-aaf-up": dict(cfg=dict(inFs=2.0, outFs=3.0, nBits=10, ENOB=10, Vmax=0.8), cplx=False),
}


def _signal(cplx, n=4096, seed=6):
    rng = np.random.default_rng(seed)
    x = 0.4 * rng.normal(size=(n, 2))
    if cplx:
        x = x + 0.4j * rng.normal(size=(n, 2))
        return x.astype(np.complex64)
    return x.astype(np.float32)


@pytest.mark.parametrize("case", sorted(ADC_CASES))
def test_adc_without_noise_matches_jax(case):
    cfg = jcfg.ADCConfig(**ADC_CASES[case]["cfg"])
    x = _signal(ADC_CASES[case]["cplx"])
    ref = np.asarray(jdev.adc(x, cfg))
    out = tdev.adc(torch.as_tensor(x), config_from_jax(cfg))
    assert to_np(out).dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cplx,aif", [(True, True), (False, False)])
def test_dac_without_noise_matches_jax(cplx, aif):
    cfg = jcfg.DACConfig(inFs=1.0, outFs=4.0, nBits=6, ENOB=6, Vpp=1.5, AIF=aif)
    x = _signal(cplx, 2048, seed=7)[:, 0]
    ref = np.asarray(jdev.dac(x, cfg))
    out = tdev.dac(torch.as_tensor(x), config_from_jax(cfg))
    assert to_np(out).dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=1e-6)


def test_adc_and_dac_noise_statistics():
    """ENOB below nBits adds noise of variance scale^2/12 (2^-2ENOB -
    2^-2nBits) per axis; jitter moves the sampling instants by its rms."""
    n = 2**17
    zeros = torch.zeros(n, dtype=torch.complex64)
    gen = torch.Generator().manual_seed(8)
    acfg = tdev.ADCConfig(nBits=10, ENOB=5.5, AAF=False)
    pn = 2.0**2 / 12 * (2.0**-11 - 2.0**-20)
    got = tdev.adc(zeros, acfg, gen) - tdev.adc(zeros, tdev.ADCConfig(nBits=10, ENOB=10, AAF=False))
    assert abs(float(torch.var(got.real)) / pn - 1) < 0.02
    assert abs(float(torch.var(got.imag)) / pn - 1) < 0.02
    ramp = torch.linspace(-1.0, 1.0, n)
    dcfg = tdev.DACConfig(nBits=12, ENOB=6.0, AIF=False, Vpp=2.0)
    got = tdev.dac(ramp, dcfg, gen) - tdev.dac(ramp, tdev.DACConfig(nBits=12, ENOB=12, AIF=False))
    pn = 2.0**2 / 12 * (2.0**-12 - 2.0**-24)
    assert abs(float(torch.var(got)) / pn - 1) < 0.02
    # jitter of 50 sample periods on a ramp: the sample error is slope x
    # jitter, 25x the quantization step
    jcfg_ = tdev.ADCConfig(inFs=1.0, outFs=1.0, nBits=16, ENOB=16, jitter=50.0, AAF=False)
    jit = tdev.adc(ramp, jcfg_, gen) - tdev.adc(ramp, tdev.ADCConfig(nBits=16, ENOB=16, AAF=False))
    assert abs(float(torch.var(jit[1000:-1000])) / (50.0 * 2.0 / n) ** 2 - 1) < 0.02
