"""The port's WDM transmitter, Manakov channel and EDFA against opticommpy_tpu.

Tolerances: Tx relative error <= 1e-4 against the JAX package's channels
shifted by exact carrier ramps (FFT rounding; the JAX package's float32
ramps are shown beside it); channel relative error <= 1e-4 in complex64 and <= 1e-9 in
complex128 (rounding accumulated over the split steps).
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
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.models import channels as tch  # noqa: E402
from opticommpy_torch.models import devices as tdev  # noqa: E402
from opticommpy_torch.models import tx as ttx  # noqa: E402

from _torch_parity import rel_err, to_np  # noqa: E402

# the JAX package's Tx against exact carrier ramps at 3 channels, 16,384
# samples, +-37.5 GHz: its float32 ramps give 1.23e-4
JAX_RAMP_GAP = 1.5e-4


def test_simple_wdm_tx_matches_jax():
    """The port's Tx is the JAX package's with exact carrier ramps. The JAX
    package forms ``2 pi f t`` in float32 (opticommpy_tpu/models/tx.py:167),
    so the port is held to the JAX package's channels, each built alone at
    f = 0 (no ramp) and shifted by float64 ramps; the JAX package's own
    gap to that is shown beside it."""
    kw = dict(M=16, Rs=32e9, SpS=16, nBits=4096, nChannels=3, nPolModes=2, nFilterTaps=256,
              pulseRollOff=0.01, laserLinewidth=0.0)
    power = (-2.0, 0.0, 1.0)
    cfg = jtx.WDMTxConfig(powerPerChannel=power, wdmGridSpacing=37.5e9, **kw)
    sig_j, symb_j, grid_j = jtx.simple_wdm_tx(3, cfg)
    symbols = torch.as_tensor(np.array(symb_j)).permute(2, 1, 0)
    pn = torch.zeros((cfg.nChannels, cfg.nSymbols * cfg.SpS))
    sig_t, symb_t, grid_t = ttx.wdm_tx_build(symbols, pn, config_from_jax(cfg))
    np.testing.assert_array_equal(grid_t, grid_j)
    np.testing.assert_array_equal(to_np(symb_t), np.asarray(symb_j))
    assert sig_t.shape == sig_j.shape and sig_t.dtype == torch.complex64
    k = np.arange(sig_t.shape[0])
    exact = 0
    for ch, f in enumerate(grid_j):
        alone = tuple(p if c == ch else -np.inf for c, p in enumerate(power))
        s_ch, _, _ = jtx.simple_wdm_tx(3, jtx.WDMTxConfig(powerPerChannel=alone,
                                                          wdmGridSpacing=0.0, **kw))
        turns = k * (f / cfg.Fs)
        exact = exact + np.asarray(s_ch) * np.exp(2j * np.pi * (turns - np.round(turns)))[:, None]
    assert rel_err(sig_t, exact) <= 1e-4
    # the JAX package's float32 ramps: 1.23e-4 here, ~220x the port's 5.6e-7
    assert rel_err(sig_j, exact) > 100 * rel_err(sig_t, exact)
    assert rel_err(sig_t, sig_j) <= JAX_RAMP_GAP


def test_simple_wdm_tx_draws():
    cfg = ttx.WDMTxConfig(M=16, SpS=4, nBits=2**14, nChannels=2, nPolModes=2,
                          nFilterTaps=64, laserLinewidth=100e3)
    sig, symb, grid = ttx.simple_wdm_tx(5, cfg, device="cpu")
    assert sig.shape == (cfg.nSymbols * cfg.SpS, 2)
    assert symb.shape == (cfg.nSymbols, 2, 2)
    # every 16-QAM point is drawn about equally often
    _, counts = np.unique(to_np(symb).round(4), return_counts=True)
    assert len(counts) == 16 and counts.min() > 0.8 * counts.mean()
    # per-channel power: -3 dBm over 2 channels
    assert abs(float(torch.mean(torch.abs(sig) ** 2)) * 2 / (2 * 10**-0.3 * 1e-3) - 1) < 0.05
    sig2, _, _ = ttx.simple_wdm_tx(5, cfg, device="cpu")
    np.testing.assert_array_equal(to_np(sig2), to_np(sig))


def test_seed_without_device_runs_on_cuda_or_raises():
    """An entry point given a seed and no device draws on the card; with no
    card it raises rather than fall back to the CPU. A tensor input keeps
    its device."""
    cfg = ttx.WDMTxConfig(M=16, SpS=4, nBits=2**10, nChannels=1, nPolModes=2,
                          nFilterTaps=64)
    lcfg = tdev.LaserConfig(Ns=64, Fs=1e9)
    if torch.cuda.is_available():
        assert ttx.simple_wdm_tx(5, cfg)[0].is_cuda
        assert tdev.basic_laser_model(lcfg, 4).is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttx.simple_wdm_tx(5, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdev.basic_laser_model(lcfg, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdev.basic_laser_model(lcfg)
    assert tdev.basic_laser_model(lcfg, 4, device="cpu").device.type == "cpu"
    e = torch.ones(16, dtype=torch.complex64)
    assert tdev.edfa(e, tdev.EDFAConfig(Fs=1e9)).device.type == "cpu"


def _field(n=2**12, seed=0):
    rng = np.random.default_rng(seed)
    sps = 8
    sym = rng.choice([-1 - 1j, -1 + 1j, 1 - 1j, 1 + 1j], size=(n // sps, 2))
    up = np.zeros((n, 2), complex)
    up[::sps] = sym
    h = np.sinc(np.arange(-4 * sps, 4 * sps + 1) / sps)
    sig = np.stack([np.convolve(up[:, k], h, "same") for k in range(2)], axis=1)
    return 0.05 * sig  # ~3 mW per polarization: visibly nonlinear


SSFM_CASES = {
    "fused": dict(nlprMethod=False, trapIters=1, fusedLinear=True, hz=0.5),
    "unfused": dict(nlprMethod=False, trapIters=1, hz=0.7),
    "unfused-iterated": dict(nlprMethod=False, trapIters=0, hz=2.0),
    "adaptive": dict(nlprMethod=True),
}


@pytest.mark.parametrize("prec,tol", [("c64", 1e-4), ("c128", 1e-9)])
@pytest.mark.parametrize("case", sorted(SSFM_CASES))
def test_manakov_ssf_matches_jax(case, prec, tol):
    kw = dict(Ltotal=100, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fs=32e9 * 8,
              amp="ideal", prec=prec, **SSFM_CASES[case])
    cfg = jcfg.SSFMConfig(**kw)
    dtype = np.complex128 if prec == "c128" else np.complex64
    x = _field().astype(dtype)
    with jax.enable_x64(prec == "c128"):
        ref = np.asarray(jch.manakov_ssf(x, cfg))
    out = tch.manakov_ssf(torch.as_tensor(x), config_from_jax(cfg))
    assert to_np(out).dtype == ref.dtype
    assert rel_err(out, ref) <= tol, rel_err(out, ref)


def test_manakov_ssf_save_all_spans_and_batch():
    x = _field(2**11).astype(np.complex64)
    x = np.concatenate([x, 0.5 * x[::-1]], axis=1)  # two signals, (N, 4)
    cfg = jcfg.SSFMConfig(Ltotal=100, Lspan=50, hz=1.0, alpha=0.2, D=16, Fs=32e9 * 8,
                          amp="ideal", nlprMethod=False, trapIters=1, fusedLinear=True)
    ref, ref_spans = jch.manakov_ssf(x, cfg, save_all_spans=True)
    out, spans = tch.manakov_ssf(torch.as_tensor(x), config_from_jax(cfg),
                                 save_all_spans=True)
    assert spans.shape == ref_spans.shape == (2, 2**11, 4)
    assert rel_err(out, ref) <= 1e-4 and rel_err(spans, ref_spans) <= 1e-4


def test_edfa_ase_power():
    cfg = tdev.EDFAConfig(G=10.0, NF=4.5, Fs=64e9)
    e = torch.zeros((2**16, 2), dtype=torch.complex64)
    out = tdev.edfa(e, cfg, torch.Generator().manual_seed(3))
    g, nf = 10.0, 10**0.45
    p_ase = (g - 1) * (g * nf - 1) / (2 * (g - 1)) * sconst.h * cfg.Fc * cfg.Fs
    assert abs(float(torch.mean(torch.abs(out) ** 2)) / p_ase - 1) < 0.05
    sig = torch.ones((8, 1), dtype=torch.complex64)
    quiet = tdev.edfa(sig, tdev.EDFAConfig(G=20.0, NF=4.5, Fs=1.0))
    np.testing.assert_allclose(to_np(quiet).real, 10.0, rtol=1e-4)


def test_receiver_front_end_matches_jax():
    """The ideal coherent receiver (deterministic): hybrid, PBS, balanced PDs."""
    rng = np.random.default_rng(9)
    n, fs = 4096, 64e9
    e_s = (1e-2 * (rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2)))).astype(np.complex64)
    lo = (np.sqrt(1e-2) * np.exp(1j * rng.uniform(0, 2 * np.pi, n))).astype(np.complex64)
    jfe = jcfg.PDMFrontendConfig(Fs=fs)
    ref = np.asarray(jdev.pdm_coherent_receiver(e_s, lo, jfe))
    out = tdev.pdm_coherent_receiver(torch.as_tensor(e_s), torch.as_tensor(lo),
                                     config_from_jax(jfe))
    assert rel_err(out, ref) <= 1e-6
    fields = (torch.as_tensor(e_s[:, 0]), torch.as_tensor(lo))
    hyb = tdev.optical_hybrid_2x4(*fields)
    assert rel_err(hyb, jdev.optical_hybrid_2x4(e_s[:, 0], lo)) <= 1e-7
    u = np.linspace(-1, 1, 64).astype(np.float32)
    assert rel_err(tdev.iqm(torch.ones(64, dtype=torch.complex64), torch.as_tensor(u + 0.5j * u)),
                   jdev.iqm(np.ones(64, np.complex64), u + 0.5j * u)) <= 1e-6


def test_laser_and_photodiode_statistics():
    cfg = tdev.LaserConfig(P=10.0, lw=100e3, RIN_var=0.0, Ns=2**16, Fs=64e9,
                           freqShift=150e6)
    lo = tdev.basic_laser_model(cfg, torch.Generator().manual_seed(4))
    assert abs(float(torch.mean(torch.abs(lo) ** 2)) / 1e-2 - 1) < 1e-5
    dphi = torch.diff(torch.angle(lo * torch.exp(-2j * np.pi * 150e6 *
                                                  torch.arange(2**16) / 64e9)))
    dphi = torch.remainder(dphi + np.pi, 2 * np.pi) - np.pi
    assert abs(float(torch.var(dphi)) / (2 * np.pi * 100e3 / 64e9) - 1) < 0.05
    pd = tdev.PhotodiodeConfig(Fs=128e9, B=30e9, bandwidthLimitation=False)
    ipd = tdev.photodiode(torch.full((2**16,), 1e-2, dtype=torch.complex64), pd,
                          torch.Generator().manual_seed(5))
    var = 2 * sconst.e * (1e-4 + pd.Id) * pd.B + 4 * sconst.k * (pd.Tc + 273.15) * pd.B / pd.RL
    assert abs(float(torch.var(ipd)) / (pd.Fs * var / (2 * pd.B)) - 1) < 0.05
