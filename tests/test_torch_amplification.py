"""The port's physical EDFA (opticommpy_torch.models.amplification) against
the JAX package's on the same seeded NumPy inputs (CPU tensors).

The EDF tables, the mode radii and the host solver are float64 NumPy in
both packages, so they agree to float64 rounding (tolerance 1e-12
relative). ``edfa_sm`` is compared with its ASE draw zeroed on both sides
(the JAX side through a stub ``rng``, the port's through ``_ase_noise``):
pumps, noise amplitude and field to 1e-10 relative, and the ``report``
events one for one. The draw itself is checked by its statistics.
"""

from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.models import amplification as jamp  # noqa: E402
from opticommpy_torch.models import amplification as tamp  # noqa: E402

from _torch_parity import cpu, rel_err, to_np  # noqa: E402

F64_REL = 1e-12
EDFA_REL = 1e-10
FS, FC = 400e9, 193.1e12


def _cw_wdm_signal(n=2048, fs=FS, n_ch=3, p_ch_w=1e-4):
    """tests/test_amplification.py's three CW tones as a toy WDM signal."""
    t = np.arange(n) / fs
    freqs = np.linspace(-100e9, 100e9, n_ch)
    x = sum(np.sqrt(p_ch_w) * np.exp(2j * np.pi * f * t) for f in freqs)
    return np.stack([x, np.zeros_like(x)], axis=1)


def _port_cfg(cfg):
    return tamp.EDFASMConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


class _ZeroRng:
    """A NumPy-Generator stand-in whose normal draws are all zero."""

    def standard_normal(self, shape):
        return np.zeros(shape)


def _no_ase(noise_amp, generator):
    return torch.zeros(noise_amp.shape, dtype=torch.complex128, device=noise_amp.device)


def test_edf_tables_match_jax():
    for fn in ("synthetic_edf_data", "mp980_edf_data"):
        for got, want in zip(getattr(tamp, fn)(), getattr(jamp, fn)()):
            np.testing.assert_allclose(got, want, rtol=F64_REL, atol=0)


@pytest.mark.parametrize("model", ["Marcuse", "Whitley", "Desurvire", "Myslinski", "Bessel"])
def test_mode_radius_matches_jax(model):
    V = np.linspace(1.5, 2.4, 7)
    u = ((1 + np.sqrt(2)) * V) / (1 + (4 + V**4) ** 0.25)
    v = np.sqrt(V**2 - u**2)
    np.testing.assert_allclose(tamp.get_mode_radius(model, 1.5e-6, V, v, u),
                               jamp.get_mode_radius(model, 1.5e-6, V, v, u),
                               rtol=F64_REL, atol=0)


def test_mode_radius_rejects_unknown_model():
    with pytest.raises(TypeError):
        tamp.get_mode_radius("Gauss", 1.5e-6, 2.0, 1.3, 1.5)


@pytest.mark.parametrize("kw", [dict(), dict(file="MP980"), dict(gmtc="Whitley"),
                                dict(gmtc="Bessel", longSteps=40)],
                         ids=["synthetic", "mp980", "whitley", "bessel"])
def test_edf_params_match_jax(kw):
    want = jamp.edf_params(jamp.EDFASMConfig(**kw))
    got = tamp.edf_params(tamp.EDFASMConfig(**kw))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=F64_REL, atol=0, err_msg=key)


CASES = {
    "agc": dict(type="AGC", value=15.0, lngth=6.0, forPumpW=(60e-3,), bckPumpW=(0.0,),
                noiseBand=50e9, tolCtrl=1.0),
    "agc-low-gain": dict(type="AGC", value=10.0, lngth=8.0, forPumpW=(60e-3,),
                         bckPumpW=(0.0,), noiseBand=100e9, tolCtrl=0.5),
    "apc": dict(type="APC", value=5.0, lngth=6.0, forPumpW=(60e-3,), bckPumpW=(20e-3,),
                noiseBand=50e9, tolCtrl=0.5),
    "none": dict(type="none", lngth=6.0, forPumpW=(30e-3,), bckPumpW=(0.0,), noiseBand=50e9),
    "giles-spatial": dict(type="none", algo="Giles_spatial", lngth=6.0, forPumpW=(30e-3,),
                          bckPumpW=(10e-3,), noiseBand=50e9, longSteps=20),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_edfa_sm_matches_jax(name):
    cfg = jamp.EDFASMConfig(**CASES[name])
    sig = _cw_wdm_signal(p_ch_w=2e-4 if name == "agc-low-gain" else 1e-4)
    ev_j, ev_t = [], []
    want = jamp.edfa_sm(sig, FS, FC, cfg, rng=_ZeroRng(), report=ev_j.append)
    with mock.patch.object(tamp, "_ase_noise", _no_ase):
        got = tamp.edfa_sm(cpu(sig), FS, FC, _port_cfg(cfg), report=ev_t.append,
                           generator=torch.Generator().manual_seed(0))
    e_out, p_f, p_b, noise_amp = got
    assert e_out.dtype == torch.complex128 and tuple(e_out.shape) == sig.shape
    assert p_f.dtype == torch.float64 and noise_amp.dtype == torch.float64
    for g, w, what in zip(got, want, ("e_out", "pump_f", "pump_b", "noise_amp")):
        w = np.asarray(w)
        if not np.any(w):
            np.testing.assert_array_equal(to_np(g), w, err_msg=what)
            continue
        assert rel_err(g, w) < EDFA_REL, what
    assert [ev["stage"] for ev in ev_t] == [ev["stage"] for ev in ev_j]
    for a, b in zip(ev_t, ev_j):
        assert a.keys() == b.keys()
        for key in a:
            if key != "stage":
                np.testing.assert_allclose(a[key], b[key], rtol=1e-9, atol=1e-15, err_msg=key)


def test_edfa_sm_one_polarization_and_report_failure_events():
    """An (N,) field gets a zero Y polarization, as in the JAX package; a
    relaxation that cannot converge in two loops reports its failure."""
    rng = np.random.default_rng(0)
    e = (rng.normal(size=256) + 1j * rng.normal(size=256)) * 1e-3
    cfg = jamp.EDFASMConfig(type="AGC", value=15.0, lngth=6.0, longSteps=40, tol=1e-9)
    ev_j, ev_t = [], []
    want = jamp.edfa_sm(e, 40e9, FC, cfg, rng=_ZeroRng(), report=ev_j.append)
    with mock.patch.object(tamp, "_ase_noise", _no_ase):
        got = tamp.edfa_sm(cpu(e), 40e9, FC, _port_cfg(cfg), report=ev_t.append,
                           generator=torch.Generator().manual_seed(0))
    assert tuple(got[0].shape) == (256, 2)
    assert rel_err(got[0], want[0]) < EDFA_REL and rel_err(got[1], want[1]) < EDFA_REL
    assert [ev.get("failed", False) for ev in ev_t] == [ev.get("failed", False) for ev in ev_j]
    assert any(ev.get("failed") for ev in ev_t)


def test_edfa_sm_rejects_bad_config():
    sig = cpu(_cw_wdm_signal(n=64))
    with pytest.raises(TypeError):
        tamp.edfa_sm(sig, FS, FC, tamp.EDFASMConfig(type="AGCX"))
    with pytest.raises(TypeError):
        tamp.edfa_sm(sig, FS, FC, tamp.EDFASMConfig(algo="Giles"))


def test_ase_draw_statistics_and_default_generator():
    """The drawn ASE has variance noise_amp**2 per bin (within 2% over 2**17
    draws), real and imaginary parts alike; with no generator the draw is
    that of a generator seeded 0 on the field's device."""
    amp = torch.linspace(0.5, 2.0, 2**16, dtype=torch.float64)[:, None].repeat(1, 2)
    noise = tamp._ase_noise(amp, torch.Generator().manual_seed(3))
    assert noise.dtype == torch.complex128
    ratio = float(torch.mean(noise.abs() ** 2 / amp**2))
    assert abs(ratio - 1) < 0.02, ratio
    re, im = float(torch.mean((noise.real / amp) ** 2)), float(torch.mean((noise.imag / amp) ** 2))
    assert abs(re - 0.5) < 0.01 and abs(im - 0.5) < 0.01, (re, im)
    sig = cpu(_cw_wdm_signal(n=512))
    cfg = tamp.EDFASMConfig(type="none", lngth=6.0, forPumpW=(30e-3,), bckPumpW=(0.0,),
                            noiseBand=50e9)
    a = tamp.edfa_sm(sig, FS, FC, cfg)
    b = tamp.edfa_sm(sig, FS, FC, cfg, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a[0], b[0])
    out, _, _, noise_amp = tamp.edfa_sm(sig, FS, FC, cfg,
                                        generator=torch.Generator().manual_seed(1))
    with mock.patch.object(tamp, "_ase_noise", _no_ase):
        clean = tamp.edfa_sm(sig, FS, FC, cfg)[0]
    # the output noise per bin: ifft(noise * n) has variance n * mean(noise_amp**2)
    n = sig.shape[0]
    var = float(torch.mean((out - clean).abs() ** 2))
    assert abs(var / (n * float(torch.mean(noise_amp**2))) - 1) < 0.1


@pytest.mark.parametrize("xunits,yunits", [("m", "dBm"), ("Hz", "W")])
def test_get_spectrum_matches_jax(xunits, yunits):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(np.complex64)
    ax_t, sp_t = tamp.get_spectrum(cpu(x), 100e9, FC, xunits, yunits)
    ax_j, sp_j = jamp.get_spectrum(x, 100e9, FC, xunits, yunits)
    np.testing.assert_allclose(to_np(ax_t), ax_j, rtol=F64_REL, atol=0)
    np.testing.assert_allclose(to_np(sp_t), sp_j, rtol=1e-5, atol=1e-5 if yunits == "dBm" else 0)
