"""The slice-6 modules on the card against the same calls on CPU tensors
(this file imports no JAX): ``edfa_sm`` (its FFTs and ASE draw on the card,
its host solver shared), the NLIN contractions, OFDM, checkpoints and
StageTimer. Every test needs a CUDA device and skips without one.

Tolerances: edfa_sm 1e-6 relative with the draw zeroed, the draw's variance
within 2% of noise_amp**2; NLIN 2e-6 relative; OFDM 1e-5 relative.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from opticommpy_torch.comm import ofdm as tofdm
from opticommpy_torch.models import amplification as tamp
from opticommpy_torch.models import perturbation as tpert
from opticommpy_torch.utils import checkpoint as tck
from opticommpy_torch.utils import profiling as tprof

from _torch_parity import cpu, norm_qam, rel_err, require_cuda

pytestmark = pytest.mark.gpu

FS, FC = 400e9, 193.1e12


def _cw_tones(n, p_ch_w=2e-4):
    t = np.arange(n) / FS
    x = sum(np.sqrt(p_ch_w) * np.exp(2j * np.pi * f * t) for f in (-100e9, 0.0, 100e9))
    return np.stack([x, np.zeros_like(x)], axis=1).astype(np.complex64)


def _no_ase(noise_amp, generator):
    return torch.zeros(noise_amp.shape, dtype=torch.complex128, device=noise_amp.device)


def test_edfa_sm_on_cuda_matches_cpu_on_gpu():
    dev = require_cuda()
    sig = cpu(_cw_tones(2**14))
    cfg = tamp.EDFASMConfig(type="AGC", value=10.0, lngth=8.0, forPumpW=(60e-3,),
                            bckPumpW=(0.0,), noiseBand=100e9, tolCtrl=0.5)
    with mock.patch.object(tamp, "_ase_noise", _no_ase):
        got = tamp.edfa_sm(sig.to(dev), FS, FC, cfg)
        want = tamp.edfa_sm(sig, FS, FC, cfg)
    assert all(t.is_cuda for t in got)
    for g, w in zip(got, want):
        if float(w.abs().max()) > 0:
            assert rel_err(g, w) < 1e-6
    amp = got[3]
    noise = tamp._ase_noise(amp, torch.Generator(device=dev).manual_seed(0))
    on = amp > 0
    ratio = float(torch.mean(noise.abs()[on] ** 2 / amp[on] ** 2))
    assert noise.is_cuda and abs(ratio - 1) < 0.02, ratio


def test_nlin_on_cuda_matches_cpu_on_gpu():
    dev = require_cuda()
    rng = np.random.default_rng(7)
    c = norm_qam(16)
    x, y = cpu(c[rng.integers(0, 16, 4096)], c[rng.integers(0, 16, 4096)])
    _, cf, cx, cs = tpert.calc_pert_coeff_matrix(tpert.PerturbationConfig(matrixOrder=25))
    for method in ("fft", "chunk"):
        got = tpert.calc_nlin_perturbation(cf, cx, cs, x.to(dev), y.to(dev), method=method)
        want = tpert.calc_nlin_perturbation(cf, cx, cs, x, y, method=method)
        for g, w in zip(got, want):
            assert g.is_cuda and rel_err(g, w) < 2e-6
    got = tpert.calc_nlin_perturbation_simplified(cf, cx, cs, x.to(dev), y.to(dev), -30.0)
    want = tpert.calc_nlin_perturbation_simplified(cf, cx, cs, x, y, -30.0)
    assert got[4:] == want[4:]
    for g, w in zip(got[:4], want[:4]):
        assert g.is_cuda and rel_err(g, w) < 2e-6


def test_ofdm_on_cuda_matches_cpu_on_gpu():
    dev = require_cuda()
    cfg = tofdm.OFDMConfig(Nfft=256, G=32, SpS=1, pilotCarriers=tuple(range(0, 256, 16)))
    rng = np.random.default_rng(2)
    symb = cpu(norm_qam(16)[rng.integers(0, 16, 240 * 20)])
    sig = tofdm.modulate_ofdm(symb.to(dev), cfg)
    assert sig.is_cuda and rel_err(sig, tofdm.modulate_ofdm(symb, cfg)) < 1e-5
    out, h = tofdm.demodulate_ofdm(sig, cfg, return_channel=True)
    assert out.is_cuda and h.is_cuda and rel_err(out, symb) < 1e-5


def test_checkpoint_and_timer_on_gpu(tmp_path):
    dev = require_cuda()
    x = torch.randn(1024, 2, dtype=torch.complex64, device=dev)
    path = tck.save_state(str(tmp_path / "g.npz"), {"x": x})
    back = tck.load_state(path, like={"x": x})
    assert back["x"].is_cuda and torch.equal(back["x"], x)
    timer = tprof.StageTimer()
    with timer("fft"):
        timer.sync(torch.fft.fft(x, dim=0))
    assert timer.times["fft"] > 0
