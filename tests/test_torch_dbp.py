"""The port's Manakov digital backpropagation against opticommpy_tpu, and the
forward Manakov solver unchanged by the sign it now takes.

Tolerances: relative error <= 1e-4 in complex64 (rounding accumulated over
the split steps); the forward solver equal bit for bit to its rule written
out by hand.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.dsp import equalization as jeq  # noqa: E402
from opticommpy_tpu.models import channels as jch  # noqa: E402
from opticommpy_tpu.models import config as jcfg  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.models import channels as tch  # noqa: E402
from opticommpy_torch.ops.signal import fftfreq  # noqa: E402

from _torch_parity import rel_err, require_cuda, to_np  # noqa: E402
from test_torch_tx_channel import _field  # noqa: E402

FS = 32e9 * 8
DBP_CASES = {
    "fused": dict(nlprMethod=False, trapIters=1, fusedLinear=True, hz=0.5, amp="ideal"),
    "unfused": dict(nlprMethod=False, trapIters=1, hz=0.7, amp="ideal"),
    "adaptive": dict(nlprMethod=True, amp="edfa"),
    "fused-no-amp": dict(nlprMethod=False, trapIters=1, fusedLinear=True, hz=2.0, amp=None),
}
# Without the gain undone, back-propagation raises the power by alpha*Ltotal
# (20 dB here): the input is the attenuated field a receiver would see, since
# at _field()'s own power the result is chaotic in either package.
DBP_SCALE = {"fused-no-amp": 0.1}


@pytest.mark.parametrize("case", sorted(DBP_CASES))
def test_manakov_dbp_matches_jax(case):
    cfg = jcfg.SSFMConfig(Ltotal=100, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fs=FS,
                          **DBP_CASES[case])
    x = (DBP_SCALE.get(case, 1.0) * _field()).astype(np.complex64)
    ref = np.asarray(jeq.manakov_dbp(x, cfg))
    out = teq.manakov_dbp(torch.as_tensor(x), config_from_jax(cfg))
    assert out.dtype == torch.complex64 and out.shape == ref.shape
    assert rel_err(out, ref) <= 1e-4, rel_err(out, ref)


def test_manakov_dbp_is_complex64_whatever_prec_says():
    cfg = jcfg.SSFMConfig(Ltotal=50, Lspan=50, hz=5.0, alpha=0.2, D=16, Fs=FS, amp="ideal",
                          nlprMethod=False, trapIters=1, fusedLinear=True, prec="c128")
    x = _field(2**10)
    ref = np.asarray(jeq.manakov_dbp(x, cfg))
    out = teq.manakov_dbp(torch.as_tensor(x), config_from_jax(cfg))
    assert ref.dtype == np.complex64 and out.dtype == torch.complex64
    assert rel_err(out, ref) <= 1e-4


def test_manakov_dbp_undoes_manakov_ssf_as_jax_does():
    """Forward then back at low power with ideal gain: the port's round trip
    within 1e-4 of the JAX package's, and both near the input."""
    kw = dict(Ltotal=100, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3, Fs=FS, amp="ideal",
              nlprMethod=False, trapIters=1, fusedLinear=True)
    cfg = jcfg.SSFMConfig(**kw)
    x = (0.1 * _field()).astype(np.complex64)
    ref = np.asarray(jeq.manakov_dbp(jch.manakov_ssf(x, cfg), cfg))
    tcfg = config_from_jax(cfg)
    out = teq.manakov_dbp(tch.manakov_ssf(torch.as_tensor(x), tcfg), tcfg)
    assert rel_err(out, ref) <= 1e-4, rel_err(out, ref)
    assert rel_err(out, x) <= 1e-3 and rel_err(ref, x) <= 1e-3


def _lin_arg(n, cfg):
    alpha, beta2 = tch.fiber_coefficients(cfg.alpha, cfg.D, cfg.Fc)
    w = (2 * np.pi * cfg.Fs) * fftfreq(n, 1.0, torch.float32)
    return alpha, torch.complex(torch.full_like(w, -(alpha / 2)), (beta2 / 2) * (w * w))


@pytest.mark.parametrize("fused", [True, False])
def test_manakov_ssf_equals_its_forward_rule_bit_for_bit(fused):
    """The nonlinear sign leaves the forward solver's bits as they were: its
    output equals the forward split-step rule written out here."""
    cfg = tch.SSFMConfig(Ltotal=100, Lspan=50, hz=2.0, alpha=0.2, D=16, gamma=1.3, Fs=FS,
                         amp="ideal", nlprMethod=False, trapIters=1, fusedLinear=fused)
    x = torch.as_tensor(_field(2**11).astype(np.complex64))
    alpha, lin_arg = _lin_arg(x.shape[0], cfg)
    fft, ifft = (lambda a: torch.fft.fft(a, dim=-1)), (lambda a: torch.fft.ifft(a, dim=-1))
    e = torch.stack([x[:, 0::2].T, x[:, 1::2].T]).contiguous()
    n_steps = int(cfg.Lspan / cfg.hz)
    for _ in range(2):
        if fused:
            ef = fft(e) * torch.exp(lin_arg * (cfg.hz / 2))
            gaps = [torch.exp(lin_arg * cfg.hz)] * (n_steps - 1) + [
                torch.exp(lin_arg * (cfg.hz / 2))]
            for lin_gap in gaps:
                et = ifft(ef)
                pch = torch.sum((et * et.conj()).real, dim=0)
                ef = fft(et * torch.exp(1j * (((8 / 9) * cfg.gamma * cfg.hz) * pch))) * lin_gap
            e = ifft(ef)
        else:
            lin_op = torch.exp(lin_arg * (cfg.hz / 2))
            for _ in range(n_steps):
                pch = torch.sum(torch.abs(e) ** 2, dim=0)
                e_hd = ifft(fft(e) * lin_op)
                phi = tch.nlin_phase_rot(e[0], e[1], pch, cfg.gamma)
                e = ifft(fft(e_hd * torch.exp(1j * (phi * cfg.hz))) * lin_op)
        e = e * float(np.exp(alpha / 2 * cfg.Lspan))
    assert torch.equal(tch.manakov_ssf(x, cfg), tch._to_columns(e))


@pytest.mark.gpu
def test_manakov_ssf_and_dbp_on_cuda_match_cpu_on_gpu():
    dev = require_cuda()
    cfg = tch.SSFMConfig(Ltotal=50, Lspan=50, hz=0.25, alpha=0.2, D=16, gamma=1.3, Fs=FS,
                         amp="ideal", nlprMethod=False, trapIters=1, fusedLinear=True)
    x = torch.as_tensor(_field(2**14).astype(np.complex64))
    for fn in (tch.manakov_ssf, teq.manakov_dbp):
        out = fn(x.to(dev), cfg)
        assert out.is_cuda and rel_err(out, fn(x, cfg)) <= 1e-4
    assert to_np(out).dtype == np.complex64
