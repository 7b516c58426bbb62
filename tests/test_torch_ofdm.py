"""The port's OFDM modulator and demodulator (opticommpy_torch.comm.ofdm)
against the JAX package's on the same seeded NumPy inputs (CPU tensors).

Tolerance: 1e-5 relative (complex64 FFTs of two libraries); the carrier
layout, the frame count and the Hermitian-symmetric spectrum exactly.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import ofdm as jofdm  # noqa: E402
from opticommpy_torch.comm import ofdm as tofdm  # noqa: E402

from _torch_parity import cpu, norm_qam, rel_err, to_np  # noqa: E402

REL = 1e-5
PILOTS = (0, 9, 18, 27, 36, 45, 54, 63)
NULLS = (30, 31, 33)


def _cfgs(**kw):
    return jofdm.OFDMConfig(**kw), tofdm.OFDMConfig(**kw)


def _symbols(seed, cfg):
    ns, pilots, nulls, data = jofdm._carrier_sets(cfg)
    rng = np.random.default_rng(seed)
    return norm_qam(16)[rng.integers(0, 16, size=5 * data.size)]


CASES = {
    "plain": dict(Nfft=64, G=8, SpS=1),
    "pilots": dict(Nfft=64, G=16, SpS=1, pilotCarriers=PILOTS),
    "pilots-nulls": dict(Nfft=64, G=16, SpS=1, pilotCarriers=PILOTS, nullCarriers=NULLS),
    "one-pilot": dict(Nfft=64, G=8, SpS=1, pilotCarriers=(20,)),
    "hermitian": dict(Nfft=64, G=4, SpS=1, hermitSymmetry=True),
    "hermitian-pilots": dict(Nfft=64, G=4, SpS=1, hermitSymmetry=True,
                             pilotCarriers=(0, 10, 20, 30)),
    "sps2": dict(Nfft=64, G=8, SpS=2, pilotCarriers=PILOTS),
    "sps4-hermitian": dict(Nfft=64, G=4, SpS=4, hermitSymmetry=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_modulate_matches_jax(name):
    jc, tc = _cfgs(**CASES[name])
    symb = _symbols(1, jc)
    want = np.asarray(jofdm.modulate_ofdm(symb, jc))
    got = tofdm.modulate_ofdm(cpu(symb), tc)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert rel_err(got, want) < REL
    if jc.hermitSymmetry:
        assert np.abs(to_np(got).imag).max() < 1e-5 * np.abs(want).max()


def _channel(sig, seed):
    """A short dispersive FIR plus a little noise (complex64 NumPy)."""
    rng = np.random.default_rng(seed)
    h = np.array([1.0, 0.25 - 0.1j, 0.08j])
    out = np.convolve(sig, h)[:sig.size]
    out = out + 1e-3 * (rng.normal(size=sig.size) + 1j * rng.normal(size=sig.size))
    return out.astype(np.complex64)


@pytest.mark.parametrize("return_channel", [False, True], ids=["symbols", "channel"])
@pytest.mark.parametrize("name", sorted(k for k in CASES if CASES[k]["SpS"] == 1))
def test_demodulate_matches_jax(name, return_channel):
    jc, tc = _cfgs(**CASES[name])
    rx = _channel(np.asarray(jofdm.modulate_ofdm(_symbols(2, jc), jc)), 3)
    want = jofdm.demodulate_ofdm(rx, jc, return_channel=return_channel)
    got = tofdm.demodulate_ofdm(cpu(rx), tc, return_channel=return_channel)
    if return_channel:
        (got, h_got), (want, h_want) = got, want
        if jc.pilotCarriers:
            assert rel_err(h_got, np.asarray(h_want)) < REL
        else:
            assert h_got is None and h_want is None
    assert rel_err(got, np.asarray(want)) < REL


def test_round_trip_and_errors():
    _, tc = _cfgs(**CASES["pilots-nulls"])
    jc = jofdm.OFDMConfig(**CASES["pilots-nulls"])
    symb = _symbols(4, jc)
    back = tofdm.demodulate_ofdm(tofdm.modulate_ofdm(cpu(symb), tc), tc)
    assert rel_err(back, symb) < REL
    with pytest.raises(ValueError, match="not divisible"):
        tofdm.modulate_ofdm(cpu(symb[:-1]), tc)
    with pytest.raises(ValueError, match="not divisible"):
        tofdm.demodulate_ofdm(cpu(np.zeros(100, np.complex64)), tc)


def test_helpers_match_jax():
    rng = np.random.default_rng(5)
    v = (rng.normal(size=(3, 7)) + 1j * rng.normal(size=(3, 7))).astype(np.complex64)
    np.testing.assert_array_equal(to_np(tofdm.hermit(cpu(v))), np.asarray(jofdm.hermit(v)))
    np.testing.assert_array_equal(to_np(tofdm.zero_pad(cpu(v[0]), 3)),
                                  np.asarray(jofdm.zero_pad(v[0], 3)))
    for args in ((16, 100e9, 512, 8, 32, False), (4, 50e9, 256, 4, 16, True)):
        assert tofdm.calc_symbol_rate(*args) == jofdm.calc_symbol_rate(*args)
