"""The port's symbol synchronizer in 'real' mode and ``sync_data_sequences``
against opticommpy_tpu.

Tolerances: the alignments (swaps, quarter turns, conjugation, delays) and
detected symbols equal; the rebuilt reference waveforms within 1e-5
(float32 FFT filtering in another order).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.dsp import synchronization as jsync  # noqa: E402
from opticommpy_tpu.ops import filtering as jfilt  # noqa: E402
from opticommpy_tpu.ops import signal as jsig  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.dsp import synchronization as tsync  # noqa: E402
from opticommpy_torch.ops import signal as tsig  # noqa: E402

from _torch_parity import norm_qam, to_np  # noqa: E402


def _qam_pair(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    return norm_qam(16)[rng.integers(0, 16, size=(n, 2))]


# each case: how the received modes are made from the transmitted ones
REAL_CASES = {
    "swap-turn": lambda tx: np.stack([1j * np.roll(tx[:, 1], 17), -np.roll(tx[:, 0], -5)], 1),
    "conj": lambda tx: np.stack([np.conj(np.roll(tx[:, 0], 3)), -1j * tx[:, 1]], 1),
    "plain": lambda tx: np.roll(tx, 40, axis=0),
}


@pytest.mark.parametrize("sps", [1, 2])
@pytest.mark.parametrize("case", sorted(REAL_CASES))
def test_symbol_sync_real_matches_jax(case, sps):
    tx = _qam_pair()
    rng = np.random.default_rng(1)
    rx = REAL_CASES[case](tx) + 0.05 * (rng.normal(size=tx.shape) + 1j * rng.normal(size=tx.shape))
    rx = np.repeat(rx, sps, axis=0).astype(np.complex64)
    ref = np.asarray(jsig.symbol_sync(rx, tx, sps, mode="real"))
    out = tsig.symbol_sync(torch.as_tensor(rx), torch.as_tensor(tx), sps, mode="real")
    assert out.dtype == torch.complex64
    np.testing.assert_array_equal(to_np(out), ref)
    # the alignment is right: the synchronized reference is the received symbols
    assert np.mean(np.abs(to_np(out) - rx[::sps]) ** 2) < 0.01


def test_symbol_sync_real_on_real_sequences_and_bad_mode():
    rng = np.random.default_rng(2)
    tx = rng.choice([-3.0, -1.0, 1.0, 3.0], size=(1024, 1)).astype(np.float32)
    rx = (-np.roll(tx, 9, axis=0) + 0.1 * rng.normal(size=tx.shape)).astype(np.float32)
    ref = np.asarray(jsig.symbol_sync(rx, tx, 1, mode="real"))
    out = tsig.symbol_sync(torch.as_tensor(rx), torch.as_tensor(tx), 1, mode="real")
    np.testing.assert_array_equal(to_np(out), ref)
    with pytest.raises(ValueError, match="'amp' or 'real'"):
        tsig.symbol_sync(torch.as_tensor(rx), torch.as_tensor(tx), 1, mode="phase")


def _pam_link(n_sym=600, sps=2, seed=3, delay=37):
    """(received waveform at sps, symbols, waveform) for 4-PAM through the
    RRC pulse, the reception delayed and 1.5 times the reference long."""
    rng = np.random.default_rng(seed)
    symb = rng.choice([-3.0, -1.0, 1.0, 3.0], size=(n_sym, 1))
    up = np.zeros((n_sym * sps, 1))
    up[::sps] = symb
    wave = np.asarray(jfilt.fir_filter(jfilt.pulse_shape("rrc", sps, 64, 0.2), up)).real
    rx = np.roll(np.concatenate([wave, wave[: len(wave) // 2]]), delay, axis=0)
    rx = rx + 0.01 * rng.normal(size=rx.shape)
    return rx.astype(np.float32), symb.astype(np.float32), wave.astype(np.float32)


@pytest.mark.parametrize("sync_mode", ["amp", "real"])
@pytest.mark.parametrize("reference", ["symbols", "signal"])
def test_sync_data_sequences_matches_jax(reference, sync_mode):
    rx, symb, wave = _pam_link()
    cfg = jsync.SyncConfig(SpS=2, reference=reference, syncMode=sync_mode, rollOff=0.2,
                           nFilterTaps=64)
    tx = symb if reference == "symbols" else wave
    ref_tx, ref_symb = (np.asarray(a) for a in jsync.sync_data_sequences(rx, tx, cfg))
    out_tx, out_symb = tsync.sync_data_sequences(torch.as_tensor(rx), torch.as_tensor(tx),
                                                 config_from_jax(cfg))
    assert out_tx.shape == ref_tx.shape and out_symb.shape == ref_symb.shape
    assert to_np(out_symb).dtype == ref_symb.dtype
    np.testing.assert_allclose(to_np(out_tx), ref_tx, rtol=0, atol=1e-5 * np.abs(ref_tx).max())
    np.testing.assert_allclose(to_np(out_symb), ref_symb, rtol=0, atol=1e-5)
    if reference == "symbols":  # the zero padding of the symbol column
        n_nz = int(np.count_nonzero(ref_symb[:, 0]))
        assert n_nz < ref_symb.shape[0] and not np.any(to_np(out_symb)[n_nz:])
