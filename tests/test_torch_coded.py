"""The coded coherent receiver of the port, ``coherent_coded_serve``, against
the JAX package's: coherent_dsp_serve -> bit LLRs -> LDPC decoding.

Tolerances:
- decided bits and fail flags equal to JAX's.
- served symbols within 1e-4 of JAX's on all but 1% of them (a BPS
  near-tie turns a symbol by a test-phase step; tests/test_torch_serve.py),
  and within 1e-4 relative in norm over the symbols that no such tie moved
  (those that differ by less than half a test-phase step's turn).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import codes as jcodes  # noqa: E402
from opticommpy_tpu.comm import fec as jfec  # noqa: E402
from opticommpy_tpu.comm.modulation import modulate_gray  # noqa: E402
from opticommpy_tpu.ops.filtering import fir_filter, pulse_shape  # noqa: E402
from opticommpy_tpu.ops.signal import upsample  # noqa: E402
from opticommpy_tpu.pipelines import CoherentDSPConfig  # noqa: E402
from opticommpy_tpu.pipelines import coherent_coded_serve as jax_coded_serve  # noqa: E402
from opticommpy_torch import pipelines as tpipe  # noqa: E402
from opticommpy_torch.comm import fec as tfec  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402

from _torch_parity import to_np  # noqa: E402

SYM_ATOL = 1e-4
SYM_REL = 1e-4


def _loopback(stream, n_sym, seed, noise=0.02, sps=2, taps=257):
    """(signal (n_sym*sps, 2) complex64, symbol grid (n_sym, 2)): the bit
    stream Gray-mapped to 16-QAM, framed mode-major, RRC-shaped at ``sps``
    with AWGN (tests/test_pipelines.py:423-432)."""
    rng = np.random.default_rng(seed)
    syms = np.asarray(modulate_gray(jnp.asarray(stream), 16, "qam"))
    grid = syms.reshape(2, n_sym).T  # mode-major framing of the serve
    pulse = jnp.asarray(pulse_shape("rrc", sps, taps, 0.01))
    wav = np.asarray(fir_filter(pulse, upsample(jnp.asarray(grid), sps)))
    wav = wav + noise * (rng.normal(size=wav.shape) + 1j * rng.normal(size=wav.shape))
    return wav.astype(np.complex64), grid


def _pilots(grid, n=64):
    return (grid[:n] / np.sqrt(np.mean(np.abs(grid) ** 2))).astype(np.complex64)[None]


def _identity_taps():
    H = np.zeros((1, 2, 2, 15), np.complex64)
    H[:, 0, 0, 7] = H[:, 1, 1, 7] = 1
    return H


def _assert_symbols_close(out_t, out_j, n_phases):
    a, b = to_np(out_t), np.asarray(out_j)
    d = np.abs(a - b)
    assert np.mean(d > SYM_ATOL) < 0.01, np.mean(d > SYM_ATOL)
    # a near-tie moves a symbol by a whole test-phase step of the
    # quarter-turn search: |d| ~ step |b|
    untied = d < 0.5 * (np.pi / 2 / n_phases) * np.abs(b)
    rel = np.linalg.norm(d[untied]) / np.linalg.norm(b[untied])
    assert rel < SYM_REL, rel


@pytest.fixture(scope="module")
def wifi_case():
    """tests/test_pipelines.py:390-452: 802.11n 648b R1/2 (generator
    encoding), 1024 symbols x 2 modes, 12 codewords + tail."""
    H = jcodes.ldpc_parity_matrix(mode="IEEE_802.11nD2", n=648, R="1/2")
    rng = np.random.default_rng(9)
    n_sym, nbits = 1024, 1024 * 2 * 4
    ncw = nbits // 648
    msg = rng.integers(0, 2, size=(324, ncw))
    G, _, Hm = jfec.par2gen(H)
    cw = np.asarray(jfec.encode_ldpc(jnp.asarray(msg), H=Hm, config=jfec.LDPCConfig(mode="G"),
                                     G=G))
    stream = np.concatenate([cw.T.reshape(-1), rng.integers(0, 2, size=nbits - 648 * ncw)])
    wav, grid = _loopback(stream, n_sym, 9)
    cfg = CoherentDSPConfig(nFilterTaps=257, L=0.5, cpr_window=33, cpr_phases=32, M=16)
    return dict(Hm=Hm, cw=cw, wav=wav, grid=grid, cfg=cfg, ncw=ncw)


def test_coded_serve_wifi_loopback_matches_jax(wifi_case):
    c = wifi_case
    bits_j, fail_j, out_j = jax_coded_serve(
        jnp.asarray(c["wav"])[None], jnp.asarray(_identity_taps()), c["cfg"], 0.05,
        fec_graph=jfec.ldpc_graph(c["Hm"]), fec_config=jfec.LDPCConfig(maxIter=30, alg="NMSA"),
        pilot_grid=jnp.asarray(_pilots(c["grid"])))
    bits_t, fail_t, out_t = tpipe.coherent_coded_serve(
        torch.as_tensor(c["wav"])[None], torch.as_tensor(_identity_taps()),
        config_from_jax(c["cfg"]), 0.05, fec_graph=tfec.ldpc_graph(c["Hm"]),
        fec_config=tfec.LDPCConfig(maxIter=30, alg="NMSA"),
        pilot_grid=torch.as_tensor(_pilots(c["grid"])))
    assert tuple(bits_t.shape) == (648, c["ncw"]) and bits_t.dtype == torch.int8
    assert tuple(out_t.shape) == (1, 1024, 2)
    np.testing.assert_array_equal(to_np(fail_t), np.asarray(fail_j))
    np.testing.assert_array_equal(to_np(bits_t), np.asarray(bits_j))
    _assert_symbols_close(out_t, out_j, c["cfg"].cpr_phases)
    clean = [1, 2, 3, 4, 8, 9, 10]  # clear of the filter edges
    assert to_np(fail_t)[clean].sum() == 0
    np.testing.assert_array_equal(to_np(bits_t)[:, clean], c["cw"][:, clean])


def test_rotated_mode_decodes_with_pilots(wifi_case):
    """A quarter turn of one (signal, mode) is undone by the pilots; a single
    (N, modes) signal returns (nSym, modes) symbols."""
    c = wifi_case
    kw = dict(fec_graph=tfec.ldpc_graph(c["Hm"]), fec_config=tfec.LDPCConfig(maxIter=30,
                                                                               alg="NMSA"))
    cfg = config_from_jax(c["cfg"])
    base = tpipe.coherent_coded_serve(torch.as_tensor(c["wav"]),
                                      torch.as_tensor(_identity_taps()[0]), cfg, 0.05,
                                      pilot_grid=torch.as_tensor(_pilots(c["grid"])[0]), **kw)
    wav = c["wav"].copy()
    wav[:, 1] *= 1j
    bits, fail, out = tpipe.coherent_coded_serve(
        torch.as_tensor(wav), torch.as_tensor(_identity_taps()[0]), cfg, 0.05,
        pilot_grid=torch.as_tensor(_pilots(c["grid"])[0]), **kw)
    assert tuple(out.shape) == (1024, 2)
    assert torch.equal(fail, base[1]) and torch.equal(bits, base[0])
    assert float((out - base[2]).abs().max()) < SYM_ATOL
    clean = [1, 2, 3, 4, 8, 9, 10]
    np.testing.assert_array_equal(to_np(bits)[:, clean], c["cw"][:, clean])


def test_coded_serve_dvbs2_loopback_matches_jax():
    """DVB-S2 64800b R4/5: one signal of 16,384 symbols x 2 modes holds 2
    codewords; the JAX package decodes with a fixed loop, the port with
    its default config (NMSA-20, bf16 messages, early exit) and with the
    fixed loop."""
    graph_j, edges = jfec.standard_ldpc("DVBS2", 64800, "4/5")
    rng = np.random.default_rng(31)
    n_sym = 16384
    msg = rng.integers(0, 2, size=(51840, 2))
    cw = np.asarray(jfec.encode_ldpc(jnp.asarray(msg), edges=edges))
    stream = np.concatenate([cw.T.reshape(-1), rng.integers(0, 2, size=n_sym * 8 - 2 * 64800)])
    wav, grid = _loopback(stream, n_sym, 31, noise=0.05)
    cfg = CoherentDSPConfig(nFilterTaps=257, L=0.5, cpr_window=33, cpr_phases=32, M=16)
    pilots = _pilots(grid)
    fixed = dict(maxIter=20, alg="NMSA", msgDtype="bf16", earlyExit=False)
    bits_j, fail_j, out_j = jax_coded_serve(
        jnp.asarray(wav)[None], jnp.asarray(_identity_taps()), cfg, 0.05, fec_graph=graph_j,
        fec_config=jfec.LDPCConfig(**fixed), pilot_grid=jnp.asarray(pilots))
    assert np.asarray(fail_j).tolist() == [0, 0]
    np.testing.assert_array_equal(np.asarray(bits_j), cw)
    for fec_config in (None, tfec.LDPCConfig(**fixed)):
        bits_t, fail_t, out_t = tpipe.coherent_coded_serve(
            torch.as_tensor(wav)[None], torch.as_tensor(_identity_taps()),
            config_from_jax(cfg), 0.05, fec_config=fec_config,
            pilot_grid=torch.as_tensor(pilots))
        np.testing.assert_array_equal(to_np(fail_t), np.asarray(fail_j))
        np.testing.assert_array_equal(to_np(bits_t), np.asarray(bits_j))
        _assert_symbols_close(out_t, out_j, cfg.cpr_phases)


def test_below_one_codeword_raises():
    rng = np.random.default_rng(4)
    sig = (0.3 * (rng.normal(size=(2**11, 2)) + 1j * rng.normal(size=(2**11, 2)))
           ).astype(np.complex64)
    cfg = tpipe.CoherentDSPConfig(nFilterTaps=64, L=20, cpr_window=17, cpr_phases=16)
    with pytest.raises(ValueError, match="one length-64800 codeword"):
        tpipe.coherent_coded_serve(torch.as_tensor(sig), torch.as_tensor(_identity_taps()[0]),
                                   cfg)
