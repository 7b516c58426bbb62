"""The port's layered (serial-C) schedule, K11's plain version on the CPU,
against the JAX package's megakernel with ``schedule="layered"`` in
interpret mode and against the plain-NumPy oracle of tests/test_fec.py;
the layered routes and errors.

Tolerances:
- float32 messages: exact (the same float32 operations in the same column
  and slot order; tests/test_fec.py:639-658 holds the JAX megakernel to the
  oracle exactly too).
- bfloat16 messages: iteration counts, fail flags and signs equal, totals
  within 2e-3 of the largest, the JAX package's bound for its megakernel at
  bf16 (tests/test_fec.py:489). The rounding points are the same (x and the
  new message rounded to bf16), so the two agree exactly on these draws;
  the tolerance is the bound the test holds them to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import fec_qc as jqc  # noqa: E402
from opticommpy_torch.comm import fec as tfec  # noqa: E402
from opticommpy_torch.comm import fec_qc as tqc  # noqa: E402

from _torch_parity import assert_qc_decodes_alike, to_np, zero_codeword_llrs  # noqa: E402
from test_fec import _layered_bp_oracle  # noqa: E402


def _llrs(B=128, seed=31):
    """tests/test_fec.py:649's draws (1.4 + N(0, 1.5^2)) and all-zero
    codewords at 4.5 to 9 dB that converge at different sweeps."""
    rng = np.random.default_rng(seed)
    strong = zero_codeword_llrs(seed, (9.0, 6.0, 5.0, 4.8, 4.6, 4.5))
    noisy = (1.4 + rng.normal(scale=1.5, size=(64800, B - strong.shape[1]))).astype(np.float32)
    return np.concatenate([noisy, strong], axis=1)


@pytest.mark.parametrize("mdt", ["f32", "bf16"])
def test_layered_matches_jax_megakernel_r910(mdt):
    """R9/10, B = 128 (the JAX megakernel's tile), NMSA, 3 iterations."""
    llr = _llrs()
    out_j = jqc.make_qc_decoder(64800, "9/10", 3, "NMSA", mdt, backend="mega",
                                schedule="layered")(jnp.asarray(llr))
    out_t = tqc.make_qc_decoder(64800, "9/10", 3, "NMSA", mdt, backend="mega",
                                schedule="layered")(torch.as_tensor(llr))
    it = to_np(out_t[1])
    assert it.max() == 3 and it.min() < 3  # some codewords froze early
    if mdt == "f32":
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
    else:
        assert_qc_decodes_alike(out_t, out_j, rel=2e-3)


@pytest.mark.parametrize("R,alpha", [("4/5", 0.75), ("1/4", None)])
def test_layered_matches_the_numpy_oracle(R, alpha):
    """The oracle of tests/test_fec.py:552-636 at another rate and with MSA."""
    tb = tqc.qc_tables(R, 64800)
    llr = _llrs(B=6, seed=5)
    if R == "1/4":
        llr = llr - 1.2
    out_o = _layered_bp_oracle(tb, llr, 2, alpha=alpha)
    out_t = tqc.make_qc_decoder(64800, R, 2, "NMSA" if alpha else "MSA", "f32",
                                backend="mega", schedule="layered")(torch.as_tensor(llr))
    for a, b in zip(out_t, out_o):
        np.testing.assert_array_equal(to_np(a), b)


def test_layered_early_exit_equals_fixed_and_beats_flooding():
    llr = torch.as_tensor(zero_codeword_llrs(8, (4.4, 4.6, 5.0, 6.0)))
    fixed = tqc.make_qc_decoder(64800, "9/10", 8, "NMSA", "bf16", backend="mega",
                                schedule="layered")(llr)
    early = tqc.make_qc_decoder(64800, "9/10", 8, "NMSA", "bf16", True, backend="mega",
                                schedule="layered")(llr)
    flood = tqc.make_qc_decoder(64800, "9/10", 8, "NMSA", "bf16", backend="mega")(llr)
    for a, b in zip(fixed, early):
        assert torch.equal(a, b)
    assert not bool(fixed[2].any()) and not bool(flood[2].any())
    assert bool((fixed[0] > 0).all())  # the all-zero codeword
    assert float(fixed[1].float().mean()) < float(flood[1].float().mean())


def test_layered_errors_match_jax():
    """Where the JAX package raises on the layered schedule, the port raises
    the same class: an unknown schedule; layered on a backend other than
    'mega' or 'auto'; layered with SPA on 'auto'; layered on 'auto' with
    CPU tensors (the JAX package refuses it on a CPU backend when the
    decoder is built, the port when it is called with CPU tensors);
    layered on a graph that is not DVB-S2."""
    for mod in (tqc, jqc):
        with pytest.raises(ValueError, match="unknown schedule"):
            mod.make_qc_decoder(64800, "4/5", 5, "MSA", "bf16", schedule="zigzag")
        for backend in ("fused", "xla", "pallas"):
            with pytest.raises(ValueError, match="megakernel only"):
                mod.make_qc_decoder(64800, "4/5", 5, "NMSA", "bf16", backend=backend,
                                    schedule="layered")
        with pytest.raises(ValueError, match="needs the megakernel"):
            mod.make_qc_decoder(64800, "4/5", 5, "SPA", "bf16", schedule="layered")
    with pytest.raises(ValueError, match="needs the megakernel"):
        jqc.make_qc_decoder(64800, "4/5", 5, "NMSA", "bf16", schedule="layered")
    dec = tqc.make_qc_decoder(64800, "4/5", 5, "NMSA", "bf16", schedule="layered")
    with pytest.raises(ValueError, match="needs the megakernel"):
        dec(torch.ones((64800, 2)))
    graph, _ = tfec.standard_ldpc("DVBS2", 64800, "4/5")
    with pytest.raises(ValueError, match="needs the megakernel"):
        tfec.decode_ldpc(torch.ones((64800, 1)), graph=graph,
                         config=tfec.LDPCConfig(alg="NMSA", schedule="layered"))
    lift, _ = tfec.standard_ldpc("AR4JA", 2048, "1/2")
    with pytest.raises(ValueError, match="DVB-S2"):
        tfec.decode_ldpc(torch.ones((2048, 1)), graph=lift,
                         config=tfec.LDPCConfig(schedule="layered"))
