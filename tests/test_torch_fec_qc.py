"""The port's quasi-cyclic DVB-S2 decoder on its plain roll route ('xla')
against the JAX package's XLA route at R3/5, the K8 route ('pallas') and
early exit.

Tolerances (tests/test_fec.py:248-299):
- 'xla' against JAX ``backend="xla"``: iteration counts and fail flags
  equal, hard decisions equal, totals within 1e-5 of the largest
  (float32 sums of the check messages in another order).
- 'pallas' (K8's plain version on the CPU) against 'xla': bit-identical.
- early exit against the fixed loop: bit-identical, on both routes.
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


@pytest.mark.parametrize("mdt,alg", [("f32", "MSA"), ("bf16", "NMSA")])
def test_xla_route_matches_jax(mdt, alg):
    """R3/5 (R4/5: test_torch_fec_qc45.py; one file each keeps each file's
    JAX compilations short)."""
    llr = zero_codeword_llrs(7, (8.0, 4.0, 2.5, -1.0))
    out_j = jqc.make_qc_decoder(64800, "3/5", 5, alg, mdt, backend="xla")(jnp.asarray(llr))
    out_t = tqc.make_qc_decoder(64800, "3/5", 5, alg, mdt, backend="xla")(torch.as_tensor(llr))
    assert 0 < int(to_np(out_t[1]).min()) < 5  # a column converged early
    assert_qc_decodes_alike(out_t, out_j)


def test_auto_on_the_cpu_is_the_xla_route():
    llr = torch.as_tensor(zero_codeword_llrs(8, (6.0, 1.0)))
    a = tqc.make_qc_decoder(64800, "4/5", 4, "NMSA", "bf16")(llr)
    b = tqc.make_qc_decoder(64800, "4/5", 4, "NMSA", "bf16", backend="xla")(llr)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mdt,alg", [("f32", "MSA"), ("bf16", "NMSA")])
def test_pallas_route_equals_xla_route(mdt, alg):
    llr = torch.as_tensor(zero_codeword_llrs(9, (5.0, 2.5, 0.0)))
    a = tqc.make_qc_decoder(64800, "4/5", 6, alg, mdt, backend="pallas")(llr)
    b = tqc.make_qc_decoder(64800, "4/5", 6, alg, mdt, backend="xla")(llr)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_early_exit_identical_outputs(backend):
    """tests/test_fec.py:276-299 on the port: encoded codewords at Es/N0
    3.5 dB, MSA-20; early exit gives the fixed loop's outputs bit for bit."""
    graph, edges = tfec.standard_ldpc("DVBS2", 64800, "4/5")
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=(64800 - 12960, 2)).astype(np.int8)
    cw = to_np(tfec.encode_ldpc(torch.as_tensor(bits), edges=edges))
    sigma = np.sqrt(0.5 * 10 ** (-3.5 / 10))
    y = (1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    llr = torch.as_tensor((2 * y / sigma**2).astype(np.float32))
    fixed = tqc.make_qc_decoder(64800, "4/5", 20, "MSA", "f32", False, backend)(llr)
    early = tqc.make_qc_decoder(64800, "4/5", 20, "MSA", "f32", True, backend)(llr)
    for x, y in zip(fixed, early):
        assert torch.equal(x, y)
    assert not fixed[2].any()  # the batch converged
    assert int(fixed[1].max()) < 20
    np.testing.assert_array_equal(to_np(fixed[0] < 0).astype(np.int8), cw)
    dec, _, fail = tfec.decode_ldpc(llr, graph=graph, config=tfec.LDPCConfig(
        maxIter=20, alg="MSA", earlyExit=True))
    np.testing.assert_array_equal(to_np(dec), cw)
    assert not fail.any()


def test_spa_decodes_on_the_xla_route():
    """SPA runs the plain route everywhere ('auto' on CUDA too)."""
    llr = torch.as_tensor(zero_codeword_llrs(12, (4.0, 6.0), n=64800))
    out, n_iters, fail = tqc.make_qc_decoder(64800, "9/10", 10, "SPA", "f32")(llr)
    assert not fail.any() and bool((out > 0).all())
    assert int(n_iters.max()) < 10
