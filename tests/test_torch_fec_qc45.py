"""The port's quasi-cyclic DVB-S2 decoder on its plain roll route ('xla')
against the JAX package's XLA route at R4/5, the serving code rate
(R3/5 and the other routes: test_torch_fec_qc.py).

Tolerance (tests/test_fec.py:248-273): iteration counts, fail flags and
hard decisions equal, totals within 1e-5 of the largest (float32 sums of
the check messages in another order).
"""

import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import fec_qc as jqc  # noqa: E402
from opticommpy_torch.comm import fec_qc as tqc  # noqa: E402

from _torch_parity import assert_qc_decodes_alike, to_np, zero_codeword_llrs  # noqa: E402


@pytest.mark.parametrize("mdt,alg", [("f32", "NMSA"), ("bf16", "MSA")])
def test_xla_route_matches_jax_r45(mdt, alg):
    llr = zero_codeword_llrs(17, (7.0, 3.5, 2.8, 0.0))
    out_j = jqc.make_qc_decoder(64800, "4/5", 5, alg, mdt, backend="xla")(jnp.asarray(llr))
    out_t = tqc.make_qc_decoder(64800, "4/5", 5, alg, mdt, backend="xla")(torch.as_tensor(llr))
    assert 0 < int(to_np(out_t[1]).min()) < 5  # a column converged early
    assert bool(out_t[2].any())  # and one did not
    assert_qc_decodes_alike(out_t, out_j)
