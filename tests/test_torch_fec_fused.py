"""The fused QC decoder route of the port (K9 + K10; on the CPU their plain
versions) against the JAX package's XLA route, and the three LDPC kernels
on the card.

Tolerances:
- fused route against JAX ``backend="xla"`` (tests/test_fec.py:433-459,
  the JAX package's own fused-vs-XLA pin): iteration counts, fail flags
  and signs equal, totals within 1e-5 of the largest.
- K8, K9 and K10 on the card against their plain versions: bit-identical
  (min, sign, one subtraction and one multiply on the check side; adds in
  one fixed order on the variable side).
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import fec_qc as jqc  # noqa: E402
from opticommpy_torch.comm import fec as tfec  # noqa: E402
from opticommpy_torch.comm import fec_qc as tqc  # noqa: E402
from opticommpy_torch.kernels import _build  # noqa: E402
from opticommpy_torch.kernels import ldpc as tldpc  # noqa: E402
from opticommpy_torch.kernels import qc as tqck  # noqa: E402

from _torch_parity import (assert_qc_decodes_alike, require_cuda, to_np,  # noqa: E402
                           zero_codeword_llrs)


def _llrs(case, strong=True):
    """The LLRs of case ``case`` of tests/test_fec.py:443-448 (its draws in
    its order, B = 4), and a fifth column of the all-zero codeword at 9 dB
    that converges in the first iteration (the delayed vote freezes it).
    Columns decode independently."""
    rng = np.random.default_rng(3)
    for _ in range(case + 1):
        llr = (1.2 + rng.normal(scale=1.6, size=(64800, 4))).astype(np.float32)
    if strong:
        llr = np.concatenate([llr, zero_codeword_llrs(3, (9.0,))], axis=1)
    return llr


@pytest.mark.parametrize("case,R,mdt", [(0, "9/10", "f32"), (1, "9/10", "bf16"),
                                       (2, "1/4", "f32")])
def test_fused_route_matches_jax_xla(case, R, mdt):
    llr = _llrs(case)
    out_j = jqc.make_qc_decoder(64800, R, 3, "MSA", mdt, backend="xla")(jnp.asarray(llr))
    with mock.patch.object(tqck, "check_column_plain", wraps=tqck.check_column_plain) as k9, \
            mock.patch.object(tqck, "var_totals_plain", wraps=tqck.var_totals_plain) as k10:
        out_t = tqc.make_qc_decoder(64800, R, 3, "MSA", mdt, backend="fused")(
            torch.as_tensor(llr))
    assert k9.call_count == k10.call_count == 4  # maxIter + 1 steps
    assert to_np(out_t[1]).tolist() == [3, 3, 3, 3, 1]
    assert_qc_decodes_alike(out_t, out_j)


# -- the kernels on the card --------------------------------------------------

def _fused_state(dev, R, mdt, B=5, steps=2, seed=5):
    """(layout, Tc, Tpc, M, llr_info, fT, freeze) after ``steps`` fused steps
    (NMSA) on the kernels' plain versions, of noisy all-zero-codeword LLRs on
    ``dev``."""
    tb = tqc.qc_tables(R, 64800)
    lay = tqck.QCLayout(tb, dev)
    llr = torch.as_tensor(_llrs(seed % 3)[:, :B], device=dev)
    llr_info, llr_p, c = tqc.fused_init(tb, llr, mdt)
    for kk in range(steps):
        tqc.fused_step(c, llr_info, llr_p, lay, 0.75, kk, 21, plain=True)
    return lay, c["Tc"], c["Tpc"], c["M"], llr_info, c["fT"], c["done"].clone()


@pytest.mark.gpu
@pytest.mark.parametrize("alpha", [None, 0.75], ids=["msa", "nmsa"])
@pytest.mark.parametrize("mdt", ["f32", "bf16"])
def test_k8_matches_plain_on_gpu(mdt, alpha):
    dev = require_cuda()
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.normal(size=(18, 36, 360, 40)).astype(np.float32), device=dev)
    x[:, 0, :3] = 0.0
    x[2:5, 1, 4] = 0.5
    x[17, 0, 0] = float("inf")
    x = x.to(torch.bfloat16 if mdt == "bf16" else torch.float32)
    before = tldpc.launches
    out = tldpc.check_update_msa(x, alpha)
    assert tldpc.launches == before + 1
    ref = tldpc.check_update_msa_plain(x, alpha)
    torch.cuda.synchronize()
    assert out.dtype == x.dtype and torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("mdt", ["f32", "bf16"])
@pytest.mark.parametrize("R", ["4/5", "9/10", "1/4"])
def test_k9_k10_match_plain_on_gpu(R, mdt):
    dev = require_cuda()
    lay, Tc, Tpc, M, llr_info, fT, freeze = _fused_state(dev, R, mdt)
    freeze[::3] = True
    k9, k10 = tqck.check_launches, tqck.var_launches
    M_k, ok_k = tqck.check_column_update(Tc, Tpc, M, lay, 0.75)
    M_p, ok_p = tqck.check_column_plain(Tc, Tpc, M, lay, 0.75)
    bf16 = mdt == "bf16"
    outs_k = tqck.var_totals_update(M_k, llr_info, fT, freeze, lay, msg_copy=bf16)
    outs_p = tqck.var_totals_plain(M_k, llr_info, fT, freeze, lay, msg_copy=bf16)
    torch.cuda.synchronize()
    assert (tqck.check_launches, tqck.var_launches) == (k9 + 1, k10 + 1)
    assert torch.equal(M_k, M_p) and torch.equal(ok_k, ok_p)
    for a, b in zip(outs_k, outs_p):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_decode_launches_the_kernels_and_no_plain_path():
    dev = require_cuda()
    lib = _build.load_library()
    llr = torch.as_tensor(zero_codeword_llrs(23, (5.0, 2.8, 0.0)), device=dev)
    graph, _ = tfec.standard_ldpc("DVBS2", 64800, "4/5")
    plain = [mock.patch.object(tqck, "check_column_plain", wraps=tqck.check_column_plain),
             mock.patch.object(tqck, "var_totals_plain", wraps=tqck.var_totals_plain),
             mock.patch.object(tqc, "_check_msa_slots", wraps=tqc._check_msa_slots)]
    spies = [p.start() for p in plain]
    try:
        # decode_ldpc sends this decode to K11 ('auto'); 'fused' runs K9 + K10
        with mock.patch.object(lib, "qc_check_launch", wraps=lib.qc_check_launch) as k9, \
                mock.patch.object(lib, "qc_var_launch", wraps=lib.qc_var_launch) as k10:
            out, _, fail = tqc.make_qc_decoder(64800, "4/5", 6, "NMSA", "f32",
                                               backend="fused")(llr)
        dec, fail = (out < 0).to(torch.int8), fail.to(torch.int8)
        assert k9.call_count == k10.call_count == 7
        with mock.patch.object(lib, "ldpc_check_launch", wraps=lib.ldpc_check_launch) as k8:
            out8 = tqc.make_qc_decoder(64800, "4/5", 6, "NMSA", "f32", backend="pallas")(llr)
        assert k8.call_count == 6
        assert all(s.call_count == 0 for s in spies)
    finally:
        for p in plain:
            p.stop()
    torch.cuda.synchronize()
    ref = tfec.decode_ldpc(llr.cpu(), graph=graph, config=tfec.LDPCConfig(
        maxIter=6, alg="NMSA", msgDtype="f32"))
    ok = ref[2] == 0  # decided columns: float32 sums in another order leave
    assert bool(ok.any())  # the undecided ones free to differ
    assert torch.equal(fail.cpu(), ref[2]) and torch.equal(dec.cpu()[:, ok], ref[0][:, ok])
    assert torch.equal((out8[0] < 0).to(torch.int8).cpu()[:, ok], ref[0][:, ok])


@pytest.mark.gpu
def test_cuda_auto_refuses_the_megakernels_work():
    """bfloat16 messages at R4/5 are the JAX megakernel's on an accelerator:
    'auto' on CUDA leaves them to K11 (one launch per decode) and launches
    neither K9 nor K10; the explicit 'fused' route still takes them, with
    the same bits."""
    from opticommpy_torch.kernels import qc_mega as tmega

    dev = require_cuda()
    llr = torch.as_tensor(zero_codeword_llrs(23, (5.0,)), device=dev)
    graph, _ = tfec.standard_ldpc("DVBS2", 64800, "4/5")
    k9, k10, k11 = tqck.check_launches, tqck.var_launches, tmega.launches
    dec, out, fail = tfec.decode_ldpc(llr, graph=graph, config=tfec.LDPCConfig(
        maxIter=6, alg="NMSA", msgDtype="bf16"))
    assert (tqck.check_launches, tqck.var_launches, tmega.launches) == (k9, k10, k11 + 1)
    tot, n_iters, fail_f = tqc.make_qc_decoder(64800, "4/5", 6, "NMSA", "bf16",
                                               backend="fused")(llr)
    assert (tqck.check_launches, tqck.var_launches) == (k9 + 7, k10 + 7)
    assert not bool(fail_f.any()) and not bool(fail.any())
    assert torch.equal(out, tot) and torch.equal(fail, fail_f.to(torch.int8))
