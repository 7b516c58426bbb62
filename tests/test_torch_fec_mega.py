"""The port's ``'mega'`` backend (K11's plain version on the CPU) against the
JAX package's megakernel in interpret mode, K11's flooding schedule against
the fused route, and K11 on the card.

Tolerances:
- ``'mega'`` against JAX ``backend="mega"`` (the pattern of
  tests/test_fec.py:462-501): iteration counts, fail flags and signs equal;
  totals within 2e-3 of the largest, the JAX package's own bound between its
  megakernel and its XLA route at bf16 (the megakernel adds column 0's
  staircase message to plane q-1 before column q-1's own message, the port
  adds in the fused route's order, so a total can round to another bf16
  value and a message part by one ulp).
- flooding ``'mega'`` against ``'fused'``, early exit against the fixed loop,
  K11 against its plain version on the card: bit-identical (the same float32
  operations in the same order).
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import fec_qc as jqc  # noqa: E402
from opticommpy_tpu.kernels import qc_mega as jmega  # noqa: E402
from opticommpy_torch.comm import fec as tfec  # noqa: E402
from opticommpy_torch.comm import fec_qc as tqc  # noqa: E402
from opticommpy_torch.kernels import _build  # noqa: E402
from opticommpy_torch.kernels import qc as tqck  # noqa: E402
from opticommpy_torch.kernels import qc_mega as tmega  # noqa: E402

from _torch_parity import (assert_qc_decodes_alike, require_cuda, to_np,  # noqa: E402
                           zero_codeword_llrs)

DVBS2_RATES = [f"{a}/{b}" for a, b in ((1, 4), (1, 3), (2, 5), (1, 2), (3, 5), (2, 3), (3, 4),
                                        (4, 5), (5, 6), (8, 9), (9, 10))]


def _llrs(B=128, seed=13):
    """Noisy columns (1.2 + N(0, 1.6^2), tests/test_fec.py:487-488) that do
    not converge in a few iterations, and all-zero codewords at 5 to 9 dB
    that converge at different steps."""
    rng = np.random.default_rng(seed)
    strong = zero_codeword_llrs(seed, (9.0, 7.0, 6.0, 5.5, 5.0, 5.0, 4.8, 4.6))
    noisy = (1.2 + rng.normal(scale=1.6, size=(64800, B - strong.shape[1]))).astype(np.float32)
    return np.concatenate([noisy, strong], axis=1)


def test_mega_matches_jax_megakernel_r910_bf16():
    """R9/10 (q = 18, the fewest columns, every one meeting a group twice),
    bf16 NMSA, B = 128 (the JAX megakernel's tile, so interpret mode runs
    the real megakernel body), 4 iterations."""
    llr = _llrs()
    out_j = jqc.make_qc_decoder(64800, "9/10", 4, "NMSA", "bf16", backend="mega")(
        jnp.asarray(llr))
    dec = tqc.make_qc_decoder(64800, "9/10", 4, "NMSA", "bf16", backend="mega")
    with mock.patch.object(tmega, "mega_decode_plain", wraps=tmega.mega_decode_plain) as plain:
        out_t = dec(torch.as_tensor(llr))
    assert plain.call_count == 1
    it = to_np(out_t[1])
    assert it.max() == 4 and it.min() < 4  # some columns froze early
    assert_qc_decodes_alike(out_t, out_j, rel=2e-3)


@pytest.mark.parametrize("mdt", ["f32", "bf16"])
def test_mega_flooding_equals_fused_and_early_exit_equals_fixed(mdt):
    llr = torch.as_tensor(_llrs(B=24, seed=4))
    fused = tqc.make_qc_decoder(64800, "9/10", 6, "NMSA", mdt, backend="fused")(llr)
    mega = tqc.make_qc_decoder(64800, "9/10", 6, "NMSA", mdt, backend="mega")(llr)
    early = tqc.make_qc_decoder(64800, "9/10", 6, "NMSA", mdt, True, backend="mega")(llr)
    for a, b, c in zip(fused, mega, early):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert int(mega[1].min()) < int(mega[1].max())


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("mdt", ["bf16", "f32"])
@pytest.mark.parametrize("R", DVBS2_RATES)
def test_mega_state_bytes_match_jax(R, mdt, schedule):
    tb = tqc.qc_tables(R, 64800)
    jdt = jnp.bfloat16 if mdt == "bf16" else jnp.float32
    for bt in (8, 128):
        assert (tqc.mega_state_bytes(tb["G"], tb["q"], tb["S"], bt, mdt, schedule)
                == jmega.mega_state_bytes(tb["G"], tb["q"], tb["S"], bt, jdt, schedule))
    assert tqc.MEGA_VMEM_BUDGET == jmega.MEGA_VMEM_BUDGET
    assert tqc.takes_megakernel(tb, mdt, schedule) == (
        jmega.mega_state_bytes(tb["G"], tb["q"], tb["S"], 128, jdt, schedule)
        <= jmega.MEGA_VMEM_BUDGET)


def test_mega_routes_like_the_jax_package():
    """'mega' takes K11 where the budget holds and the fused route
    elsewhere (float32 at R4/5), as the JAX package's 'mega' does; SPA
    raises on 'mega' in both packages."""
    llr = torch.as_tensor(zero_codeword_llrs(3, (6.0,)))
    with mock.patch.object(tmega, "mega_decode_plain", wraps=tmega.mega_decode_plain) as k11, \
            mock.patch.object(tqck, "check_column_plain", wraps=tqck.check_column_plain) as k9:
        tqc.make_qc_decoder(64800, "4/5", 2, "NMSA", "f32", backend="mega")(llr)
        assert (k11.call_count, k9.call_count) == (0, 3)
        tqc.make_qc_decoder(64800, "1/2", 2, "NMSA", "f32", backend="mega")(
            torch.as_tensor(zero_codeword_llrs(3, (3.0,))))
        assert (k11.call_count, k9.call_count) == (1, 6)  # the plain flooding runs K9's
    for mod in (tqc, jqc):
        with pytest.raises(ValueError, match="MSA/NMSA only"):
            mod.make_qc_decoder(64800, "4/5", 2, "SPA", "bf16", backend="mega")
    assert issubclass(tqc.MegaBudgetError, ValueError)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("mdt", ["bf16", "f32"])
@pytest.mark.parametrize("R", DVBS2_RATES)
def test_auto_routes_every_msa_nmsa_cuda_decode_to_k11(R, mdt, schedule):
    """'auto' on CUDA tensors takes K11 for every MSA/NMSA code, both message
    types and both schedules, with no fused or plain route beside it (the
    CUDA side mocked: a tensor that says it is on CUDA); CPU tensors and SPA
    keep the plain roll route."""
    cuda = mock.MagicMock()
    cuda.is_cuda = True
    cpu = mock.MagicMock()
    cpu.is_cuda = False
    make = tqc.make_qc_decoder.__wrapped__  # past the decoder cache
    for alg in ("MSA", "NMSA"):
        with mock.patch.object(tqc, "_make_mega_decoder",
                               return_value=lambda x: "k11") as mega, \
                mock.patch.object(tqc, "_make_fused_decoder") as fused, \
                mock.patch.object(tqc, "_make_roll_decoder",
                                  return_value=lambda x: "xla") as roll:
            dec = make(64800, R, 5, alg, mdt, True, "auto", schedule)
            assert dec(cuda) == "k11"
            assert mega.call_args.args[1:] == (5, alg, mdt, True, schedule)
            assert fused.call_count == 0
            if schedule == "flooding":
                assert dec(cpu) == "xla" and roll.call_count == 1
    if schedule == "flooding":
        with mock.patch.object(tqc, "_make_mega_decoder") as mega, \
                mock.patch.object(tqc, "_make_roll_decoder", return_value=lambda x: "xla"):
            assert make(64800, R, 5, "SPA", mdt, False, "auto", schedule)(cuda) == "xla"
            assert mega.call_count == 0
        with mock.patch.object(tqc, "_make_mega_decoder") as mega, \
                mock.patch.object(tqc, "_make_fused_decoder", return_value="k9k10") as fused:
            assert make(64800, R, 5, "NMSA", mdt, False, "fused", schedule) == "k9k10"
            assert mega.call_count == 0 and fused.call_count == 1


# -- K11 on the card ----------------------------------------------------------

def _cuda_llrs(dev, R, B=40):
    lo, hi = {"4/5": (2.2, 3.5), "9/10": (4.6, 6.0), "1/4": (-2.6, -1.0)}[R]
    return torch.as_tensor(zero_codeword_llrs(31, tuple(np.linspace(lo, hi, B))), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("mdt", ["bf16", "f32"])
@pytest.mark.parametrize("R", ["4/5", "9/10", "1/4"])
def test_k11_matches_plain_on_gpu(R, mdt, schedule):
    dev = require_cuda()
    tb = tqc.qc_tables(R, 64800)
    lay = tqck.QCLayout(tb, dev)
    li, lp = tqc._split_llrs(tb, _cuda_llrs(dev, R))
    outs = []
    for ee in (False, True):
        before = tmega.launches
        k = tmega.qc_decode_mega(li, lp, lay, 11, 0.75, mdt, ee, schedule)
        assert tmega.launches == before + 1
        p = tqc.mega_decode_plain(li, lp, lay, 11, 0.75, mdt, ee, schedule)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k, p))
        outs.append(k)
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.gpu
def test_cuda_auto_launches_k11_once_per_decode():
    """decode_ldpc on CUDA at bf16 (coherent_coded_serve's default config)
    and layered: one K11 launch per decode, no K9/K10 launch, no plain
    version; the same outputs as the fused route (flooding)."""
    dev = require_cuda()
    lib = _build.load_library()
    graph, _ = tfec.standard_ldpc("DVBS2", 64800, "4/5")
    llr = _cuda_llrs(dev, "4/5", B=16)
    k9, k10 = tqck.check_launches, tqck.var_launches
    with mock.patch.object(lib, "qc_mega_launch", wraps=lib.qc_mega_launch) as k11, \
            mock.patch.object(tmega, "mega_decode_plain", wraps=tmega.mega_decode_plain) as plain:
        cfg = tfec.LDPCConfig(maxIter=20, alg="NMSA", msgDtype="bf16", earlyExit=True)
        out = tfec.decode_ldpc(llr, graph=graph, config=cfg)
        lay = tfec.decode_ldpc(llr, graph=graph, config=tfec.LDPCConfig(
            maxIter=20, alg="NMSA", msgDtype="bf16", earlyExit=True, schedule="layered"))
    assert k11.call_count == 2 and plain.call_count == 0
    assert (tqck.check_launches, tqck.var_launches) == (k9, k10)
    fused = tqc.make_qc_decoder(64800, "4/5", 20, "NMSA", "bf16", backend="fused")(llr)
    torch.cuda.synchronize()
    assert torch.equal(out[1], fused[0]) and torch.equal(out[2], fused[2].to(torch.int8))
    assert not bool(out[2].any()) and not bool(lay[2].any())
    assert torch.equal(out[0], lay[0])  # both decode every codeword


@pytest.mark.gpu
@pytest.mark.parametrize("R, mdt, schedule", [("4/5", "bf16", "flooding"),
                                              ("4/5", "bf16", "layered"),
                                              ("2/3", "f32", "flooding"),
                                              ("1/4", "f32", "layered"),
                                              ("8/9", "bf16", "flooding"),
                                              ("9/10", "f32", "layered")])
@pytest.mark.parametrize("B", [1, 3, 37])
def test_k11_batches_converging_apart_match_plain_on_gpu(R, mdt, schedule, B):
    """K11 against its plain version at batch sizes that fill no multiple of
    anything (one CTA per codeword; the kernel batches columns and groups,
    not codewords), on codewords that converge at different steps, under
    early exit and the fixed loop."""
    dev = require_cuda()
    tb = tqc.qc_tables(R, 64800)
    lay = tqck.QCLayout(tb, dev)
    lo, hi = {"4/5": (2.0, 6.0), "2/3": (1.2, 5.0), "1/4": (-2.8, 1.0), "8/9": (3.6, 8.0),
              "9/10": (4.0, 8.0)}[R]
    llr = torch.as_tensor(zero_codeword_llrs(B, tuple(np.linspace(lo, hi, B))), device=dev)
    li, lp = tqc._split_llrs(tb, llr)
    outs = []
    for ee in (False, True):
        before = tmega.launches
        k = tmega.qc_decode_mega(li, lp, lay, 9, 0.75, mdt, ee, schedule)
        assert tmega.launches == before + 1
        p = tqc.mega_decode_plain(li, lp, lay, 9, 0.75, mdt, ee, schedule)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k, p))
        outs.append(k)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    if B > 1:
        assert int(outs[0][3].min()) < int(outs[0][3].max())  # converged apart


@pytest.mark.gpu
def test_cuda_auto_f32_r45_launches_k11_and_equals_fused():
    """Path E's float32 decode (R4/5 NMSA, 'auto'): one K11 launch, no K9 or
    K10, and the fused route's bits."""
    dev = require_cuda()
    graph, _ = tfec.standard_ldpc("DVBS2", 64800, "4/5")
    llr = _cuda_llrs(dev, "4/5", B=24)
    k9, k10, k11 = tqck.check_launches, tqck.var_launches, tmega.launches
    with mock.patch.object(tmega, "mega_decode_plain", wraps=tmega.mega_decode_plain) as plain:
        dec, out, fail = tfec.decode_ldpc(llr, graph=graph, config=tfec.LDPCConfig(
            maxIter=20, alg="NMSA", msgDtype="f32", earlyExit=True))
    assert (tqck.check_launches, tqck.var_launches, tmega.launches) == (k9, k10, k11 + 1)
    assert plain.call_count == 0
    tot, n_iters, fail_f = tqc.make_qc_decoder(64800, "4/5", 20, "NMSA", "f32", True,
                                               backend="fused")(llr)
    torch.cuda.synchronize()
    assert torch.equal(out, tot) and torch.equal(fail, fail_f.to(torch.int8))
    assert torch.equal(dec, (tot < 0).to(torch.int8))
