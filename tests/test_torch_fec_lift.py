"""The port's lifted-circulant decoder (802.11n, AR4JA) against the JAX
package's: tables, the plain roll route, K12's plain version against the
JAX kernel in interpret mode, ``decode_ldpc`` on lift graphs, the
``'auto'`` routing; and K12 on the card.

Tolerances:
- tables, K12's plain version against ``lift_iter_pallas``
  (interpret): exact (integers; the same float32 operations in the same
  order: T from the channel LLR, then the messages in check bucket, group,
  slot order).
- ``'xla'`` against JAX ``'xla'`` (tests/test_fec.py:882-911): iteration
  counts and fail flags equal, totals within 1e-5 of the largest (the JAX
  route sums each plane's messages and then adds the LLR; the port adds
  them one by one after the LLR, in the kernel's order, so that its K12
  route and its plain route agree bit for bit).
- ``decode_ldpc``: decisions and fail flags equal, totals within 1e-5.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import codes as jcodes  # noqa: E402
from opticommpy_tpu.comm import fec as jfec  # noqa: E402
from opticommpy_tpu.comm import fec_lift as jlift  # noqa: E402
from opticommpy_tpu.kernels.lift_pallas import lift_iter_pallas  # noqa: E402
from opticommpy_torch.comm import fec as tfec  # noqa: E402
from opticommpy_torch.comm import fec_lift as tlift  # noqa: E402
from opticommpy_torch.kernels import _build  # noqa: E402
from opticommpy_torch.kernels import lift as tliftk  # noqa: E402

from _torch_parity import require_cuda, to_np  # noqa: E402

LIFT_CODES = [(mode, n, R) for mode, n, R in jcodes.available_ldpc_codes()
              if mode in ("IEEE_802.11nD2", "AR4JA")]


def _zero_llrs(rng, n_rows, esn0_db, n_tx=None):
    """BPSK LLRs of the all-zero codeword, one column per Es/N0 [dB]; rows
    from ``n_tx`` on are punctured (zero)."""
    sigma = np.sqrt(0.5 * 10 ** (-np.asarray(esn0_db, float) / 10))
    llr = 2 * (1.0 + sigma * rng.normal(size=(n_rows, len(sigma)))) / sigma**2
    if n_tx is not None:
        llr[n_tx:] = 0.0
    return llr.astype(np.float32)


@pytest.mark.parametrize("mode,n,R", LIFT_CODES)
def test_lift_tables_match_jax(mode, n, R):
    a, b = tlift.lift_tables(mode, n, R), jlift.lift_tables(mode, n, R)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], list):
            assert len(a[key]) == len(b[key])
            for x, y in zip(a[key], b[key]):
                np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("mode,n,R", [("IEEE_802.11nD2", 1944, "1/2"), ("AR4JA", 2048, "1/2"),
                                      ("IEEE_802.11nD2", 648, "5/6")])
def test_xla_route_matches_jax(mode, n, R):
    """tests/test_fec.py:882's codes and draws (B = 4, MSA, f32, 5
    iterations), with two converging columns added."""
    rng = np.random.default_rng(2)
    tb = tlift.lift_tables(mode, n, R)
    llr = (1.0 + rng.normal(scale=1.5, size=(tb["V"] * tb["L"], 4))).astype(np.float32)
    llr = np.concatenate([llr, _zero_llrs(rng, llr.shape[0], (6.0, 3.0))], axis=1)
    o_j, it_j, f_j = jlift.make_lift_decoder(mode, n, R, 5, "MSA", "f32")(jnp.asarray(llr))
    o_t, it_t, f_t = tlift.make_lift_decoder(mode, n, R, 5, "MSA", "f32")(torch.as_tensor(llr))
    np.testing.assert_array_equal(to_np(it_t), np.asarray(it_j))
    np.testing.assert_array_equal(to_np(f_t), np.asarray(f_j))
    assert not np.asarray(f_j)[-1]
    o_j = np.asarray(o_j)
    assert np.abs(to_np(o_t) - o_j).max() / np.abs(o_j).max() < 1e-5


@pytest.mark.parametrize("alg,mdt", [("NMSA", "bf16"), ("MSA", "f32")])
def test_lift_iter_plain_matches_pallas_interpret(alg, mdt):
    """AR4JA 2048 R1/2 (L = 128), B = 24: X' (message type), T and ok of one
    iteration from X after two, on noisy all-zero codewords (some pass)."""
    tb = tlift.lift_tables("AR4JA", 2048, "1/2")
    rng = np.random.default_rng(6)
    llr = _zero_llrs(rng, tb["V"] * tb["L"], np.linspace(-1.0, 6.0, 24), 2048)
    llr_bo = llr.reshape(tb["V"], tb["L"], 24)[tb["var_order"]]
    lay = tliftk.LiftLayout(tb, "cpu")
    alpha = 0.75 if alg == "NMSA" else None
    tdt = torch.bfloat16 if mdt == "bf16" else torch.float32
    X = torch.cat([torch.stack([torch.roll(torch.as_tensor(llr_bo[ev[sl, ig]]), int(esh[sl, ig]), 0)
                                for sl in range(d) for ig in range(ng)])
                   for (d, ng), ev, esh in zip(tb["chk_buckets"], tb["ev"], tb["esh"])]).to(tdt)
    llr_t = torch.as_tensor(llr_bo)
    for _ in range(2):
        X, _, _ = tliftk.lift_iter(X, llr_t, lay, alpha)
    xo, T, ok = tliftk.lift_iter(X, llr_t, lay, alpha)
    jx, jt, jok = lift_iter_pallas(jnp.asarray(X.float().numpy()), jnp.asarray(llr_bo),
                                   mode="AR4JA", n=2048, R="1/2", alg=alg, msg_dtype=mdt,
                                   interpret=True)
    assert xo.dtype == tdt
    np.testing.assert_array_equal(xo.float().numpy(), np.asarray(jx.astype(jnp.float32)))
    np.testing.assert_array_equal(T.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert 0 < int(ok.sum()) < 24


@pytest.mark.parametrize("mdt", ["bf16", "f32"])
def test_kernel_route_equals_the_plain_route(mdt):
    """The K12 route ('pallas'; K12's plain version on the CPU) and the
    plain roll route give the same bits, early exit the fixed loop's."""
    rng = np.random.default_rng(4)
    llr = torch.as_tensor(_zero_llrs(rng, 2560, (-1.0, 0.0, 1.0, 3.0), 2048))
    with mock.patch.object(tliftk, "lift_iter_plain", wraps=tliftk.lift_iter_plain) as k12:
        a = tlift.make_lift_decoder("AR4JA", 2048, "1/2", 12, "NMSA", mdt, backend="pallas")(llr)
    assert k12.call_count == 12
    b = tlift.make_lift_decoder("AR4JA", 2048, "1/2", 12, "NMSA", mdt, backend="xla")(llr)
    c = tlift.make_lift_decoder("AR4JA", 2048, "1/2", 12, "NMSA", mdt, True, "pallas")(llr)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(y, z)
    assert int(a[1].min()) < int(a[1].max())


@pytest.mark.parametrize("mode,n,R,esn0_db", [
    ("IEEE_802.11nD2", 1296, "1/2", (2.0, 0.5, -1.0)), ("AR4JA", 2048, "1/2", (2.0, 0.5, -1.0)),
    ("AR4JA", 1280, "4/5", (5.0, 3.5, 2.0))])
def test_decode_ldpc_on_lift_graphs_matches_jax(mode, n, R, esn0_db):
    """decode_ldpc routes lift graphs to the lift decoder in both packages
    (tests/test_fec.py:913-951): all-zero codewords from a decodable Es/N0
    down to the waterfall, NMSA-20 bf16, AR4JA with its punctured tail;
    early exit equals the fixed loop."""
    rng = np.random.default_rng(9)
    graph_t, _ = tfec.standard_ldpc(mode, n, R)
    graph_j, _ = jfec.standard_ldpc(mode, n, R)
    llr = _zero_llrs(rng, n, esn0_db)
    cfg = dict(maxIter=20, alg="NMSA", msgDtype="bf16")
    out_j = jfec.decode_ldpc(jnp.asarray(llr), graph=graph_j, config=jfec.LDPCConfig(**cfg))
    out_t = tfec.decode_ldpc(torch.as_tensor(llr), graph=graph_t, config=tfec.LDPCConfig(**cfg))
    early = tfec.decode_ldpc(torch.as_tensor(llr), graph=graph_t,
                             config=tfec.LDPCConfig(earlyExit=True, **cfg))
    assert tuple(out_t[1].shape) == (n, 3)
    np.testing.assert_array_equal(to_np(out_t[0]), np.asarray(out_j[0]))
    np.testing.assert_array_equal(to_np(out_t[2]), np.asarray(out_j[2]))
    o_j = np.asarray(out_j[1], np.float32)
    assert np.abs(to_np(out_t[1]) - o_j).max() / np.abs(o_j).max() < 1e-5
    assert not to_np(out_t[2])[0] and not to_np(out_t[0])[:, 0].any()
    for a, b in zip(out_t, early):
        assert torch.equal(a, b)


@pytest.mark.parametrize("alg", ["MSA", "NMSA", "SPA"])
@pytest.mark.parametrize("mdt", ["bf16", "f32"])
def test_auto_routing_matches_jax(mdt, alg):
    """'auto' on CUDA takes K12 for every MSA/NMSA decode of every shipped
    lift code at both message types, SPA the plain route; on the CPU always
    the plain route. As a record: the JAX package's 'auto' on an
    accelerator still takes its TPU kernel only for AR4JA 8192 R1/2 at bf16
    (its sublane tile and VMEM budget, which the port does not carry)."""
    jax_taken = []
    for mode, n, R in LIFT_CODES:
        with mock.patch.object(jax, "default_backend", return_value="gpu"), \
                mock.patch.object(jlift, "_make_lift_decoder") as build:
            jlift.make_lift_decoder(mode, n, R, 20, alg, mdt)
        if build.call_args[0][7] == "pallas":
            jax_taken.append((mode, n, R))
        want = "pallas" if alg != "SPA" else "xla"
        assert tlift.lift_backend(mode, n, R, alg, on_cuda=True) == want, (mode, n, R)
        assert tlift.lift_backend(mode, n, R, alg, on_cuda=False) == "xla"
    assert jax_taken == ([("AR4JA", 8192, "1/2")] if alg != "SPA" and mdt == "bf16" else [])


def test_auto_on_cuda_builds_the_kernel_route_for_80211n():
    """'auto' resolved to K12 for an 802.11n code (L = 81) builds the kernel
    route, which the explicit 'pallas' refuses for the JAX package's sake;
    the route runs (its plain version) on CPU tensors."""
    rng = np.random.default_rng(12)
    llr = torch.as_tensor(_zero_llrs(rng, 1944, (2.0, 0.0)))
    with mock.patch.object(tlift, "lift_backend", return_value="pallas"), \
            mock.patch.object(tliftk, "lift_iter", wraps=tliftk.lift_iter) as k12:
        a = tlift.make_lift_decoder("IEEE_802.11nD2", 1944, "1/2", 4, "NMSA", "bf16")(llr)
    assert k12.call_count == 4
    b = tlift.make_lift_decoder("IEEE_802.11nD2", 1944, "1/2", 4, "NMSA", "bf16",
                                backend="xla")(llr)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_pallas_route_errors_match_jax():
    """An explicit 'pallas' needs L % 8 == 0 and MSA/NMSA in both packages
    (802.11n's lifts are 27, 54 and 81); an unknown mode raises."""
    for mod in (tlift, jlift):
        with pytest.raises(ValueError, match="L%8"):
            mod.make_lift_decoder("IEEE_802.11nD2", 1944, "1/2", 5, "NMSA", "bf16",
                                  backend="pallas")
        with pytest.raises(ValueError, match="L%8"):
            mod.make_lift_decoder("AR4JA", 2048, "1/2", 5, "SPA", "f32", backend="pallas")
        with pytest.raises(ValueError, match="no lift construction"):
            mod.lift_tables("DVBS2", 64800, "4/5")


# -- K12 on the card ----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mdt", ["bf16", "f32"])
@pytest.mark.parametrize("mode,n,R", [("AR4JA", 8192, "1/2"), ("IEEE_802.11nD2", 1944, "1/2")])
def test_k12_matches_plain_on_gpu(mode, n, R, mdt):
    """Any L on the card, 802.11n's 81 included; B = 100 is not a multiple
    of the CTA's 8-codeword tile."""
    dev = require_cuda()
    tb = tlift.lift_tables(mode, n, R)
    lay = tliftk.LiftLayout(tb, dev)
    rng = np.random.default_rng(3)
    llr = _zero_llrs(rng, tb["V"] * tb["L"], np.linspace(-1.5, 3.0, 100))
    llr_bo = torch.as_tensor(llr.reshape(tb["V"], tb["L"], 100)[tb["var_order"]], device=dev)
    X = llr_bo[torch.arange(tb["E"], device=dev) % tb["V"]].to(
        torch.bfloat16 if mdt == "bf16" else torch.float32)
    for _ in range(3):
        before = tliftk.launches
        k = tliftk.lift_iter(X, llr_bo, lay, 0.75)
        assert tliftk.launches == before + 1
        p = tliftk.lift_iter_plain(X, llr_bo, lay, 0.75)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k, p))
        X = k[0]


@pytest.mark.gpu
@pytest.mark.parametrize("mdt", ["bf16", "f32"])
@pytest.mark.parametrize("mode,n,R", LIFT_CODES)
def test_k12_equals_plain_on_every_code_on_gpu(mode, n, R, mdt):
    """Every shipped lift code (check degrees 3-22, L 27-2048), B = 1, 64,
    100 and 1023 (64 takes the vector instance, the others are not
    multiples of the vector width), three iterations chained from the
    channel LLRs: X', T and ok equal lift_iter_plain's bit for bit, one
    launch per call."""
    dev = require_cuda()
    tb = tlift.lift_tables(mode, n, R)
    lay = tliftk.LiftLayout(tb, dev)
    dt = torch.bfloat16 if mdt == "bf16" else torch.float32
    for B in (1, 64, 100, 1023):
        rng = np.random.default_rng(B)
        llr = _zero_llrs(rng, tb["V"] * tb["L"], np.linspace(-1.5, 4.0, B))
        llr_bo = torch.as_tensor(llr.reshape(tb["V"], tb["L"], B)[tb["var_order"]], device=dev)
        X = torch.cat([torch.stack([torch.roll(llr_bo[ev[sl, ig]], int(esh[sl, ig]), 0)
                                    for sl in range(d) for ig in range(ng)])
                       for (d, ng), ev, esh in zip(tb["chk_buckets"], tb["ev"], tb["esh"])])
        X = X.to(dt)
        for _ in range(3):
            before = tliftk.launches
            k = tliftk.lift_iter(X, llr_bo, lay, 0.75)
            assert tliftk.launches == before + 1
            p = tliftk.lift_iter_plain(X, llr_bo, lay, 0.75)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(k, p)), (B, mdt)
            X = k[0]


@pytest.mark.gpu
def test_cuda_auto_launches_k12_on_ar4ja_8192():
    """decode_ldpc on AR4JA 8192 R1/2, NMSA bf16 on CUDA: one K12 launch per
    iteration and no plain version; the same bits as the plain route on the
    card. 802.11n 1944 R1/2 takes K12 too (20 more launches)."""
    dev = require_cuda()
    lib = _build.load_library()
    rng = np.random.default_rng(5)
    cfg = tfec.LDPCConfig(maxIter=20, alg="NMSA", msgDtype="bf16")
    graph, _ = tfec.standard_ldpc("AR4JA", 8192, "1/2")
    llr = torch.as_tensor(_zero_llrs(rng, 8192, (0.0, 1.0, 2.0)), device=dev)
    with mock.patch.object(lib, "lift_iter_launch", wraps=lib.lift_iter_launch) as k12, \
            mock.patch.object(tliftk, "lift_iter_plain", wraps=tliftk.lift_iter_plain) as plain:
        out = tfec.decode_ldpc(llr, graph=graph, config=cfg)
        g80211, _ = tfec.standard_ldpc("IEEE_802.11nD2", 1944, "1/2")
        tfec.decode_ldpc(torch.as_tensor(_zero_llrs(rng, 1944, (1.0,)), device=dev),
                         graph=g80211, config=cfg)
    assert k12.call_count == 40 and plain.call_count == 0
    ref = tlift.make_lift_decoder("AR4JA", 8192, "1/2", 20, "NMSA", "bf16", backend="xla")(
        torch.nn.functional.pad(llr, (0, 0, 0, graph["n"] - 8192)))
    torch.cuda.synchronize()
    assert torch.equal(out[1], ref[0][:8192]) and torch.equal(out[2], ref[2].to(torch.int8))
