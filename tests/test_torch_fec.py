"""The port's LDPC stack against the JAX package: code tables and graphs,
the encoder, the general belief-propagation decoders, the plain version of
the check-update kernel K8, and what raises.

Tolerances:
- tables, graphs, encoder, K8's plain version: exact (integer and min/sign
  arithmetic; K8's NMSA scale is one float32 multiply in both).
- general decoders: decisions, iteration counts and fail flags equal;
  totals within the JAX package's own atol=5e-3 between its padded and
  bucketed decoders (float32 sums and tanh/atanh in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import codes as jcodes  # noqa: E402
from opticommpy_tpu.comm import fec as jfec  # noqa: E402
from opticommpy_tpu.comm import fec_qc as jqc  # noqa: E402
from opticommpy_tpu.kernels import qc_mega as jmega  # noqa: E402
from opticommpy_tpu.kernels.ldpc_pallas import check_update_msa_pallas  # noqa: E402
from opticommpy_torch.comm import codes as tcodes  # noqa: E402
from opticommpy_torch.comm import fec as tfec  # noqa: E402
from opticommpy_torch.comm import fec_qc as tqc  # noqa: E402
from opticommpy_torch.kernels import ldpc as tldpc  # noqa: E402

from _torch_parity import to_np  # noqa: E402

DVBS2_RATES = [R for mode, n, R in jcodes.available_ldpc_codes()
               if mode == "DVBS2" and n == 64800]
TOT_ATOL = 5e-3


# -- tables and graphs --------------------------------------------------------

def test_available_codes_and_edges_match_jax():
    assert tcodes.available_ldpc_codes() == jcodes.available_ldpc_codes()
    assert len(DVBS2_RATES) == 11
    for mode, n, R in (("IEEE_802.11nD2", 648, "1/2"), ("AR4JA", 1280, "4/5")):
        for a, b in zip(tcodes.ldpc_edges(mode, n, R), jcodes.ldpc_edges(mode, n, R)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcodes.ldpc_parity_matrix("IEEE_802.11nD2", 648, "2/3"),
                                  jcodes.ldpc_parity_matrix("IEEE_802.11nD2", 648, "2/3"))


@pytest.mark.parametrize("R", DVBS2_RATES)
def test_qc_tables_match_jax(R):
    a, b = tqc.qc_tables(R, 64800), jqc.qc_tables(R, 64800)
    assert a.keys() == b.keys()
    for key in a:
        if key == "ent_addr":
            assert len(a[key]) == len(b[key])
            for x, y in zip(a[key], b[key]):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _assert_graphs_equal(gt, gj):
    assert gt.keys() == gj.keys()
    for key in gt:
        if key == "bk":
            for part in ("cn_var", "vn_edge", "vn_var"):
                assert len(gt[key][part]) == len(gj[key][part])
                for x, y in zip(gt[key][part], gj[key][part]):
                    np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(gt[key]["var_pos"], gj[key]["var_pos"])
        elif isinstance(gt[key], np.ndarray):
            assert gt[key].dtype == gj[key].dtype, key
            np.testing.assert_array_equal(gt[key], gj[key], err_msg=key)
        else:
            assert gt[key] == gj[key], key


@pytest.mark.parametrize("R", ["4/5", "9/10", "1/4"])
def test_standard_ldpc_graph_matches_jax(R):
    gt, et = tfec.standard_ldpc("DVBS2", 64800, R)
    gj, ej = jfec.standard_ldpc("DVBS2", 64800, R)
    _assert_graphs_equal(gt, gj)
    for a, b in zip(et, ej):
        np.testing.assert_array_equal(a, b)


def test_ldpc_graph_matches_jax():
    H = jfec.gallager_ldpc(96, 3, 6, seed=9)
    _assert_graphs_equal(tfec.ldpc_graph(H), jfec.ldpc_graph(H))
    rows, cols = np.nonzero(H)
    perm = np.random.default_rng(0).permutation(rows.size)
    _assert_graphs_equal(tfec.ldpc_graph_from_edges(96, 48, rows[perm], cols[perm]),
                         jfec.ldpc_graph(H))


def test_jax_graph_decodes_like_the_ports_own():
    rng = np.random.default_rng(1)
    cfg = tfec.LDPCConfig(maxIter=4, alg="NMSA", msgDtype="bf16")
    for build in (lambda m: m.standard_ldpc("DVBS2", 64800, "3/4")[0],
                  lambda m: m.ldpc_graph(jfec.gallager_ldpc(96, 3, 6, seed=4))):
        gt, gj = build(tfec), build(jfec)
        llr = torch.as_tensor((1.0 + rng.normal(scale=1.5, size=(gt["n"], 3))).astype(np.float32))
        a, b = tfec.decode_ldpc(llr, config=cfg, graph=gt), tfec.decode_ldpc(llr, config=cfg, graph=gj)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# -- encoder ------------------------------------------------------------------

@pytest.mark.parametrize("R", ["4/5", "1/2"])
def test_encode_dvbs2_matches_jax(R):
    _, edges = tfec.standard_ldpc("DVBS2", 64800, R)
    k = edges[0] - edges[1]
    bits = np.random.default_rng(2).integers(0, 2, size=(k, 3))
    cw_t = tfec.encode_ldpc(torch.as_tensor(bits), edges=edges)
    cw_j = np.asarray(jfec.encode_ldpc(jnp.asarray(bits), edges=edges))
    assert cw_t.dtype == torch.int8 and cw_t.shape == (64800, 3)
    np.testing.assert_array_equal(to_np(cw_t), cw_j)
    n, m, rows, cols = edges
    syn = np.zeros((m, 3), np.int64)
    np.add.at(syn, rows, to_np(cw_t)[cols].astype(np.int64))
    assert np.all(syn % 2 == 0)


def test_encode_triang_and_generator_match_jax():
    """802.11n 648b: R3/4 triangularizes (R1/2 does not, in either package:
    its encoder falls back to the generator matrix, as below)."""
    H = jcodes.ldpc_parity_matrix("IEEE_802.11nD2", 648, "3/4")
    bits = np.random.default_rng(3).integers(0, 2, size=(486, 5))
    P1, P2, Hm = tfec.triang_p1p2(H)
    P1j, P2j, Hmj = jfec.triang_p1p2(H)
    for a, b in ((P1, P1j), (P2, P2j), (Hm, Hmj)):
        np.testing.assert_array_equal(a, b)
    cfg_t, cfg_j = tfec.LDPCConfig(mode="triang"), jfec.LDPCConfig(mode="triang")
    cw_t = tfec.encode_ldpc(torch.as_tensor(bits), H=Hm, P1=P1, P2=P2, config=cfg_t)
    cw_j = jfec.encode_ldpc(jnp.asarray(bits), H=Hmj, P1=P1j, P2=P2j, config=cfg_j)
    np.testing.assert_array_equal(to_np(cw_t), np.asarray(cw_j))
    assert np.all((Hm.astype(np.int64) @ to_np(cw_t).astype(np.int64)) % 2 == 0)
    H = jcodes.ldpc_parity_matrix("IEEE_802.11nD2", 648, "1/2")
    assert tfec.triang_p1p2(H) == (None, None, None) == jfec.triang_p1p2(H)
    bits = np.random.default_rng(3).integers(0, 2, size=(324, 5))
    G, _, HmG = tfec.par2gen(H)
    Gj, _, HmGj = jfec.par2gen(H)
    np.testing.assert_array_equal(G, Gj)
    cw_t = tfec.encode_ldpc(torch.as_tensor(bits), H=HmG, G=G, config=tfec.LDPCConfig(mode="G"))
    cw_j = jfec.encode_ldpc(jnp.asarray(bits), H=HmGj, G=Gj, config=jfec.LDPCConfig(mode="G"))
    np.testing.assert_array_equal(to_np(cw_t), np.asarray(cw_j))
    assert np.all((HmG.astype(np.int64) @ to_np(cw_t).astype(np.int64)) % 2 == 0)


def test_gf2_helpers_match_jax():
    rng = np.random.default_rng(4)
    M = rng.integers(0, 2, size=(20, 40)).astype(np.uint8)
    np.testing.assert_array_equal(tfec.gauss_elim_gf2(M), jfec.gauss_elim_gf2(M))
    A = rng.integers(0, 2, size=(12, 12)).astype(np.uint8)
    for a, b in zip(tfec.inverse_matrix_gf2(A), jfec.inverse_matrix_gf2(A)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tfec.triangularize_gf2(M), jfec.triangularize_gf2(M)):
        np.testing.assert_array_equal(a, b)


# -- general decoders (tests/test_fec.py:227-246, 341-394) --------------------

def _irregular_code():
    rng = np.random.default_rng(3)
    H = jfec.gallager_ldpc(48, 3, 6, seed=3)
    rows, cols = np.nonzero(H)
    drop = rng.random(rows.size) < 0.3
    H = H.copy()
    H[rows[drop], cols[drop]] = 0
    llr = (1.5 + rng.normal(scale=1.2, size=(48, 8))).astype(np.float32)
    return H, llr, 15


def _gallager_1296():
    H = jfec.gallager_ldpc(1296, 3, 6, seed=0)
    rng = np.random.default_rng(5)
    sigma2 = 1 / (2 * 0.5 * 10 ** (2.2 / 10))
    y = 1.0 + rng.normal(scale=np.sqrt(sigma2), size=(1296, 16))
    return H, (2 * y / sigma2).astype(np.float32), 30


def _assert_decodes_alike(out_t, out_j):
    (o_t, it_t, f_t), (o_j, it_j, f_j) = out_t, out_j
    o_t, o_j = to_np(o_t), np.asarray(o_j)
    np.testing.assert_array_equal(to_np(it_t), np.asarray(it_j))
    np.testing.assert_array_equal(to_np(f_t), np.asarray(f_j))
    np.testing.assert_array_equal(o_t < 0, o_j < 0)
    np.testing.assert_allclose(o_t, o_j, atol=TOT_ATOL)


@pytest.mark.parametrize("code,alg", [("irregular", "MSA"), ("irregular", "SPA"),
                                      ("irregular", "NMSA"), ("gallager1296", "MSA"),
                                      ("gallager1296", "NMSA")])
def test_general_decoders_match_jax(code, alg):
    H, llr, iters = _irregular_code() if code == "irregular" else _gallager_1296()
    g = jfec.ldpc_graph(H)
    bk = g["bk"]
    if code == "irregular":
        assert len(bk["cn_var"]) > 1 and len(bk["vn_edge"]) > 1
    out_j = jfec._bp_decode_bucketed_batch(
        jnp.asarray(llr), tuple(jnp.asarray(a) for a in bk["cn_var"]),
        tuple(jnp.asarray(a) for a in bk["vn_edge"]),
        tuple(jnp.asarray(a) for a in bk["vn_var"]), jnp.asarray(bk["var_pos"]), iters, alg)
    out_t = tfec._bp_decode_bucketed_batch(torch.as_tensor(llr), bk["cn_var"], bk["vn_edge"],
                                           bk["vn_var"], bk["var_pos"], iters, alg)
    _assert_decodes_alike(out_t, out_j)
    out_j = jfec._bp_decode_batch(jnp.asarray(llr), jnp.asarray(g["cn_idx"]),
                                  jnp.asarray(g["cn_mask"]), jnp.asarray(g["vn_edge"]),
                                  H.shape[1], iters, alg)
    out_t = tfec._bp_decode_batch(torch.as_tensor(llr), g["cn_idx"], g["cn_mask"],
                                  g["vn_edge"], H.shape[1], iters, alg)
    _assert_decodes_alike(out_t, out_j)


def test_decode_ldpc_routes_match_jax():
    """decode_ldpc: the bucketed route (a graph with buckets), the padded
    route (without), bf16 messages, punctured inputs and clipping."""
    H, llr, _ = _gallager_1296()
    llr = llr * 40.0  # beyond clipLLR
    cfg_t = tfec.LDPCConfig(maxIter=20, alg="NMSA", msgDtype="bf16")
    cfg_j = jfec.LDPCConfig(maxIter=20, alg="NMSA", msgDtype="bf16")
    g = jfec.ldpc_graph(H)
    for graph in (g, {k: v for k, v in g.items() if k != "bk"}):
        bits_t, out_t, fail_t = tfec.decode_ldpc(torch.as_tensor(llr[:1200]), config=cfg_t,
                                                 graph=graph)
        bits_j, out_j, fail_j = jfec.decode_ldpc(jnp.asarray(llr[:1200]), config=cfg_j,
                                                 graph=graph)
        assert bits_t.dtype == torch.int8 and fail_t.dtype == torch.int8
        assert tuple(out_t.shape) == (1200, 16)
        np.testing.assert_array_equal(to_np(bits_t), np.asarray(bits_j))
        np.testing.assert_array_equal(to_np(fail_t), np.asarray(fail_j))
        np.testing.assert_allclose(to_np(out_t), np.asarray(out_j, np.float32),
                                   atol=TOT_ATOL, rtol=1e-5)


def test_isolated_variable_decodes_to_its_llr():
    H = jfec.gallager_ldpc(24, 3, 6, seed=5).copy()
    H[:, 7] = 0
    llr = np.full((24, 2), 4.0, dtype=np.float32)
    llr[7] = -1.25
    dec, out, fail = tfec.decode_ldpc(torch.as_tensor(llr), graph=tfec.ldpc_graph(H),
                                      config=tfec.LDPCConfig(maxIter=5, alg="MSA"))
    dec_j, out_j, fail_j = jfec.decode_ldpc(jnp.asarray(llr), graph=jfec.ldpc_graph(H),
                                            config=jfec.LDPCConfig(maxIter=5, alg="MSA"))
    np.testing.assert_allclose(to_np(out)[7], -1.25)
    assert np.all(to_np(dec)[7] == 1)
    np.testing.assert_array_equal(to_np(dec), np.asarray(dec_j))
    np.testing.assert_array_equal(to_np(fail), np.asarray(fail_j))


def test_early_exit_on_a_general_graph_warns():
    H = jfec.gallager_ldpc(24, 3, 6, seed=5)
    llr = torch.full((24, 2), 4.0)
    with pytest.warns(UserWarning, match="earlyExit"):
        tfec.decode_ldpc(llr, graph=tfec.ldpc_graph(H),
                         config=tfec.LDPCConfig(maxIter=3, earlyExit=True))


# -- K8's plain version against check_update_msa_pallas (interpret mode) ------

@pytest.mark.parametrize("alpha", [None, 0.75], ids=["msa", "nmsa"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_check_update_plain_equals_pallas_kernel(dtype, alpha):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(18, 4, 360, 8)).astype(np.float32)
    x[:, 0, :5] = 0.0  # zeros
    x[3, 1, 7] = x[9, 1, 7] = -0.5  # tied minima
    x[4:7, 2, 9] = 0.25
    x[17, 0, 0] = np.inf  # the masked staircase entry of check 0
    t = torch.as_tensor(x)
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
        x = t.float().numpy()  # values exact in bf16 for both packages
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    ref = np.asarray(check_update_msa_pallas(xj, alpha, interpret=True).astype(jnp.float32))
    out = tldpc.check_update_msa(t, alpha)
    assert out.dtype == t.dtype
    np.testing.assert_array_equal(out.float().numpy(), ref)
    if alpha is None:
        assert torch.equal(tqc._check_msa_slots(t), out)


# -- what raises ----------------------------------------------------------------

@pytest.mark.parametrize("mdt", ["bf16", "f32"])
@pytest.mark.parametrize("R", DVBS2_RATES)
def test_megakernel_routing_matches_jax(R, mdt):
    """'mega' keeps K11 for exactly the configurations that the JAX
    package's 'auto' on an accelerator decodes on its megakernel: those
    whose state for a 128-codeword tile fits the megakernel's budget
    (opticommpy_tpu/comm/fec_qc.py:406-457). ('auto' on CUDA takes K11 for
    every MSA/NMSA configuration: tests/test_torch_fec_mega.py.)"""
    tb = tqc.qc_tables(R, 64800)
    jdt = jnp.bfloat16 if mdt == "bf16" else jnp.float32
    mega = (jmega.mega_state_bytes(tb["G"], tb["q"], tb["S"], 128, jdt)
            <= jmega.MEGA_VMEM_BUDGET)
    assert tqc.takes_megakernel(tb, mdt) == mega
    # float32 at R4/5 (paths D and E of chip_smoke.py) takes K9/K10
    assert mega == (mdt == "bf16" or R in ("1/4", "1/3", "2/5", "1/2", "2/3"))



def test_unported_routes_raise():
    """Nothing of the LDPC stack raises NotImplementedError any more: 'mega',
    the layered schedule and lift graphs decode on the CPU (the kernels'
    plain versions). What still raises mirrors the JAX package, with the
    same error class."""
    llr = torch.as_tensor(np.full((64800, 1), 3.0, np.float32))
    for kw in (dict(backend="mega"), dict(backend="mega", schedule="layered")):
        _, n_iters, fail = tqc.make_qc_decoder(64800, "4/5", 5, "MSA", "bf16", **kw)(llr)
        assert n_iters.tolist() == [1] and not bool(fail.any())
    lift, _ = tfec.standard_ldpc("IEEE_802.11nD2", 648, "1/2")
    dec, _, fail = tfec.decode_ldpc(torch.full((648, 1), 3.0), graph=lift)
    assert not bool(dec.any()) and not bool(fail.any())
    for mod in (tqc, jqc):
        with pytest.raises(ValueError, match="unknown schedule"):
            mod.make_qc_decoder(64800, "4/5", 5, "MSA", "bf16", schedule="zigzag")
        with pytest.raises(ValueError, match="MSA/NMSA only"):
            mod.make_qc_decoder(64800, "4/5", 5, "SPA", "f32", backend="fused")
        with pytest.raises(ValueError, match="megakernel only"):
            mod.make_qc_decoder(64800, "4/5", 5, "MSA", "bf16", backend="fused",
                                schedule="layered")
    graph, _ = tfec.standard_ldpc("DVBS2", 64800, "4/5")
    with pytest.raises(ValueError, match="needs the megakernel"):
        tfec.decode_ldpc(torch.ones((64800, 1)), graph=graph,
                         config=tfec.LDPCConfig(alg="NMSA", schedule="layered"))
    H = jfec.gallager_ldpc(24, 3, 6, seed=5)
    with pytest.raises(ValueError, match="layered"):
        tfec.decode_ldpc(torch.ones((24, 1)), graph=tfec.ldpc_graph(H),
                         config=tfec.LDPCConfig(schedule="layered"))
    with pytest.raises(ValueError, match="Unsupported mode"):
        tfec.encode_ldpc(torch.zeros((12, 1)), H=H, config=tfec.LDPCConfig(mode="X"))


def test_numpy_inputs_go_to_the_default_device():
    H = jfec.gallager_ldpc(24, 3, 6, seed=5)
    llr = np.full((24, 2), 4.0, dtype=np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tfec.decode_ldpc(llr, graph=tfec.ldpc_graph(H))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tfec.encode_ldpc(np.zeros((12, 1)), H=H, config=tfec.LDPCConfig(mode="G"))
    else:
        dec, _, _ = tfec.decode_ldpc(llr, graph=tfec.ldpc_graph(H))
        assert dec.is_cuda
    dec, out, _ = tfec.decode_ldpc(torch.as_tensor(llr), graph=tfec.ldpc_graph(H))
    assert dec.device.type == "cpu" and out.device.type == "cpu"

