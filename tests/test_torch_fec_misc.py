"""The port's Hamming, ALIST and Gallager helpers against the JAX package's.

Tolerances: all exact (integer matrices, text files, bits; the Hamming
decoder's decisions and fail flags are compared, its totals within the
general decoders' atol=5e-3 of tests/test_torch_fec.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import fec as jfec  # noqa: E402
from opticommpy_torch.comm import fec as tfec  # noqa: E402

from _torch_parity import to_np  # noqa: E402


@pytest.mark.parametrize("m,extended", [(1, False), (3, False), (3, True), (5, True)])
def test_hamming_parity_check_matrix_matches_jax(m, extended):
    np.testing.assert_array_equal(tfec.hamming_parity_check_matrix(m, extended),
                                  jfec.hamming_parity_check_matrix(m, extended))


def test_hamming_rejects_m_below_one():
    for mod in (tfec, jfec):
        with pytest.raises(ValueError, match="positive"):
            mod.hamming_parity_check_matrix(0)


@pytest.mark.parametrize("m,extended", [(3, False), (4, True)])
def test_hamming_encode_decode_matches_jax(m, extended):
    """tests/test_fec.py:133-148: encode, flip one bit, decode."""
    rng = np.random.default_rng(11)
    H = jfec.hamming_parity_check_matrix(m, extended)
    k = H.shape[1] - np.linalg.matrix_rank(H.astype(float))
    bits = rng.integers(0, 2, size=(k, 6))
    cw_t, Hm_t = tfec.encode_hamming(torch.as_tensor(bits), m=m, extended=extended)
    cw_j, Hm_j = jfec.encode_hamming(jnp.asarray(bits), m=m, extended=extended)
    np.testing.assert_array_equal(Hm_t, Hm_j)
    np.testing.assert_array_equal(to_np(cw_t), np.asarray(cw_j))
    assert np.all((Hm_t.astype(np.int64) @ to_np(cw_t).astype(np.int64)) % 2 == 0)
    y = 1.0 - 2.0 * to_np(cw_t).astype(np.float64)
    y[2, :] *= -1  # one bit error per codeword
    llr = (4.0 * y).astype(np.float32)
    out_t = tfec.decode_hamming(torch.as_tensor(llr), m=m, extended=extended)
    out_j = jfec.decode_hamming(jnp.asarray(llr), m=m, extended=extended)
    np.testing.assert_array_equal(to_np(out_t[0]), np.asarray(out_j[0]))
    np.testing.assert_array_equal(to_np(out_t[2]), np.asarray(out_j[2]))
    np.testing.assert_allclose(to_np(out_t[1]), np.asarray(out_j[1], np.float32), atol=5e-3)
    with pytest.raises(ValueError, match="rows"):
        tfec.encode_hamming(torch.zeros((k + 1, 2)), m=m, extended=extended)


@pytest.mark.parametrize("n,dv,dc,seed", [(96, 3, 6, 9), (1296, 3, 6, 0), (60, 2, 4, 3)])
def test_gallager_ldpc_matches_jax(n, dv, dc, seed):
    np.testing.assert_array_equal(tfec.gallager_ldpc(n, dv, dc, seed=seed),
                                  jfec.gallager_ldpc(n, dv, dc, seed=seed))


def test_gallager_ldpc_errors_match_jax():
    for args in ((10, 3, 4), (12, 3, 9)):
        for mod in (tfec, jfec):
            with pytest.raises(ValueError):
                mod.gallager_ldpc(*args)


def test_alist_roundtrip_matches_jax(tmp_path):
    """write_alist writes the JAX package's file byte for byte; both read it
    back to H; the NumPy parse equals the JAX package's reader (its native
    loader where built)."""
    H = jfec.gallager_ldpc(48, 3, 6, seed=2).copy()
    H[0, :] = 0  # an empty check row
    p_t, p_j = tmp_path / "t.alist", tmp_path / "j.alist"
    tfec.write_alist(H, str(p_t))
    jfec.write_alist(H, str(p_j))
    assert p_t.read_bytes() == p_j.read_bytes()
    np.testing.assert_array_equal(tfec.read_alist(str(p_t)), H)
    np.testing.assert_array_equal(tfec.read_alist(str(p_t)), jfec.read_alist(str(p_j)))
    for a, b in zip(tfec.read_alist_edges(str(p_t)), jfec.read_alist_edges(str(p_j))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tfec.parse_alist(str(p_t)) == jfec.parse_alist(str(p_j))


def test_summarize_alist_folder_matches_jax(tmp_path, capsys):
    tfec.write_alist(jfec.gallager_ldpc(24, 3, 6, seed=1), str(tmp_path / "code.alist"))
    tfec.write_alist(jfec.hamming_parity_check_matrix(3), str(tmp_path / "ham.txt"))
    (tmp_path / "broken.alist").write_text("not an alist\n")
    (tmp_path / "notes.md").write_text("skipped\n")
    table_t = tfec.summarize_alist_folder(str(tmp_path))
    out_t = capsys.readouterr().out
    table_j = jfec.summarize_alist_folder(str(tmp_path))
    out_j = capsys.readouterr().out
    assert table_t == table_j and out_t == out_j
    assert "code.alist" in table_t and "ham.txt" in table_t and "notes.md" not in table_t
    assert "Failed to parse broken.alist" in out_t
