"""The port's symbol sources, detector, soft mapping, MI metrics, GN-model
budget and bit arrays against opticommpy_tpu.

Tolerances: the detector's decisions equal and its symbols within 1e-5;
the soft estimates, extrinsic LLRs and MI within 1e-5 (float32 rounding of
the same sums in another order); the host functions and bit arrays equal.
``cazac_sequence`` is held to a float64 evaluation within 1e-6 at every
length, and to the JAX package within 1.5 x the measured error of its
float32 phase (ROADMAP.md queue 3). Random symbols are checked by their
frequencies: each within 5 standard deviations of its probability.
"""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm import metrics as jmet  # noqa: E402
from opticommpy_tpu.comm import modulation as jmod  # noqa: E402
from opticommpy_tpu.comm import sources as jsrc  # noqa: E402
from opticommpy_tpu.utils import bits as jbits  # noqa: E402
from opticommpy_torch.comm import metrics as tmet  # noqa: E402
from opticommpy_torch.comm import modulation as tmod  # noqa: E402
from opticommpy_torch.comm import sources as tsrc  # noqa: E402
from opticommpy_torch.utils import bits as tbits  # noqa: E402

from _torch_parity import to_np  # noqa: E402

CONSTS = {"qam": (16, "qam"), "psk": (8, "psk"), "pam": (4, "pam")}


def _shaped_px(M, const_type, lam=0.08):
    c = tmod.gray_mapping(M, const_type)
    px = np.exp(-lam * np.abs(c) ** 2)
    return px / px.sum()


def _noisy(M, const_type, px, n=4096, snr_db=12.0, seed=0):
    """(rx, tx, const) complex64: symbols drawn with ``px`` plus AWGN."""
    rng = np.random.default_rng(seed)
    c = tmod.gray_mapping(M, const_type).astype(np.complex128)
    const = (c / np.sqrt(np.sum(px * np.abs(c) ** 2))).astype(np.complex64)
    tx = const[rng.choice(M, size=n, p=px)]
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    rx = tx + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return rx.astype(np.complex64), tx.astype(np.complex64), const


@pytest.mark.parametrize("kind", ["qam", "psk", "qam-shaped"])
def test_detector_matches_jax(kind):
    M, const_type = CONSTS[kind.split("-")[0]]
    px = _shaped_px(M, const_type) if kind.endswith("shaped") else np.ones(M) / M
    rx, _, const = _noisy(M, const_type, px, snr_db=8.0)
    for rule in ("MAP", "ML"):
        ref_s, ref_i = jmod.detector(rx, 0.16, const, px=px, rule=rule)
        out_s, out_i = tmod.detector(torch.as_tensor(rx), 0.16, torch.as_tensor(const),
                                     px=torch.as_tensor(px), rule=rule)
        np.testing.assert_array_equal(to_np(out_i), np.asarray(ref_i))
        np.testing.assert_allclose(to_np(out_s), np.asarray(ref_s), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="MAP or ML"):
        tmod.detector(torch.as_tensor(rx), 0.1, torch.as_tensor(const), rule="MMSE")


@pytest.mark.parametrize("kind", ["qam", "psk", "pam"])
def test_soft_mapper_and_estimator_match_jax(kind):
    M, const_type = CONSTS[kind]
    b = int(np.log2(M))
    rng = np.random.default_rng(1)
    llr = (rng.normal(scale=6.0, size=4096 * b)).astype(np.float32)
    llr[:4] = [400.0, -400.0, 0.0, 299.0]  # the +-300 clip and the 1e-30 floor
    ref_m, ref_v = jmod.soft_mapper(llr, M, const_type)
    out_m, out_v = tmod.soft_mapper(torch.as_tensor(llr), M, const_type)
    assert to_np(out_m).dtype == np.asarray(ref_m).dtype
    np.testing.assert_allclose(to_np(out_m), np.asarray(ref_m), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(out_v), np.asarray(ref_v), rtol=0, atol=1e-5)
    const = (tmod.gray_mapping(M, const_type) * 0.7).astype(np.complex64)
    bmap = tmod.bit_map(M, const_type)
    ref_m, ref_v = jmod.soft_estimator(llr.reshape(-1, b), bmap, const)
    out_m, out_v = tmod.soft_estimator(torch.as_tensor(llr.reshape(-1, b)), bmap,
                                       torch.as_tensor(const))
    np.testing.assert_allclose(to_np(out_m), np.asarray(ref_m), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(out_v), np.asarray(ref_v), rtol=0, atol=1e-5)
    # a complex128 NumPy constellation (the JAX package computes in complex64)
    const64 = (tmod.gray_mapping(M, const_type) * 0.7).astype(np.complex128)
    ref_m, ref_v = jmod.soft_estimator(llr.reshape(-1, b), bmap, const64)
    out_m, out_v = tmod.soft_estimator(torch.as_tensor(llr.reshape(-1, b)), bmap, const64)
    assert to_np(out_m).dtype == np.asarray(ref_m).dtype
    np.testing.assert_allclose(to_np(out_m), np.asarray(ref_m), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(out_v), np.asarray(ref_v), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["qam", "psk", "qam-shaped"])
def test_calc_extr_llr_matches_jax(kind):
    M, const_type = CONSTS[kind.split("-")[0]]
    shaped = kind.endswith("shaped")
    px = _shaped_px(M, const_type) if shaped else np.ones(M) / M
    rx, _, const = _noisy(M, const_type, px, n=2048, seed=2)
    b = int(np.log2(M))
    rng = np.random.default_rng(3)
    llr = rng.normal(scale=4.0, size=2048 * b).astype(np.float32)
    x_mu = (0.9 + 0.05 * rng.normal(size=2048)).astype(np.float32)
    x_nu = np.abs(0.2 * rng.normal(size=2048)).astype(np.float32)  # some under the floor
    bmap = tmod.bit_map(M, const_type)
    pj = px.astype(np.float32) if shaped else None
    ref = np.asarray(jmet.calc_extr_llr(llr, rx, x_mu, x_nu, const, bmap, pj))
    out = tmet.calc_extr_llr(torch.as_tensor(llr), torch.as_tensor(rx), torch.as_tensor(x_mu),
                             torch.as_tensor(x_nu), const, bmap, pj)
    assert out.shape == ref.shape
    np.testing.assert_allclose(to_np(out), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["qam", "psk", "qam-shaped"])
def test_calc_mi_and_monte_carlo_mi_match_jax(kind):
    M, const_type = CONSTS[kind.split("-")[0]]
    px = _shaped_px(M, const_type) if kind.endswith("shaped") else np.ones(M) / M
    rx, tx, const = _noisy(M, const_type, px, snr_db=10.0, seed=4)
    ref = float(jmet.calc_mi(rx, tx, 0.1, const, px))
    out = tmet.calc_mi(torch.as_tensor(rx), torch.as_tensor(tx), 0.1, const, px)
    assert abs(float(out) - ref) <= 1e-5
    rx2 = np.stack([rx, np.roll(rx, 1) * np.exp(0.3j)], axis=1)  # two modes, one rotated
    tx2 = np.stack([tx, np.roll(tx, 1)], axis=1)
    pj = px if kind.endswith("shaped") else None
    ref = np.asarray(jmet.monte_carlo_mi(rx2, tx2, M, const_type, pj))
    out = tmet.monte_carlo_mi(torch.as_tensor(rx2), torch.as_tensor(tx2), M, const_type, pj)
    assert out.shape == ref.shape == (2,)
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=1e-5)


def test_theory_mi_and_gn_model_equal_jax():
    assert tmet.theory_mi(4, "qam", 6.0, lim=6.0) == jmet.theory_mi(4, "qam", 6.0, lim=6.0)
    args = (32e9, 11, 37.5e9, 0.2, 1.3, 80, 10, 1.0, 16, 12.5e9, 193.1e12)
    assert tmet.gn_model_nyquist_wdm(*args) == jmet.gn_model_nyquist_wdm(*args)
    assert tmet.ase_nyquist_wdm(0.2, 80, 10, 4.5, 12.5e9, 193.1e12) == \
        jmet.ase_nyquist_wdm(0.2, 80, 10, 4.5, 12.5e9, 193.1e12)
    for a, b in zip(tmet.gn_model_osnr(32e9, 11, 37.5e9, [-2.0, 0.0, 3.0]),
                    jmet.gn_model_osnr(32e9, 11, 37.5e9, [-2.0, 0.0, 3.0])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmet.calc_lin_osnr(5, 0.0, 0.2, 50, 30.0),
                                  jmet.calc_lin_osnr(5, 0.0, 0.2, 50, 30.0))


@pytest.mark.parametrize("dist", ["uniform", "maxwell-boltzmann"])
def test_symbol_source_frequencies_and_types(dist):
    n = 2**18
    out = tsrc.symbol_source(torch.Generator().manual_seed(3), n, 16, "qam", dist, 0.1)
    ref = jsrc.symbol_source(jax.random.PRNGKey(0), 64, 16, "qam", dist, 0.1)
    assert out.dtype == torch.complex64 and np.asarray(ref).dtype == np.complex64
    px = tsrc.symbol_pmf(16, "qam", dist, 0.1)
    const = tsrc.constellation(16, "qam")
    const = const / np.sqrt(np.sum(px * np.abs(const) ** 2))
    idx = np.argmin(np.abs(to_np(out)[:, None] - const[None, :]), axis=1)
    freq = np.bincount(idx, minlength=16) / n
    assert np.all(np.abs(freq - px) <= 5 * np.sqrt(px * (1 - px) / n))
    pam = tsrc.symbol_source(5, 32, 4, "pam", device="cpu")
    assert to_np(pam).dtype == np.asarray(jsrc.symbol_source(5, 32, 4, "pam")).dtype == np.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsrc.symbol_source(5, 32)


# The JAX package's float32 phase loses precision as pi*M*n*(n+1)/N grows,
# so 1e-5 holds against it only at N = 16. Bound at each (N, M): 1.5 x the
# largest element error of the JAX package measured on the CPU (2.5e-6,
# 2.8e-5, 8.9e-4); no bound at 2**16, where that error reaches 0.020.
JAX_CAZAC_BOUND = {(16, 1): 1e-5, (63, 2): 4.2e-5, (1024, 3): 1.34e-3}


@pytest.mark.parametrize("N,M", [(16, 1), (63, 2), (1024, 3), (2**16, 1)])
def test_cazac_sequence(N, M):
    out = to_np(tsrc.cazac_sequence(N, M, device="cpu"))
    n = np.arange(N, dtype=np.float64)
    exact = np.exp(-1j * np.pi * M * n * (n + 1) / N)
    np.testing.assert_allclose(out, exact, rtol=0, atol=1e-6)
    if (N, M) in JAX_CAZAC_BOUND:
        ref = np.asarray(jsrc.cazac_sequence(N, M))
        np.testing.assert_allclose(out, ref, rtol=0, atol=JAX_CAZAC_BOUND[N, M])
    with pytest.raises(ValueError, match="coprime"):
        tsrc.cazac_sequence(8, 2, device="cpu")


def test_bit_arrays_match_jax():
    x = np.array([0, 1, 5, 255, 1023, 77])
    ref = np.asarray(jbits.dec2bitarray(x, 10))
    out = tbits.dec2bitarray(torch.as_tensor(x), 10)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(to_np(out), ref)
    np.testing.assert_array_equal(to_np(tbits.dec2bitarray(torch.tensor(6), 4)),
                                  np.asarray(jbits.dec2bitarray(6, 4)))
    np.testing.assert_array_equal(to_np(tbits.bitarray2dec(out.T)),
                                  np.asarray(jbits.bitarray2dec(ref.T)))
    assert int(tbits.bitarray2dec(torch.tensor([1, 0, 1, 1]))) == int(
        jbits.bitarray2dec(np.array([1, 0, 1, 1]))) == 11
