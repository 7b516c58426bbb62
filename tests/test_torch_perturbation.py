"""The port's perturbation model (opticommpy_torch.models.perturbation)
against the JAX package's on the same seeded NumPy inputs (CPU tensors).

Tolerances: the coefficient matrices are host SciPy in both packages and
equal bit for bit; the NLIN waveforms (float32 complex contractions summed
in another order) to 2e-6 relative, n_kept and the reduction exactly; the
port's 'fft' form against its own 'chunk' oracle to 1e-5 of the peak, the
JAX package's own pin (tests/test_perturbation.py).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.models import perturbation as jpert  # noqa: E402
from opticommpy_torch.models import perturbation as tpert  # noqa: E402

from _torch_parity import cpu, norm_qam, rel_err, to_np  # noqa: E402

REL = 2e-6
N_SYM = 4096


def _symbols(seed, n=N_SYM):
    rng = np.random.default_rng(seed)
    c = norm_qam(16)
    return c[rng.integers(0, 16, n)], c[rng.integers(0, 16, n)]


@pytest.mark.parametrize("kw", [dict(matrixOrder=10), dict(matrixOrder=25),
                                dict(matrixOrder=8, D=4.0, Rs=64e9, pulseWidth=0.3)],
                         ids=["L10", "L25", "other-link"])
def test_coeff_matrices_match_jax(kw):
    got = tpert.calc_pert_coeff_matrix(tpert.PerturbationConfig(**kw))
    want = jpert.calc_pert_coeff_matrix(jpert.PerturbationConfig(**kw))
    for g, w in zip(got, want):
        assert g.dtype == np.complex64
        np.testing.assert_array_equal(g, w)


def test_power_weighted_raises_like_jax():
    """The power-weighted form calls SciPy's gammaincc on complex input,
    which SciPy refuses, in the JAX package as in the port (mirrored)."""
    kw = dict(matrixOrder=6, powerWeighted=True, length=200.0)
    with pytest.raises(TypeError, match="gammaincc"):
        jpert.calc_pert_coeff_matrix(jpert.PerturbationConfig(**kw))
    with pytest.raises(TypeError, match="gammaincc"):
        tpert.calc_pert_coeff_matrix(tpert.PerturbationConfig(**kw))


@pytest.mark.parametrize("method", ["fft", "chunk"])
@pytest.mark.parametrize("order", [10, 25])
def test_calc_nlin_perturbation_matches_jax(order, method):
    _, cf, cx, cs = jpert.calc_pert_coeff_matrix(jpert.PerturbationConfig(matrixOrder=order))
    x, y = _symbols(order)
    want = jpert.calc_nlin_perturbation(cf, cx, cs, x, y, method=method)
    got = tpert.calc_nlin_perturbation(cf, cx, cs, cpu(x), cpu(y), method=method)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype in (torch.complex64, torch.float32)
        assert rel_err(g, np.asarray(w)) < REL


@pytest.mark.parametrize("tol", [-20.0, -30.0])
def test_amr_matches_jax(tol):
    _, cf, cx, cs = jpert.calc_pert_coeff_matrix(jpert.PerturbationConfig(matrixOrder=25))
    x, y = _symbols(3)
    want = jpert.calc_nlin_perturbation_simplified(cf, cx, cs, x, y, coeff_tol=tol)
    got = tpert.calc_nlin_perturbation_simplified(cf, cx, cs, cpu(x), cpu(y), coeff_tol=tol)
    assert got[4:] == tuple(want[4:])
    for g, w in zip(got[:4], want[:4]):
        assert rel_err(g, np.asarray(w)) < REL


@pytest.mark.parametrize("mode", ["AM", "AMR"])
def test_perturbation_nlin_matches_jax(mode):
    x, y = _symbols(4)
    e = np.stack([x, y], axis=1) * 0.7
    kw = dict(matrixOrder=10, mode=mode, Pin=3.0, coeffTol=-30.0)
    got = tpert.perturbation_nlin(cpu(e), tpert.PerturbationConfig(**kw))
    want = jpert.perturbation_nlin(e, jpert.PerturbationConfig(**kw))
    assert tuple(got.shape) == (N_SYM, 2) and got.dtype == torch.complex64
    assert rel_err(got, np.asarray(want)) < REL


def test_fft_matches_chunk_oracle():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=N_SYM) + 1j * rng.normal(size=N_SYM)).astype(np.complex64)
    y = (rng.normal(size=N_SYM) + 1j * rng.normal(size=N_SYM)).astype(np.complex64)
    _, cf, cx, cs = tpert.calc_pert_coeff_matrix(tpert.PerturbationConfig(matrixOrder=15))
    a = tpert.calc_nlin_perturbation(cf, cx, cs, cpu(x), cpu(y), method="chunk")
    b = tpert.calc_nlin_perturbation(cf, cx, cs, cpu(x), cpu(y), method="fft")
    for u, v in zip(a, b):
        u, v = to_np(u), to_np(v)
        assert np.max(np.abs(u - v)) / (np.max(np.abs(u)) + 1e-30) < 1e-5


def test_chunk_edges_and_tensor_coefficients():
    """A length that is not a multiple of the chunk, coefficients given as
    tensors, and a Python-complex ISPM coefficient give the same result."""
    _, cf, cx, cs = tpert.calc_pert_coeff_matrix(tpert.PerturbationConfig(matrixOrder=6))
    x, y = _symbols(6, n=1000)
    want = jpert.calc_nlin_perturbation(cf, cx, complex(cs), x, y, chunk=96, method="chunk")
    got = tpert.calc_nlin_perturbation(cpu(cf), cpu(cx), complex(cs), cpu(x), cpu(y),
                                       chunk=96, method="chunk")
    for g, w in zip(got, want):
        assert g.shape[0] == 1000 and rel_err(g, np.asarray(w)) < REL
