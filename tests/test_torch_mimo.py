"""The MIMO adaptive equalizer: the port's plain recurrence and kernel against
the JAX package's Pallas kernel (interpret mode) and scan rules.

Tolerances: atol 2e-4 on the equalized symbols and 1e-3 on the taps, the
JAX package's own pins between its scan rules and its kernel
(tests/test_mimo_pallas.py); float32 rounding in the recurrence.
"""

from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.dsp import equalization as jeq  # noqa: E402
from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas  # noqa: E402
from opticommpy_torch.convert import config_from_jax, taps_to_numpy  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.kernels import mimo_eq  # noqa: E402

from _torch_parity import mixed_polmux, norm_qam, require_cuda, to_np  # noqa: E402

Y_ATOL, H_ATOL = 2e-4, 1e-3
RULES = ["lms", "nlms", "cma", "rde", "da-rde"]


def _n_train(alg):
    return 1000 if alg == "lms" else 10**9


@pytest.mark.parametrize("alg", RULES)
def test_plain_recurrence_matches_pallas(alg):
    sig, sym = mixed_polmux(10 + RULES.index(alg), 3000)
    const = norm_qam(16)
    ref = None if alg in ("cma", "rde") else sym
    y_j, h_j = mimo_eq_pallas(sig, ref, const, alg=alg, n_taps=15, sps=2,
                              mu=1e-3, n_train=_n_train(alg), interpret=True)
    y_t, h_t = mimo_eq.mimo_eq_kernel(
        torch.as_tensor(sig), None if ref is None else torch.as_tensor(ref),
        const, alg=alg, n_taps=15, sps=2, mu=1e-3, n_train=_n_train(alg))
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(to_np(h_t), np.asarray(h_j), rtol=0, atol=H_ATOL)


def test_plain_recurrence_seven_taps_nonsquare():
    """7 taps and an 8-PSK constellation (decisions by the M-point argmin)."""
    c = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    rng = np.random.default_rng(3)
    sym = c[rng.integers(0, 8, size=(1500, 2))]
    sig = np.zeros((3000, 2), np.complex64)
    sig[::2] = sym
    sig += (0.01 * rng.normal(size=sig.shape)).astype(np.float32)
    y_j, h_j = mimo_eq_pallas(sig, sym, c, alg="lms", n_taps=7, sps=2, mu=2e-3,
                              n_train=300, interpret=True)
    y_t, h_t = mimo_eq.mimo_eq_kernel(torch.as_tensor(sig), torch.as_tensor(sym), c,
                                      alg="lms", n_taps=7, sps=2, mu=2e-3, n_train=300)
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(to_np(h_t), np.asarray(h_j), rtol=0, atol=H_ATOL)


@pytest.mark.parametrize("algs,mus", [
    (("da-rde", "dd-lms"), (5e-3, 1e-3)),
    (("nlms", "dd-lms"), (2e-3, 1e-3)),
    (("cma", "rde"), (1e-3, 1e-3)),
])
@pytest.mark.parametrize("backend", ["pallas", "scan"])
def test_mimo_adapt_equalizer_matches_jax(backend, algs, mus):
    sig, sym = mixed_polmux(20, 1600)
    jcfg = jeq.MIMOEqualizerConfig(nTaps=15, SpS=2, mu=mus, alg=algs,
                                   L=(600, 1000), M=16, numIter=2, backend=backend)
    y_j, H_j, _, e_j, _ = jeq.mimo_adapt_equalizer(sig, jcfg, symb_ref=sym,
                                                    return_results=True)
    y_t, H_t, _, e_t, _ = teq.mimo_adapt_equalizer(
        torch.as_tensor(sig), config_from_jax(jcfg), symb_ref=torch.as_tensor(sym),
        return_results=True)
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(taps_to_numpy(H_t), np.asarray(H_j), rtol=0, atol=H_ATOL)
    np.testing.assert_allclose(to_np(e_t), np.asarray(e_j), rtol=0, atol=Y_ATOL)


def test_kernel_entry_reached_once_per_pass():
    """Every pass of a backend='pallas' schedule goes through the kernel
    wrapper: numIter=2 passes of the first stage plus one of the second."""
    sig, sym = mixed_polmux(30, 1024)
    cfg = teq.MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(5e-3, 1e-3),
                                  alg=("da-rde", "dd-lms"), L=(512, 512), M=16,
                                  numIter=2, backend="pallas")
    with mock.patch.object(mimo_eq, "mimo_eq_stage",
                           wraps=mimo_eq.mimo_eq_stage) as spy:
        y = teq.mimo_adapt_equalizer(torch.as_tensor(sig), cfg,
                                     symb_ref=torch.as_tensor(sym))
    assert spy.call_count == 3
    assert [c.args[5] for c in spy.call_args_list] == ["da-rde", "da-rde", "lms"]
    assert torch.isfinite(y).all()


def test_equalizer_module_carries_taps():
    """Two blocks through the module equal two chained functional calls."""
    sig, sym = mixed_polmux(32, 1200)
    cfg = teq.MIMOEqualizerConfig(nTaps=9, SpS=2, mu=(2e-3,), alg=("nlms",), M=16,
                                  backend="pallas")
    blocks = [(torch.as_tensor(sig[:1200]), torch.as_tensor(sym[:600])),
              (torch.as_tensor(sig[1200:]), torch.as_tensor(sym[600:]))]
    eq = teq.MIMOEqualizer(cfg, n_modes=2)
    H = None
    for s_blk, r_blk in blocks:
        y_mod = eq(s_blk, r_blk)
        y_fun, H, _, _, _ = teq.mimo_adapt_equalizer(s_blk, cfg, symb_ref=r_blk, H=H,
                                                     return_results=True)
        torch.testing.assert_close(y_mod, y_fun, rtol=0, atol=0)
    torch.testing.assert_close(eq.H, H, rtol=0, atol=0)
    assert eq.H.shape == (2, 2, 9) and "H" in dict(eq.named_buffers())


@pytest.mark.parametrize("change", [
    dict(alg=("static",)), dict(alg=("nlms", "static"), L=(100, 100)),
    dict(runWL=True), dict(storeCoeff=True), dict(blockUpdate=16)])
def test_unported_options_raise(change):
    sig, sym = mixed_polmux(31, 256)
    cfg = teq.MIMOEqualizerConfig(nTaps=7, M=16, backend="pallas", **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teq.mimo_adapt_equalizer(torch.as_tensor(sig), cfg,
                                 symb_ref=torch.as_tensor(sym))


@pytest.mark.gpu
@pytest.mark.parametrize("alg", RULES)
def test_kernel_matches_plain_on_gpu(alg):
    dev = require_cuda()
    sig, sym = mixed_polmux(40, 4096)
    const = norm_qam(16)
    sig_pad = torch.zeros((8192 + 7 + 7 + 2 + 15, 2), dtype=torch.complex64, device=dev)
    sig_pad[7:7 + 8192] = torch.as_tensor(sig, device=dev)
    ref = torch.as_tensor(sym, device=dev)
    h0 = torch.zeros((2, 2, 15), dtype=torch.complex64, device=dev)
    h0[[0, 1], [0, 1], 7] = 1.0
    h_flat = h0.permute(0, 2, 1).reshape(2, 30)
    args = (sig_pad, ref, h_flat, const, mimo_eq.stage_aux(alg, const), alg, 1e-3,
            _n_train(alg), 2, 15, 0, 4096)
    before = mimo_eq.launches
    y_k, h_k = mimo_eq.mimo_eq_stage(*args)
    assert mimo_eq.launches == before + 1
    y_p, h_p = mimo_eq.mimo_eq_stage_plain(*args)
    torch.cuda.synchronize()
    assert float((y_k - y_p).abs().max()) < Y_ATOL
    assert float((h_k - h_p).abs().max()) < H_ATOL
