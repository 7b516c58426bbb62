"""The blocked training stage (``blockUpdate = K > 1``) of the port against
the JAX package's ``_adapt_eq_stage_blocked`` route, single and batched, and
the route's gates.

Every rule the JAX function has (nlms, cma, dd-lms, rde, da-rde, static) at
K = 4, 8 and 16 on 1203 symbols, which leaves a remainder of 3 symbols after
the last whole block for the per-symbol rule. Tolerances: atol 2e-4 on the
equalized symbols and the squared errors and 1e-3 on the taps, the pins of
tests/test_torch_mimo.py (float32 rounding; a block's contraction sums in
another order than XLA's einsum). The batch trainer runs every block of all
B signals in one set of ops; per signal it equals the single trainer to
1e-6 (the same ops at another batch size).
"""

from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.dsp import equalization as jeq  # noqa: E402
from opticommpy_torch import pipelines as tpipe  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.kernels import bps, mimo_eq, rls  # noqa: E402

from _torch_parity import cpu, mixed_polmux, require_cuda, to_np  # noqa: E402

Y_ATOL, H_ATOL, SELF_ATOL = 2e-4, 1e-3, 1e-6
BLOCK_RULES = ["nlms", "cma", "dd-lms", "rde", "da-rde", "static"]
MU = {"nlms": 2e-3, "cma": 1e-3, "dd-lms": 1e-3, "rde": 1e-3, "da-rde": 2e-3, "static": 1e-3}
N_SYM = 1203  # 1203 = 16 * 75 + 3: a remainder at K = 4, 8 and 16


def _batch(seed, n_batch, n_sym):
    pairs = [mixed_polmux(seed + b, n_sym) for b in range(n_batch)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _cfg(alg, k, **kw):
    return jeq.MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(MU[alg],), alg=(alg,), M=16,
                                   numIter=2, blockUpdate=k, **kw)


def _assert_results_close(out_t, out_j):
    """(y, H, ..., errSq) of the port against JAX's; every shape equal."""
    y_t, H_t, e_t = out_t
    y_j, H_j, e_j = (np.asarray(a) for a in out_j)
    assert y_t.shape == y_j.shape and H_t.shape == H_j.shape and e_t.shape == e_j.shape
    np.testing.assert_allclose(to_np(y_t), y_j, rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(to_np(H_t), H_j, rtol=0, atol=H_ATOL)
    np.testing.assert_allclose(to_np(e_t), e_j, rtol=0, atol=Y_ATOL)


@pytest.mark.parametrize("k", [4, 8, 16])
@pytest.mark.parametrize("alg", BLOCK_RULES)
def test_blocked_stage_matches_jax(alg, k):
    """One stage, two passes (numIter=2), every symbol but the last 3 in
    whole blocks: the single trainer and the batch trainer against JAX's."""
    sig, sym = _batch(40 + BLOCK_RULES.index(alg), 2, N_SYM)
    jcfg = _cfg(alg, k)
    y_j, H_j, _, e_j, _ = jeq.mimo_adapt_equalizer(sig[0], jcfg, symb_ref=sym[0],
                                                    return_results=True)
    y_t, H_t, _, e_t, _ = teq.mimo_adapt_equalizer(
        cpu(sig[0]), config_from_jax(jcfg), symb_ref=cpu(sym[0]), return_results=True)
    _assert_results_close((y_t, H_t, e_t), (y_j, H_j, e_j))

    out_j = jeq.mimo_adapt_equalizer_batch(sig, jcfg, symb_ref=sym, return_results=True)
    with mock.patch.object(teq, "_adapt_eq_stage_blocked",
                           wraps=teq._adapt_eq_stage_blocked) as blk:
        out_b = teq.mimo_adapt_equalizer_batch(cpu(sig), config_from_jax(jcfg),
                                               symb_ref=cpu(sym), return_results=True)
    _assert_results_close(out_b, out_j)
    # one blocked call per pass for both signals, each on N_SYM // k blocks
    assert blk.call_count == 2
    assert all(c.args[0].shape[0] == 2 and c.args[11] == N_SYM // k * k
               for c in blk.call_args_list)
    torch.testing.assert_close(out_b[0][0], y_t, rtol=0, atol=SELF_ATOL)


@pytest.mark.parametrize("algs,mus,lengths", [
    (("da-rde", "dd-lms"), (5e-3, 1e-3), (601, 600)),
    (("nlms", "rls"), (2e-3, 1.0), (598, 603)),
    (("cma", "dd-lms"), (1e-3, 1e-3), (10, 1193)),
], ids=["darde_ddlms", "nlms_rls", "short_first_stage"])
def test_blocked_schedule_matches_jax(algs, mus, lengths):
    """Two-stage schedules at K = 16: taps and Sd chain across a blocked
    stage and an rls stage (never blocked), and a first stage shorter than
    K falls back to the per-symbol rule, as in the JAX package."""
    sig, sym = mixed_polmux(48, N_SYM)
    jcfg = jeq.MIMOEqualizerConfig(nTaps=7, SpS=2, mu=mus, alg=algs, L=lengths, M=16,
                                   numIter=2, blockUpdate=16, backend="pallas")
    y_j, H_j, _, e_j, _ = jeq.mimo_adapt_equalizer(sig, jcfg, symb_ref=sym,
                                                    return_results=True)
    with mock.patch.object(teq, "_adapt_eq_stage_blocked",
                           wraps=teq._adapt_eq_stage_blocked) as blk:
        y_t, H_t, _, e_t, _ = teq.mimo_adapt_equalizer(
            cpu(sig), config_from_jax(jcfg), symb_ref=cpu(sym), return_results=True)
    _assert_results_close((y_t, H_t, e_t), (y_j, H_j, e_j))
    # the blocked stages: numIter=2 passes of a first stage of >= 16 symbols,
    # one pass of a second gradient stage; rls is never blocked
    blocked = (2 if lengths[0] >= 16 else 0) + (algs[1] not in ("rls", "dd-rls"))
    assert blk.call_count == blocked


def test_blocked_rule_rejects_rls():
    """A rule the blocked stage lacks raises the JAX package's ValueError."""
    x = torch.zeros((1, 64, 2), dtype=torch.complex64)
    H = torch.zeros((1, 2, 2, 7), dtype=torch.complex64)
    with pytest.raises(ValueError, match="blockUpdate > 1 is not supported for algorithm 'rls'"):
        teq._adapt_eq_stage_blocked(x, x[:, :16], H, H, None, 1.0, None, 1e-3, "rls", 2, 7,
                                    16, False, 4)


def test_blocked_equalizer_module_carries_taps():
    """Two blocks through the module equal two chained functional calls at
    blockUpdate 8 with runWL (H_ carried as a buffer)."""
    sig, sym = mixed_polmux(49, 1200)
    cfg = teq.MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(2e-3,), alg=("nlms",), M=16,
                                  blockUpdate=8, runWL=True)
    eq = teq.MIMOEqualizer(cfg, n_modes=2, device="cpu")
    H = H_ = None
    for lo, hi in ((0, 600), (600, 1200)):
        s_blk, r_blk = cpu(sig[2 * lo:2 * hi], sym[lo:hi])
        y_mod = eq(s_blk, r_blk)
        y_fun, H, H_, _, _ = teq.mimo_adapt_equalizer(s_blk, cfg, symb_ref=r_blk, H=H,
                                                      H_=H_, return_results=True)
        torch.testing.assert_close(y_mod, y_fun, rtol=0, atol=0)
    torch.testing.assert_close(eq.H, H, rtol=0, atol=0)
    torch.testing.assert_close(eq.H_, H_, rtol=0, atol=0)
    assert torch.count_nonzero(eq.H_) > 0 and "H_" in dict(eq.named_buffers())


def _chain_inputs(n_sym=2048, seed=50):
    """A tiny polmux link at 8 samples/symbol (no fiber): 16-QAM symbols
    held for 8 samples through a 2x2 mixing matrix plus noise."""
    sig, sym = mixed_polmux(seed, n_sym, sps=1, noise=0.02)
    return np.repeat(sig, 8, axis=0), sym


@pytest.mark.parametrize("batch", [False, True], ids=["chain", "chain_batch"])
def test_blocked_chain_takes_k1_and_not_k2_k3(batch):
    """With blockUpdate 16 and eqBackend='pallas', the chains' training
    stages take the blocked route, so the equalizer kernels' wrappers are
    never called, and carrier recovery still calls K1's once."""
    sig, sym = _chain_inputs()
    cfg = tpipe.CoherentDSPConfig(SpS_in=8, nFilterTaps=64, L=0.001, nTrain=1024,
                                  mu=(5e-3, 1e-3), blockUpdate=16, eqBackend="pallas",
                                  cprBackend="pallas", cpr_window=25, cpr_phases=32)
    with mock.patch.object(bps, "bps_kernel", wraps=bps.bps_kernel) as k1, \
            mock.patch.object(mimo_eq, "mimo_eq_stage", wraps=mimo_eq.mimo_eq_stage) as k2, \
            mock.patch.object(mimo_eq, "mimo_eq_stage_batch",
                              wraps=mimo_eq.mimo_eq_stage_batch) as k3, \
            mock.patch.object(rls, "rls_stage_batch", wraps=rls.rls_stage_batch) as k5:
        if batch:
            y, _ = tpipe.coherent_dsp_chain_batch(cpu(sig[None]), cpu(sym[None]), cfg)
        else:
            y, _ = tpipe.coherent_dsp_chain(cpu(sig), cpu(sym), cfg)
    assert (k1.call_count, k2.call_count, k3.call_count, k5.call_count) == (1, 0, 0, 0)
    assert torch.isfinite(y).all()


@pytest.mark.gpu
@pytest.mark.parametrize("alg", BLOCK_RULES)
def test_blocked_stage_on_gpu_matches_cpu(alg):
    """The blocked stage of 3 signals on CUDA against the CPU, K = 16."""
    dev = require_cuda()
    sig, sym = _batch(60, 3, N_SYM)
    cfg = config_from_jax(_cfg(alg, 16))
    out_c = teq.mimo_adapt_equalizer_batch(cpu(sig), cfg, symb_ref=cpu(sym),
                                           return_results=True)
    out_g = teq.mimo_adapt_equalizer_batch(cpu(sig).to(dev), cfg, symb_ref=cpu(sym).to(dev),
                                           return_results=True)
    for a_g, a_c, atol in zip(out_g, out_c, (Y_ATOL, H_ATOL, Y_ATOL)):
        assert a_g.is_cuda
        np.testing.assert_allclose(to_np(a_g), to_np(a_c), rtol=0, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [False, True], ids=["chain", "chain_batch"])
def test_blocked_chain_on_gpu_launches_k1_only(batch):
    """On the card the blocked chains launch K1 once and K2 / K3 never
    (the kernels' own launch counters), and agree with the CPU run."""
    dev = require_cuda()
    sig, sym = _chain_inputs()
    cfg = tpipe.CoherentDSPConfig(SpS_in=8, nFilterTaps=64, L=0.001, nTrain=1024,
                                  mu=(5e-3, 1e-3), blockUpdate=16, eqBackend="pallas",
                                  cprBackend="pallas", cpr_window=25, cpr_phases=32)
    run = ((lambda s, r: tpipe.coherent_dsp_chain_batch(s[None], r[None], cfg)[0][0])
           if batch else (lambda s, r: tpipe.coherent_dsp_chain(s, r, cfg)[0]))
    y_c = run(*cpu(sig, sym))
    before = (bps.launches, mimo_eq.launches, mimo_eq.batch_launches)
    y_g = run(cpu(sig).to(dev), cpu(sym).to(dev))
    torch.cuda.synchronize()
    after = (bps.launches, mimo_eq.launches, mimo_eq.batch_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 0, 0)
    d = np.abs(to_np(y_g) - to_np(y_c))
    assert np.mean(d > 1e-4) <= 1e-3 and d.max() < 0.05, (np.mean(d > 1e-4), d.max())
