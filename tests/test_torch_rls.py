"""The RLS / DD-RLS equalizer: the port's plain recurrence and kernels' routing
against the JAX package's Pallas kernels (interpret mode) and scan rules.

Tolerances: atol 2e-4 on the equalized symbols and 1e-4 on the taps, the
JAX package's own pins between its RLS kernel and its scan rule
(tests/test_mimo_pallas.py:272-293); 3e-4 for multi-stage schedules that
begin with rls (its pin at tests/test_mimo_pallas.py:345-382); 1e-3 on Sd,
whose entries reach ~3 at lambda 0.999 (float32 rounding in the
recurrence). Batch against single in the port is bit-exact.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.dsp import equalization as jeq  # noqa: E402
from opticommpy_tpu.kernels.rls_pallas import (  # noqa: E402
    mimo_rls_pallas,
    mimo_rls_pallas_batch,
)
from opticommpy_torch.convert import (  # noqa: E402
    config_from_jax,
    sd_from_numpy,
    sd_to_numpy,
    taps_from_numpy,
    taps_to_numpy,
)
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.kernels import rls  # noqa: E402

from _torch_parity import (  # noqa: E402
    mixed_polmux,
    norm_qam,
    padded_modes,
    require_cuda,
    spike_taps,
    to_np,
)

Y_ATOL, H_ATOL, SD_ATOL = 2e-4, 1e-4, 1e-3
MULTI_ATOL = 3e-4
PSK8 = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)


def _psk_polmux(seed, n_sym):
    rng = np.random.default_rng(seed)
    sym = PSK8[rng.integers(0, 8, size=(n_sym, 2))]
    sig = np.zeros((2 * n_sym, 2), np.complex64)
    sig[::2] = sym
    sig += (0.01 * rng.normal(size=sig.shape)).astype(np.float32)
    return sig, sym


def _modes(seed, n_sym, n_modes):
    """n_modes-mode 16-QAM at 2 samples/symbol through a random mixing matrix."""
    rng = np.random.default_rng(seed)
    sym = norm_qam(16)[rng.integers(0, 16, size=(n_sym, n_modes))]
    x = np.zeros((2 * n_sym, n_modes), complex)
    x[::2] = sym
    h = np.eye(n_modes) + 0.1 * (rng.normal(size=(n_modes, n_modes))
                                 + 1j * rng.normal(size=(n_modes, n_modes)))
    sig = x @ h.T + 0.01 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    return sig.astype(np.complex64), sym.astype(np.complex64)


def _assert_close(port, jax_out, y_atol=Y_ATOL, h_atol=H_ATOL):
    y_t, h_t, sd_t = port
    y_j, h_j, sd_j = jax_out
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=y_atol)
    np.testing.assert_allclose(to_np(h_t), np.asarray(h_j), rtol=0, atol=h_atol)
    np.testing.assert_allclose(to_np(sd_t), np.asarray(sd_j), rtol=0, atol=SD_ATOL)


@pytest.mark.parametrize("alg", ["rls", "dd-rls"])
def test_rls_plain_matches_pallas(alg):
    sig, sym = mixed_polmux(50, 2000)
    const = norm_qam(16)
    out_j = mimo_rls_pallas(sig, sym, const, alg=alg, n_taps=7, sps=2, lam=0.999,
                            interpret=True)
    out_t = rls.mimo_rls_kernel(torch.as_tensor(sig), torch.as_tensor(sym), const,
                                alg=alg, n_taps=7, sps=2, lam=0.999)
    assert out_t[2].shape == (2, 7, 7)
    _assert_close(out_t, out_j)


def test_rls_4x4_matches_pallas():
    sig, sym = _modes(51, 1200, 4)
    const = norm_qam(16)
    out_j = mimo_rls_pallas(sig, sym, const, alg="rls", n_taps=5, sps=2, lam=0.999,
                            interpret=True)
    out_t = rls.mimo_rls_kernel(torch.as_tensor(sig), torch.as_tensor(sym), const,
                                alg="rls", n_taps=5, sps=2, lam=0.999)
    _assert_close(out_t, out_j)


def test_ddrls_8psk_takes_the_argmin_route():
    """Non-square dd-rls goes to the single-signal wrapper (K4), decides by
    the M-point argmin, and matches the JAX kernel `_rls_run`."""
    sig, _ = _psk_polmux(52, 1500)
    out_j = mimo_rls_pallas(sig, None, PSK8, alg="dd-rls", n_taps=7, sps=2, lam=0.999,
                            interpret=True)
    with mock.patch.object(rls, "rls_stage", wraps=rls.rls_stage) as k4, \
            mock.patch.object(rls, "rls_stage_batch", wraps=rls.rls_stage_batch) as k5:
        out_t = rls.mimo_rls_kernel(torch.as_tensor(sig), None, PSK8, alg="dd-rls",
                                    n_taps=7, sps=2, lam=0.999)
    assert (k4.call_count, k5.call_count) == (1, 0)
    _assert_close(out_t, out_j)


@pytest.mark.parametrize("alg", ["rls", "dd-rls"])
def test_rls_batch_matches_single_and_pallas(alg):
    """Batch == single per signal, bit for bit; batch vs the JAX batch kernel."""
    pairs = [mixed_polmux(60 + b, 400) for b in range(3)]
    sig_b = np.stack([p[0] for p in pairs])
    sym_b = np.stack([p[1] for p in pairs])
    const = norm_qam(16)
    ref_b = sym_b if alg == "rls" else None
    y_b, h_b, sd_b = rls.mimo_rls_kernel_batch(
        torch.as_tensor(sig_b), None if ref_b is None else torch.as_tensor(ref_b), const,
        alg=alg, n_taps=7, sps=2, lam=0.999)
    assert sd_b.shape == (3, 2, 7, 7)
    for b in range(3):
        y_s, h_s, sd_s = rls.mimo_rls_kernel(
            torch.as_tensor(sig_b[b]), None if ref_b is None else torch.as_tensor(sym_b[b]),
            const, alg=alg, n_taps=7, sps=2, lam=0.999)
        torch.testing.assert_close(y_b[b], y_s, rtol=0, atol=0)
        torch.testing.assert_close(h_b[b], h_s, rtol=0, atol=0)
        torch.testing.assert_close(sd_b[b], sd_s, rtol=0, atol=0)
    out_j = mimo_rls_pallas_batch(sig_b, ref_b, const, alg=alg, n_taps=7, sps=2,
                                  lam=0.999, block=128, interpret=True)
    _assert_close((y_b, h_b, sd_b), out_j)


def test_batched_ddrls_rejects_nonsquare():
    sig, _ = _psk_polmux(53, 200)
    with pytest.raises(ValueError, match="square-QAM"):
        rls.mimo_rls_kernel_batch(torch.as_tensor(sig[None]), None, PSK8, alg="dd-rls",
                                  n_taps=7)


def test_masked_tail_leaves_state_alone():
    """Symbols past n_sym never touch Sd or H: the final state equals that of
    a run whose signal ends right after the last live window, and matches
    the JAX kernel, which masks its zero-padded tail block."""
    sig, sym = mixed_polmux(54, 1000)
    n_sym, n_taps = 777, 7
    const = norm_qam(16)
    out_t = rls.mimo_rls_kernel(torch.as_tensor(sig), torch.as_tensor(sym[:n_sym]), const,
                                alg="rls", n_taps=n_taps, sps=2, lam=0.999)
    # the last window covers padded rows up to (n_sym - 1) * 2 + n_taps
    sig_pad, ref, h0, sd0 = rls._kernel_inputs(
        torch.as_tensor(sig)[None], torch.as_tensor(sym[:n_sym])[None], "rls", n_taps, 2,
        None, None)
    cut = sig_pad[:, :(n_sym - 1) * 2 + n_taps]
    y_c, h_c, sd_c = rls.rls_stage_plain(cut, ref, h0, sd0, const, "rls", 0.999, 2, n_taps,
                                         0, n_sym)
    torch.testing.assert_close(out_t[2], sd_c[0], rtol=0, atol=0)
    torch.testing.assert_close(out_t[1], h_c[0], rtol=0, atol=0)
    out_j = mimo_rls_pallas_batch(sig[None], sym[None, :n_sym], const, alg="rls",
                                  n_taps=n_taps, sps=2, lam=0.999, block=256,
                                  interpret=True)
    _assert_close(out_t, [a[0] for a in out_j])


@pytest.mark.parametrize("algs", [("rls", "dd-rls"), ("rls", "dd-lms")])
@pytest.mark.parametrize("backend", ["pallas", "scan"])
def test_multistage_rls_schedules_match_jax(backend, algs):
    sig, sym = mixed_polmux(55, 2500)
    jcfg = jeq.MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(1e-3, 1e-3), alg=algs,
                                   L=(800, 1700), M=16, numIter=2, backend=backend)
    y_j, H_j, _, e_j, _ = jeq.mimo_adapt_equalizer(sig, jcfg, symb_ref=sym,
                                                    return_results=True)
    y_t, H_t, _, e_t, _ = teq.mimo_adapt_equalizer(
        torch.as_tensor(sig), config_from_jax(jcfg), symb_ref=torch.as_tensor(sym),
        return_results=True)
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=MULTI_ATOL)
    np.testing.assert_allclose(taps_to_numpy(H_t), np.asarray(H_j), rtol=0, atol=MULTI_ATOL)
    np.testing.assert_allclose(to_np(e_t), np.asarray(e_j), rtol=0, atol=MULTI_ATOL)


def test_rls_stages_reach_the_batched_kernel_once_per_pass():
    """backend='pallas': each rls / square-QAM dd-rls pass is one call of the
    K5 wrapper (numIter=2 passes of stage 0, one of stage 1)."""
    sig, sym = mixed_polmux(56, 600)
    cfg = teq.MIMOEqualizerConfig(nTaps=7, SpS=2, alg=("rls", "dd-rls"), L=(300, 300),
                                  M=16, numIter=2, lambdaRLS=0.999, backend="pallas")
    with mock.patch.object(rls, "rls_stage_batch", wraps=rls.rls_stage_batch) as k5:
        y = teq.mimo_adapt_equalizer(torch.as_tensor(sig), cfg,
                                     symb_ref=torch.as_tensor(sym))
    assert k5.call_count == 3
    assert [c.args[5] for c in k5.call_args_list] == ["rls", "rls", "dd-rls"]
    assert torch.isfinite(y).all()


def test_nonsquare_ddrls_stage_runs_the_scan_rule():
    """8-PSK: the rls stage runs on K5, the dd-rls stage on the scan rule (as
    the JAX routing does), Sd chaining through; the result equals JAX's."""
    rng = np.random.default_rng(57)
    n_sym = 1200
    sym = PSK8[rng.integers(0, 8, size=(n_sym, 2))]
    x = np.zeros((2 * n_sym, 2), complex)
    x[::2] = sym
    h = np.array([[0.9, 0.15 + 0.05j], [-0.1 + 0.08j, 0.95]])
    sig = (x @ h.T + 0.01 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
           ).astype(np.complex64)
    jcfg = jeq.MIMOEqualizerConfig(nTaps=9, SpS=2, alg=("rls", "dd-rls"), L=(400, 800),
                                   M=8, constType="psk", lambdaRLS=0.999, backend="pallas")
    y_j = jeq.mimo_adapt_equalizer(sig, jcfg, symb_ref=sym.astype(np.complex64))
    with mock.patch.object(rls, "rls_stage_batch", wraps=rls.rls_stage_batch) as k5, \
            mock.patch.object(teq, "_adapt_eq_stage_scan",
                              wraps=teq._adapt_eq_stage_scan) as scan:
        y_t = teq.mimo_adapt_equalizer(torch.as_tensor(sig), config_from_jax(jcfg),
                                       symb_ref=torch.as_tensor(sym.astype(np.complex64)))
    assert (k5.call_count, scan.call_count) == (1, 1)
    assert scan.call_args.args[9] == "dd-rls"
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), rtol=0, atol=MULTI_ATOL)


def test_equalizer_module_carries_sd():
    """MIMOEqualizer keeps Sd between blocks: the second block starts from the
    first block's Sd, not from the identity."""
    sig, sym = mixed_polmux(58, 800)
    cfg = teq.MIMOEqualizerConfig(nTaps=7, SpS=2, alg=("rls",), M=16, lambdaRLS=0.999,
                                  backend="pallas")
    s1, r1 = torch.as_tensor(sig[:800]), torch.as_tensor(sym[:400])
    s2, r2 = torch.as_tensor(sig[800:]), torch.as_tensor(sym[400:])
    eq = teq.MIMOEqualizer(cfg, n_modes=2, device="cpu")
    assert eq.Sd.shape == (2, 7, 7) and "Sd" in dict(eq.named_buffers())
    torch.testing.assert_close(eq.Sd, torch.eye(7, dtype=torch.complex64).repeat(2, 1, 1))
    eq(s1, r1)
    _, H1, _, _, Sd1, _ = teq._mimo_adapt_equalizer(s1, cfg, symb_ref=r1)
    torch.testing.assert_close(eq.Sd, Sd1, rtol=0, atol=0)
    y2 = eq(s2, r2)
    y2_ref, H2, _, _, Sd2, _ = teq._mimo_adapt_equalizer(s2, cfg, symb_ref=r2, H=H1, Sd=Sd1)
    torch.testing.assert_close(y2, y2_ref, rtol=0, atol=0)
    torch.testing.assert_close(eq.Sd, Sd2, rtol=0, atol=0)
    y2_fresh = teq.mimo_adapt_equalizer(s2, cfg, symb_ref=r2, H=H1)
    assert not torch.equal(y2, y2_fresh)


def test_convert_carries_batched_taps_and_sd():
    """JAX's batched H (B, o, i, t) and Sd (B, i, T, T) go through the
    converters and warm-start the port's batched RLS as they warm-start
    JAX's."""
    pairs = [mixed_polmux(70 + b, 600) for b in range(2)]
    sig_b = np.stack([p[0] for p in pairs])
    sym_b = np.stack([p[1] for p in pairs])
    const = norm_qam(16)
    _, h_j, sd_j = mimo_rls_pallas_batch(sig_b[:, :600], sym_b[:, :300], const, alg="rls",
                                         n_taps=7, sps=2, lam=0.999, interpret=True)
    h_t = taps_from_numpy(np.asarray(h_j), device="cpu")
    sd_t = sd_from_numpy(np.asarray(sd_j), device="cpu")
    assert h_t.shape == (2, 2, 2, 7) and sd_t.shape == (2, 2, 7, 7)
    np.testing.assert_array_equal(taps_to_numpy(h_t), np.asarray(h_j))
    np.testing.assert_array_equal(sd_to_numpy(sd_t), np.asarray(sd_j))
    out_j = mimo_rls_pallas_batch(sig_b[:, 600:], sym_b[:, 300:], const, alg="rls",
                                  n_taps=7, sps=2, lam=0.999, H0=h_j, Sd0=sd_j,
                                  interpret=True)
    out_t = rls.mimo_rls_kernel_batch(torch.as_tensor(sig_b[:, 600:]),
                                      torch.as_tensor(sym_b[:, 300:]), const, alg="rls",
                                      n_taps=7, sps=2, lam=0.999, H0=h_t, Sd0=sd_t)
    _assert_close(out_t, out_j)


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["rls", "dd-rls"])
def test_batched_rls_kernel_matches_plain_on_gpu(alg):
    dev = require_cuda()
    pairs = [mixed_polmux(80 + b, 4096) for b in range(3)]
    sig = torch.as_tensor(np.stack([p[0] for p in pairs]), device=dev)
    sym = torch.as_tensor(np.stack([p[1] for p in pairs]), device=dev)
    const = norm_qam(16)
    sig_pad, ref, h0, sd0 = rls._kernel_inputs(sig, sym, alg, 15, 2, None, None)
    args = (sig_pad, ref, h0, sd0, const, alg, 0.99, 2, 15, 0, 4096)
    before = rls.batch_launches
    y_k, h_k, sd_k = rls.rls_stage_batch(*args)
    assert rls.batch_launches == before + 1
    y_p, h_p, sd_p = rls.rls_stage_plain(*args)
    torch.cuda.synchronize()
    assert float((y_k - y_p).abs().max()) < Y_ATOL
    assert float((h_k - h_p).abs().max()) < 1e-3
    for b in range(3):  # one signal alone through the same kernel: bit-identical
        y_1, h_1, sd_1 = rls.rls_stage_batch(*(a[b:b + 1] for a in args[:4]), *args[4:])
        assert torch.equal(y_1[0], y_k[b]) and torch.equal(sd_1[0], sd_k[b])


@pytest.mark.gpu
def test_argmin_rls_kernel_matches_plain_on_gpu():
    dev = require_cuda()
    sig, _ = _psk_polmux(90, 4096)
    sig_pad, ref, h0, sd0 = rls._kernel_inputs(torch.as_tensor(sig, device=dev)[None], None,
                                               "dd-rls", 15, 2, None, None)
    args = (sig_pad[0], ref[0], h0[0], sd0[0], PSK8, "dd-rls", 0.99, 2, 15, 0, 4096)
    before = rls.launches
    y_k, h_k, _ = rls.rls_stage(*args)
    assert rls.launches == before + 1
    y_p, h_p, _ = rls.rls_stage_plain(*(a[None] for a in args[:4]), *args[4:])
    torch.cuda.synchronize()
    assert float((y_k - y_p[0]).abs().max()) < Y_ATOL
    assert float((h_k - h_p[0]).abs().max()) < 1e-3


def test_config_lambda_reaches_the_kernel():
    """lambdaRLS is the forgetting factor the K5 wrapper receives."""
    sig, sym = mixed_polmux(59, 300)
    cfg = dataclasses.replace(teq.MIMOEqualizerConfig(nTaps=5, alg=("rls",), M=16,
                                                      backend="pallas"), lambdaRLS=0.995)
    with mock.patch.object(rls, "rls_stage_batch", wraps=rls.rls_stage_batch) as k5:
        teq.mimo_adapt_equalizer(torch.as_tensor(sig), cfg, symb_ref=torch.as_tensor(sym))
    assert k5.call_args.args[6] == 0.995


def _gpu_rls(dev, seed, modes, n_taps, alg, n_sym, *, const=None, n_batch=1, sps=2,
             n_start=0, lam=0.99, single=False, sd_scale=1.0):
    """K5 (K4 with ``single``) against the plain version on the card, one
    pass of ``n_sym`` symbols from symbol ``n_start`` with Sd0 = ``sd_scale``
    I: y within 2e-4, H within 1e-3 and Sd within 1e-3 of its largest entry
    (chip_smoke.py's pins). Returns the kernel's (y, H, Sd) and the
    arguments."""
    const = norm_qam(16) if const is None else const
    sig, sym = padded_modes(seed, n_batch, n_start + n_sym, modes, n_taps, sps, const)
    sd0 = sd_scale * np.broadcast_to(np.eye(n_taps, dtype=np.complex64),
                                     (n_batch, modes, n_taps, n_taps))
    args = tuple(torch.as_tensor(a, device=dev) for a in (
        sig, sym[:, n_start:], spike_taps(n_batch, modes, n_taps), sd0))
    args += (const, alg, lam, sps, n_taps, n_start, n_sym)
    if single:
        before = rls.launches
        out = rls.rls_stage(*(a[0] for a in args[:4]), *args[4:])
        out = tuple(o[None] for o in out)
        assert rls.launches == before + 1
    else:
        before = rls.batch_launches
        out = rls.rls_stage_batch(*args)
        assert rls.batch_launches == before + 1
    y_p, h_p, sd_p = rls.rls_stage_plain(*args)
    torch.cuda.synchronize()
    y_k, h_k, sd_k = out
    assert y_k.shape == (n_batch, n_sym, modes) and bool(torch.isfinite(y_k).all())
    if n_sym:
        assert float((y_k - y_p).abs().max()) < Y_ATOL
    assert float((h_k - h_p).abs().max()) < 1e-3
    assert float((sd_k - sd_p).abs().max() / sd_p.abs().max()) < SD_ATOL
    return out, args


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["0", "1", "chunk-1", "chunk", "chunk+1"])
def test_rls_kernel_chunk_edges_on_gpu(case):
    """Passes of 0, 1 and about one staged chunk of symbols."""
    dev = require_cuda()
    chunk = rls.chunk_symbols(2, 15, 2)
    n_sym = {"0": 0, "1": 1, "chunk-1": chunk - 1, "chunk": chunk,
             "chunk+1": chunk + 1}[case]
    _gpu_rls(dev, 60, 2, 15, "rls", n_sym)


@pytest.mark.gpu
@pytest.mark.parametrize("n_batch", [1, 2])
def test_rls_kernel_unaligned_start_on_gpu(n_batch):
    """n_start > 0 with a start offset (n_start * sps * modes = 3 values) off
    16-byte alignment; at B = 2 the second signal's base (311 rows x 3
    modes) is off it too."""
    dev = require_cuda()
    _gpu_rls(dev, 61, 3, 7, "rls", 300, n_batch=n_batch, sps=1, n_start=1)


@pytest.mark.gpu
@pytest.mark.parametrize("modes,n_taps", [(1, 7), (1, 16), (1, 32), (2, 15), (3, 7),
                                          (3, 16), (4, 16), (4, 32), (8, 7), (8, 16),
                                          (8, 32)])
def test_rls_kernel_instances_on_gpu(modes, n_taps):
    """Every template instance: taps padded to 8, 16 or 32, up to 2 or up to
    8 modes, including the 8-mode x 32-tap corner (64 KB of Sd).

    Sd0 = 0.01 I: from Sd0 = I the reference's per-input-mode RLS applies up
    to one full correction per input mode each symbol, so at 8 modes and 16
    or more taps it diverges (|y| in the hundreds after 200 symbols), and a
    1e-7 relative change of the input then moves y by more than the pins
    (plain version on the CPU: 6.7e-4 at 8 x 16, 2e-2 at 8 x 32); from 0.01
    I the same change moves y by ~1e-6 at every shape here."""
    dev = require_cuda()
    _gpu_rls(dev, 62 + modes + n_taps, modes, n_taps, "rls", 200, n_batch=2, sd_scale=0.01)


@pytest.mark.gpu
@pytest.mark.parametrize("order", [16, 64])
def test_rls_kernel_grid_slicer_on_gpu(order):
    """dd-rls on the quantized square-QAM slicer, 16-QAM and 64-QAM."""
    dev = require_cuda()
    const = norm_qam(order)
    _gpu_rls(dev, 63, 2, 15, "dd-rls", 600, const=const, n_batch=3)


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["rls", "dd-rls"])
def test_rls_kernel_b11_bit_identical_to_b1_on_gpu(alg):
    """K5 at B = 11: each signal equals K5 on it alone (B = 1) bit for bit."""
    dev = require_cuda()
    (y_b, h_b, sd_b), args = _gpu_rls(dev, 64, 2, 15, alg, 600, n_batch=11)
    for b in range(11):
        y_1, h_1, sd_1 = rls.rls_stage_batch(*(a[b:b + 1] for a in args[:4]), *args[4:])
        assert torch.equal(y_1[0], y_b[b]) and torch.equal(h_1[0], h_b[b])
        assert torch.equal(sd_1[0], sd_b[b])


@pytest.mark.gpu
@pytest.mark.parametrize("modes,n_taps", [(2, 15), (1, 7), (8, 32)])
def test_argmin_rls_kernel_instances_on_gpu(modes, n_taps):
    """K4: dd-rls on the argmin slicer over 8-PSK, one signal (Sd0 = 0.01 I,
    as for the instances of K5)."""
    dev = require_cuda()
    _gpu_rls(dev, 65, modes, n_taps, "dd-rls", 400, const=PSK8, single=True, sd_scale=0.01)
