"""Drive the PyTorch port's coherent WDM paths once on one NVIDIA GPU.

Phases:
1. device: needs CUDA (exits non-zero otherwise); prints the card's
   ``nvidia-smi`` name and power limit; TF32 off for matmul and cuDNN.
2. build: compiles ``opticommpy_torch/csrc/*.cu`` with nvcc (one process
   per source, in parallel) into ``build/torch_kernels/``.
3. kernel vs plain: each Hopper kernel against its plain PyTorch version
   on the card, all timed with CUDA events: K1 blind phase search at the
   main path's shape (65,536 symbols x 2 modes, 64 test phases, 75-symbol
   window, 16-QAM) and on 8-PSK; K2, the MIMO equalizer, for each of its
   five rules at 4,096 symbols, 2x2, 15 taps, and at the main path's first
   training pass (12,000 symbols, da-rde); K3, the batched equalizer, for
   the five rules at B=3 x 4,096 symbols, bit-identical per signal to K2,
   and at B=11 x 12,000 symbols (da-rde); K5, the batched RLS, at B=11 x
   12,000 symbols for rls and dd-rls (lambda 0.99); K4, the single-signal
   RLS with the argmin slicer, on 8-PSK dd-rls at 4,096 symbols.
4. main path, launch counters reset just before and read just after:
   ``simple_wdm_tx`` (11 channels of 16-QAM polmux, 32 GBd, SpS 16, 2**18
   bits = 2**20 samples, 37.5 GHz grid, -2 dBm/ch, RRC 0.01 with 1024 taps,
   100 kHz linewidth) -> ``manakov_ssf`` (5 x 50 km, hz 0.5 km, fused
   linear steps, EDFA NF 4.5) -> LO (10 dBm, 100 kHz, 150 MHz offset) ->
   ``pdm_coherent_receiver`` -> reference sync of the centre channel ->
   ``coherent_dsp_chain`` (both kernel backends) -> BER, GMI, EVM after
   nTrain + 2000 symbols.
5. checks: every kernel launched on the main path (BPS >= 1, equalizer >= 3
   passes); BER <= 2 x the JAX package's BER + 1e-4 and GMI >= its GMI -
   0.05 bit per polarization (JAX numbers from
   ``tools/jax_main_path_reference.py`` on the CPU); the chain on CUDA
   agrees with the chain on the CPU (the kernels' plain versions) on the
   first 4,096 symbols.
6. WDM receiver, on the main path's field: every channel k received with
   its own LO at ``wdm_freq_grid(11, 37.5e9)[k]`` + 150 MHz and
   synchronized against its own symbols, then the 11 signals through
   ``coherent_dsp_chain_batch`` twice, each with the counters reset just
   before and read just after: with ("da-rde", "dd-lms") (K3 3 launches,
   K1 1, K2 none) and with ("rls", "dd-rls") (K5 3 launches, K1 1). Per
   channel and polarization BER <= 2 x ref + 1e-4 and GMI >= ref - 0.05,
   where ref is the same chain on the same input on the CPU (the kernels'
   plain versions); against the JAX package (numbers from
   ``tools/jax_wdm_receiver_reference.py``), whose noise realization
   differs and whose channels each slip or not by chance, the same bounds
   on the median over channels and polarizations. Each batch chain runs
   twice more and whether the outputs are bit-identical is printed, as is
   whether the Tx and the SSFM give bit-identical fields from one seed.
7. 8-PSK receiver (counters reset and read): ``mimo_rls_kernel`` with
   dd-rls on a 65,536-symbol 8-PSK polmux signal, which runs K4 once;
   symbol errors after convergence checked.
8. timing of every phase; then the kernels JSON line, and last the
   ``{"ok": true, "device": ...}`` line.

Usage: python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The JAX package (0.9.0) on the CPU at the same configuration, per
# polarization: JAX_PLATFORMS=cpu python tools/jax_main_path_reference.py
JAX_BER = (0.00016039350884966552, 0.0001652539212955162)
JAX_GMI = (3.9976260662078857, 3.9974942207336426)

# The JAX package (0.9.0) on the CPU at the WDM receiver's configuration,
# per channel (wdm_freq_grid order) and polarization:
# JAX_PLATFORMS=cpu python tools/jax_wdm_receiver_reference.py
JAX_WDM = {
    "da-rde/dd-lms": {
        "ber": ((0.017030874267220497, 0.01983046904206276),
                (2.430204585834872e-05, 1.9441637050476857e-05),
                (0.07539952546358109, 0.01874173805117607),
                (0.22153745591640472, 6.80457305861637e-05),
                (0.3827086389064789, 0.0),
                (0.0, 4.860409262619214e-06),
                (0.023368848487734795, 0.017069756984710693),
                (0.0, 0.0),
                (9.720818525238428e-06, 9.720818525238428e-06),
                (0.05900536850094795, 0.40994149446487427),
                (0.014070885255932808, 0.0013754958054050803)),
        "gmi": ((3.2259135246276855, 3.197892904281616),
                (3.9951305389404297, 3.995380401611328),
                (2.134824752807617, 3.221951961517334),
                (0.7447553873062134, 3.9989030361175537),
                (0.13728690147399902, 3.999997138977051),
                (3.9999923706054688, 3.999882221221924),
                (3.1183178424835205, 3.2072641849517822),
                (4.0, 3.9999992847442627),
                (3.9998843669891357, 3.9998855590820312),
                (2.428135633468628, -0.04863458871841431),
                (3.292764186859131, 3.8402929306030273))},
    "rls/dd-rls": {
        "ber": ((0.0010692899813875556, 0.0010352671379223466),
                (1.4581228242604993e-05, 1.9441637050476857e-05),
                (0.000121510231110733, 0.00018469555652700365),
                (0.0, 0.0),
                (0.0, 0.0),
                (4.860409262619214e-06, 4.860409262619214e-06),
                (0.0, 0.0),
                (0.0, 0.0),
                (9.720818525238428e-06, 9.720818525238428e-06),
                (0.0, 2.430204585834872e-05),
                (0.00017983514408115298, 0.00012637063628062606)),
        "gmi": ((3.39670467376709, 3.401531219482422),
                (3.9963152408599854, 3.9960179328918457),
                (3.9058847427368164, 3.883934259414673),
                (3.9999985694885254, 3.9999988079071045),
                (3.999997854232788, 3.999988317489624),
                (3.999959945678711, 3.999906301498413),
                (3.9999985694885254, 3.999997615814209),
                (3.9999988079071045, 3.9999890327453613),
                (3.999882936477661, 3.999645709991455),
                (3.999971389770508, 3.999647855758667),
                (3.9953064918518066, 3.9970946311950684))},
}

BPS_MAX_MISMATCH = 0.01  # the JAX package's near-tie rule
EQ_Y_ATOL, EQ_H_ATOL = 2e-4, 1e-3  # the JAX package's scan-vs-kernel pins


def _cuda_ms(fn, reps, warmup=True):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA events)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)  # name, power limit: exactly as nvidia-smi prints them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return torch.device("cuda:0")


def phase_build():
    from opticommpy_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_info.get('seconds', 0.0):.2f} s)")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def _noisy(rng, n, modes, const, snr_db=22.0, lw_ts=2e-6):
    sym = const[rng.integers(0, len(const), size=(n, modes))]
    phi = np.cumsum(rng.normal(scale=np.sqrt(2 * np.pi * lw_ts), size=(n, modes)), axis=0)
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    noise = sigma * (rng.normal(size=(n, modes)) + 1j * rng.normal(size=(n, modes)))
    return (sym * np.exp(1j * phi) + noise).astype(np.complex64)


def _polmux(dev, const, n_sym, seed):
    """(padded signal (rows, 2), symbols (n_sym, 2)) on ``dev``: symbols of
    ``const`` at 2 samples/symbol through a fixed 2x2 mixing matrix, noise
    0.01, padded by 7 zeros in front and 7 + 2 + 15 behind (15 taps)."""
    r = np.random.default_rng(seed)
    sym = const[r.integers(0, len(const), size=(n_sym, 2))]
    x = np.zeros((n_sym * 2, 2), complex)
    x[::2] = sym
    h = np.array([[0.9, 0.15 + 0.05j], [-0.1 + 0.08j, 0.95]])
    sig = x @ h.T + 0.01 * (r.normal(size=x.shape) + 1j * r.normal(size=x.shape))
    pad = np.zeros((7 + 2 * n_sym + 7 + 2 + 15, 2), np.complex64)
    pad[7:7 + 2 * n_sym] = sig
    return (torch.as_tensor(pad, device=dev),
            torch.as_tensor(sym.astype(np.complex64), device=dev))


def _polmux_batch(dev, const, n_batch, n_sym, seed):
    pairs = [_polmux(dev, const, n_sym, seed + b) for b in range(n_batch)]
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


def _spike(dev, n_batch, n_taps=15):
    h0 = torch.zeros((n_batch, 2, 2, n_taps), dtype=torch.complex64, device=dev)
    h0[:, [0, 1], [0, 1], n_taps // 2] = 1.0
    return h0


def phase_batch_kernels_vs_plain(dev, const):
    """K3, K4 and K5 against their plain versions on the card."""
    from opticommpy_torch.kernels import mimo_eq, rls

    report = {}
    # K3: five rules at B=3 x 4096, and bit-identity with K2 per signal
    h_flat = _spike(dev, 3).permute(0, 1, 3, 2).reshape(3, 2, 30)
    worst, k2_diff = 0.0, 0.0
    for i, alg in enumerate(("lms", "nlms", "cma", "rde", "da-rde")):
        sig_pad, ref = _polmux_batch(dev, const, 3, 4096, 100 + 10 * i)
        args = (const, mimo_eq.stage_aux(alg, const), alg, 1e-3,
                1000 if alg == "lms" else 4096, 2, 15, 0, 4096)
        y_k, h_k = mimo_eq.mimo_eq_stage_batch(sig_pad, ref, h_flat, *args)
        y_p, h_p = mimo_eq.mimo_eq_stage_batch_plain(sig_pad, ref, h_flat, *args)
        singles = [mimo_eq.mimo_eq_stage(sig_pad[b], ref[b], h_flat[b], *args)
                   for b in range(3)]
        y_err = float((y_k - y_p).abs().max())
        h_err = float((h_k - h_p).abs().max())
        same = max(max(float((y_k[b] - ys).abs().max()), float((h_k[b] - hs).abs().max()))
                   for b, (ys, hs) in enumerate(singles))
        ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage_batch(sig_pad, ref, h_flat, *args), 10)
        plain_ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage_batch_plain(
            sig_pad, ref, h_flat, *args), 1, warmup=False)
        print(f"K3 mimo_eq_batch {alg} (B=3 x 4096 sym, 2x2, 15 taps): max |y err| "
              f"{y_err:.3e}, max |H err| {h_err:.3e}, max |K3 - K2| {same:.1e}, "
              f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
        _check(y_err < EQ_Y_ATOL and h_err < EQ_H_ATOL,
               f"batched equalizer kernel disagrees with plain ({alg})")
        _check(same == 0.0, f"K3 is not bit-identical to K2 per signal ({alg})")
        _check(bool(torch.isfinite(y_k).all()), f"K3 output not finite ({alg})")
        worst, k2_diff = max(worst, y_err), max(k2_diff, same)

    # K3 at the WDM path's first training pass: B=11 x 12000 symbols, da-rde
    sig_pad, ref = _polmux_batch(dev, const, 11, 12000, 200)
    h_flat = _spike(dev, 11).permute(0, 1, 3, 2).reshape(11, 2, 30)
    args = (const, mimo_eq.stage_aux("da-rde", const), "da-rde", 5e-3, 0, 2, 15, 0, 12000)
    ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage_batch(sig_pad, ref, h_flat, *args), 5)
    plain_ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage_batch_plain(
        sig_pad, ref, h_flat, *args), 1, warmup=False)
    y_k, _ = mimo_eq.mimo_eq_stage_batch(sig_pad, ref, h_flat, *args)
    y_p, _ = mimo_eq.mimo_eq_stage_batch_plain(sig_pad, ref, h_flat, *args)
    err = float((y_k - y_p).abs().max())
    print(f"K3 mimo_eq_batch da-rde (B=11 x 12000 sym, 2x2, 15 taps): max |y err| "
          f"{err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    _check(err < EQ_Y_ATOL, "batched equalizer kernel disagrees with plain (B=11)")
    report["mimo_eq_batch"] = dict(max_abs_err=max(worst, err), ms=ms, plain_ms=plain_ms)
    report["k3_vs_k2_max_abs_diff"] = k2_diff

    # K5: the batched RLS at B=11 x 12000 symbols, lambda 0.99 (the chain's)
    sd0 = torch.eye(15, dtype=torch.complex64, device=dev).repeat(11, 2, 1, 1)
    h0 = _spike(dev, 11)
    worst, times = 0.0, []
    for alg in ("rls", "dd-rls"):
        args = (sig_pad, ref, h0, sd0, const, alg, 0.99, 2, 15, 0, 12000)
        y_k, h_k, s_k = rls.rls_stage_batch(*args)
        y_p, h_p, s_p = rls.rls_stage_plain(*args)
        y_err = float((y_k - y_p).abs().max())
        h_err = float((h_k - h_p).abs().max())
        sd_rel = float((s_k - s_p).abs().max() / s_p.abs().max())
        ms = _cuda_ms(lambda: rls.rls_stage_batch(*args), 3)
        plain_ms = _cuda_ms(lambda: rls.rls_stage_plain(*args), 1, warmup=False)
        print(f"K5 rls_batch {alg} (B=11 x 12000 sym, 2x2, 15 taps, lambda 0.99): "
              f"max |y err| {y_err:.3e}, max |H err| {h_err:.3e}, Sd rel err "
              f"{sd_rel:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
        _check(y_err < EQ_Y_ATOL and h_err < EQ_H_ATOL and sd_rel < EQ_H_ATOL,
               f"RLS kernel disagrees with plain ({alg})")
        _check(bool(torch.isfinite(y_k).all()), f"K5 output not finite ({alg})")
        worst = max(worst, y_err)
        times.append((ms, plain_ms))
    report["rls_batch"] = dict(max_abs_err=worst, ms=times[0][0], plain_ms=times[0][1])

    # K4: the single-signal RLS with the argmin slicer, 8-PSK dd-rls
    psk = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    sig_pad, ref = _polmux(dev, psk, 4096, 300)
    args = (sig_pad, ref, _spike(dev, 1)[0], sd0[0], psk, "dd-rls", 0.99, 2, 15, 0, 4096)
    y_k, h_k, s_k = rls.rls_stage(*args)
    y_p, h_p, s_p = rls.rls_stage_plain(*(a[None] for a in args[:4]), *args[4:])
    y_err = float((y_k - y_p[0]).abs().max())
    h_err = float((h_k - h_p[0]).abs().max())
    ms = _cuda_ms(lambda: rls.rls_stage(*args), 5)
    plain_ms = _cuda_ms(lambda: rls.rls_stage_plain(*(a[None] for a in args[:4]), *args[4:]),
                        1, warmup=False)
    print(f"K4 rls argmin dd-rls 8-PSK (4096 sym, 2x2, 15 taps, lambda 0.99): max |y err| "
          f"{y_err:.3e}, max |H err| {h_err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    _check(y_err < EQ_Y_ATOL and h_err < EQ_H_ATOL, "K4 disagrees with plain (8-PSK)")
    report["rls_argmin"] = dict(max_abs_err=y_err, ms=ms, plain_ms=plain_ms)
    return report


def phase_kernels_vs_plain(dev, const):
    from opticommpy_torch.kernels import bps, mimo_eq

    rng = np.random.default_rng(1)
    report = {}

    # K1: blind phase search
    psk = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    for label, c, n in (("qam16", const, 65536), ("psk8", psk, 20000)):
        sig = torch.as_tensor(_noisy(rng, n, 2, c), device=dev)
        est_k = bps.bps_kernel(sig, 37, c, 64)
        idx_k = bps.bps_indices(sig, 37, c, 64)
        idx_p = bps.bps_indices_plain(sig, 37, c, 64)
        est_p = bps._test_phases(64, dev)[0][idx_p]
        torch.cuda.synchronize()
        mismatch = float((idx_k != idx_p).float().mean())
        err = float((est_k - est_p).abs().max())
        ms = _cuda_ms(lambda: bps.bps_indices(sig, 37, c, 64), 20)
        plain_ms = _cuda_ms(lambda: bps.bps_indices_plain(sig, 37, c, 64), 5)
        print(f"K1 bps {label} ({n}x2, B=64, n_half=37): index mismatch {mismatch:.2e}, "
              f"max |phase err| {err:.3e} rad, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        _check(mismatch < BPS_MAX_MISMATCH, f"BPS kernel disagrees with plain ({label})")
        if label == "qam16":
            report["bps"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # K2: the adaptive equalizer recurrence, each rule
    def polmux(n_sym, seed):
        return _polmux(dev, const, n_sym, seed)

    h0 = torch.zeros((2, 2, 15), dtype=torch.complex64, device=dev)
    h0[[0, 1], [0, 1], 7] = 1.0
    h_flat = h0.permute(0, 2, 1).reshape(2, 30)
    worst = 0.0
    for i, alg in enumerate(("lms", "nlms", "cma", "rde", "da-rde")):
        sig_pad, ref = polmux(4096, 10 + i)
        args = (sig_pad, ref, h_flat, const, mimo_eq.stage_aux(alg, const), alg, 1e-3,
                1000 if alg == "lms" else 4096, 2, 15, 0, 4096)
        y_k, h_k = mimo_eq.mimo_eq_stage(*args)
        (y_p, h_p), plain_s = _wall(lambda: mimo_eq.mimo_eq_stage_plain(*args))
        y_err = float((y_k - y_p).abs().max())
        h_err = float((h_k - h_p).abs().max())
        ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage(*args), 10)
        print(f"K2 mimo_eq {alg} (4096 sym, 2x2, 15 taps): max |y err| {y_err:.3e}, "
              f"max |H err| {h_err:.3e}, kernel {ms:.3f} ms, plain {plain_s * 1e3:.1f} ms")
        _check(y_err < EQ_Y_ATOL and h_err < EQ_H_ATOL,
               f"equalizer kernel disagrees with plain ({alg})")
        _check(bool(torch.isfinite(y_k).all()), f"equalizer output not finite ({alg})")
        worst = max(worst, y_err)

    # the main path's first training pass: 12000 symbols of da-rde
    sig_pad, ref = polmux(12000, 20)
    args = (sig_pad, ref, h_flat, const, mimo_eq.stage_aux("da-rde", const), "da-rde",
            5e-3, 0, 2, 15, 0, 12000)
    ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage(*args), 5)
    (y_p, _), plain_s = _wall(lambda: mimo_eq.mimo_eq_stage_plain(*args))
    y_k, _ = mimo_eq.mimo_eq_stage(*args)
    err = float((y_k - y_p).abs().max())
    print(f"K2 mimo_eq da-rde (12000 sym, 2x2, 15 taps): max |y err| {err:.3e}, "
          f"kernel {ms:.3f} ms, plain {plain_s * 1e3:.1f} ms")
    _check(err < EQ_Y_ATOL, "equalizer kernel disagrees with plain (12000 symbols)")
    report["mimo_eq"] = dict(max_abs_err=max(worst, err), ms=ms, plain_ms=plain_s * 1e3)
    return report


def run_main_path(dev, n_bits=2**18, n_channels=11, n_train=12000):
    from opticommpy_torch.comm.metrics import calc_evm, fast_ber_calc, monte_carlo_gmi
    from opticommpy_torch.dsp import EDCConfig, edc
    from opticommpy_torch.models import (LaserConfig, PDMFrontendConfig, SSFMConfig,
                                         basic_laser_model, manakov_ssf,
                                         pdm_coherent_receiver)
    from opticommpy_torch.models.tx import WDMTxConfig, simple_wdm_tx, wdm_freq_grid
    from opticommpy_torch.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync
    from opticommpy_torch.pipelines import CoherentDSPConfig, coherent_dsp_chain

    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=16, nBits=n_bits, nChannels=n_channels,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(-2.0,), wdmGridSpacing=37.5e9,
                         laserLinewidth=100e3)
    fs = cfg_tx.Fs
    (sig_tx, symb_tx, _), times["tx_s"] = _wall(lambda: simple_wdm_tx(gen, cfg_tx))
    cfg_ch = SSFMConfig(Ltotal=250, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3,
                        Fs=fs, amp="edfa", NF=4.5, nlprMethod=False, trapIters=1,
                        fusedLinear=True)
    sig_ch, times["ssfm_s"] = _wall(lambda: manakov_ssf(sig_tx, cfg_ch, gen))
    lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=fs,
                                       freqShift=150e6, RIN_var=0.0), gen)
    sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), generator=gen)
    centre = int(np.flatnonzero(wdm_freq_grid(n_channels, 37.5e9) == 0.0)[0])
    pre = decimate(fir_filter(pulse_shape("rrc", 16, 1024, 0.01), sig_rx), 16, 2)
    pre = edc(pre, EDCConfig(L=250, D=16, Fs=64e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(pre, symb_tx[:, :, centre], 2))
    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=n_train, mu=(5e-3, 2e-3),
                            eqBackend="pallas", cprBackend="pallas")
    (y, phases), times["dsp_s"] = _wall(lambda: coherent_dsp_chain(sig_rx, d_ref, cfg))
    disc = cfg.nTrain + 2000
    yy, dd = y[disc:-100], d_ref[disc:-100]
    ber, _, snr = fast_ber_calc(yy, dd, 16, "qam")
    gmi, _ = monte_carlo_gmi(yy, dd, 16, "qam")
    evm = calc_evm(yy, 16, "qam", symb_tx=dd)
    out = dict(sig_tx=sig_tx, symb_tx=symb_tx, sig_ch=sig_ch, sig_rx=sig_rx, d_ref=d_ref, y=y,
               phases=phases, cfg=cfg, cfg_ch=cfg_ch, gen=gen,
               ber=ber.cpu().numpy(), gmi=gmi.cpu().numpy(), evm=evm.cpu().numpy(),
               snr=snr.cpu().numpy())
    return out, times


def receive_wdm(res, n_channels=11):
    """Every channel of the main path's field through its own LO and front
    end: (received signals (B, N, 2), synchronized references (B, nSym, 2))."""
    from opticommpy_torch.dsp import EDCConfig, edc
    from opticommpy_torch.models import (LaserConfig, PDMFrontendConfig,
                                         basic_laser_model, pdm_coherent_receiver)
    from opticommpy_torch.models.tx import wdm_freq_grid
    from opticommpy_torch.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync

    sig_ch, gen = res["sig_ch"], res["gen"]
    fs = 16 * 32e9
    pulse = pulse_shape("rrc", 16, 1024, 0.01)
    sigs, refs = [], []
    for k, f_k in enumerate(wdm_freq_grid(n_channels, 37.5e9)):
        lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=fs,
                                           freqShift=float(f_k) + 150e6, RIN_var=0.0), gen)
        sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), generator=gen)
        pre = edc(decimate(fir_filter(pulse, sig_rx), 16, 2),
                  EDCConfig(L=250, D=16, Fs=64e9, Rs=32e9))
        refs.append(pnorm(symbol_sync(pre, res["symb_tx"][:, :, k], 2)))
        sigs.append(sig_rx)
    return torch.stack(sigs), torch.stack(refs)


def _wdm_scores(y, ref, disc):
    """Per channel (BER, GMI, EVM) arrays of shape (2,) after ``disc`` symbols."""
    from opticommpy_torch.comm.metrics import calc_evm, fast_ber_calc, monte_carlo_gmi

    rows = []
    for k in range(y.shape[0]):
        yy, dd = y[k, disc:-100], ref[k, disc:-100]
        ber, _, _ = fast_ber_calc(yy, dd, 16, "qam")
        gmi, _ = monte_carlo_gmi(yy, dd, 16, "qam")
        evm = calc_evm(yy, 16, "qam", symb_tx=dd)
        rows.append(tuple(t.cpu().numpy() for t in (ber, gmi, evm)))
    return rows


def run_wdm_paths(dev, res, n_channels=11, n_train=12000):
    """The 11-channel receiver: both training schedules through
    coherent_dsp_chain_batch, each with its launch counts."""
    from dataclasses import replace

    from opticommpy_torch.kernels import bps, mimo_eq, rls
    from opticommpy_torch.pipelines import CoherentDSPConfig, coherent_dsp_chain_batch

    (sig_b, ref_b), rx_s = _wall(lambda: receive_wdm(res, n_channels))
    n_sym = ref_b.shape[1]
    print(f"WDM receive: {rx_s:.3f} s for {n_channels} channels, signals "
          f"{tuple(sig_b.shape)}")
    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=n_train, mu=(5e-3, 2e-3),
                            eqBackend="pallas", cprBackend="pallas")
    failures, out = [], {}
    for name, algs in (("da-rde/dd-lms", ("da-rde", "dd-lms")),
                       ("rls/dd-rls", ("rls", "dd-rls"))):
        cfg_s = replace(cfg, alg=algs)
        bps.launches = mimo_eq.launches = mimo_eq.batch_launches = 0
        rls.launches = rls.batch_launches = 0
        (y, phases), first_s = _wall(lambda: coherent_dsp_chain_batch(sig_b, ref_b, cfg_s))
        counts = dict(bps=bps.launches, mimo_eq=mimo_eq.launches,
                      mimo_eq_batch=mimo_eq.batch_launches, rls=rls.launches,
                      rls_batch=rls.batch_launches)
        print(f"WDM {name} launches: {counts}")
        if name == "da-rde/dd-lms":
            expect = dict(bps=1, mimo_eq=0, mimo_eq_batch=3, rls=0, rls_batch=0)
        else:
            expect = dict(bps=1, mimo_eq=0, mimo_eq_batch=0, rls=0, rls_batch=3)
        _check(counts == expect, f"WDM {name}: launches {counts}, expected {expect}")
        _check(tuple(y.shape) == (n_channels, n_sym, 2) and y.device == dev
               and tuple(phases.shape) == (n_sym, 2 * n_channels),
               f"unexpected output {tuple(y.shape)}")
        _check(bool(torch.isfinite(y).all()), f"WDM {name}: non-finite output")
        (y2, _), warm_s = _wall(lambda: coherent_dsp_chain_batch(sig_b, ref_b, cfg_s))
        y3, _ = coherent_dsp_chain_batch(sig_b, ref_b, cfg_s)
        same = bool(torch.equal(y, y2)) and bool(torch.equal(y2, y3))
        print(f"WDM {name}: first {first_s:.3f} s, warm {warm_s:.3f} s, "
              f"{n_channels * n_sym / warm_s / 1e6:.4f} Msym/s aggregate; three runs "
              f"bit-identical: {same} (max |diff| {float((y - y2).abs().max()):.3e})")
        disc = cfg.nTrain + 2000
        scores = _wdm_scores(y, ref_b, disc)
        # the same chain on the same input on the CPU (the kernels' plain
        # versions): the per-channel reference
        (y_cpu, _), cpu_s = _wall(lambda: coherent_dsp_chain_batch(
            sig_b.cpu(), ref_b.cpu(), cfg_s))
        d = (y.cpu() - y_cpu).abs()
        print(f"WDM {name} batch chain on the CPU (plain versions, all channels): "
              f"{cpu_s:.1f} s, CUDA vs CPU max |diff| {float(d.max()):.3e}, share > "
              f"1e-3: {float((d > 1e-3).float().mean()):.2e}")
        cpu = _wdm_scores(y_cpu, ref_b.cpu(), disc)
        jax_ber, jax_gmi = JAX_WDM[name]["ber"], JAX_WDM[name]["gmi"]
        far = (d > 1e-3).float().mean(dim=(1, 2))  # per channel
        for k, (ber, gmi, evm) in enumerate(scores):
            print(f"  ch {k:2d}: CUDA vs CPU share > 1e-3 {float(far[k]):.2e}; "
                  f"BER {ber[0]:.3e} {ber[1]:.3e} (CPU {cpu[k][0][0]:.3e} "
                  f"{cpu[k][0][1]:.3e}, JAX {jax_ber[k][0]:.3e} {jax_ber[k][1]:.3e}), "
                  f"GMI {gmi[0]:.4f} {gmi[1]:.4f} (CPU {cpu[k][1][0]:.4f} "
                  f"{cpu[k][1][1]:.4f}, JAX {jax_gmi[k][0]:.4f} {jax_gmi[k][1]:.4f}), "
                  f"EVM {evm[0]:.4f} {evm[1]:.4f}")
            for p in range(2):
                if not (ber[p] <= 2 * cpu[k][0][p] + 1e-4 and gmi[p] >= cpu[k][1][p] - 0.05):
                    failures.append(f"{name} ch {k} pol {p}: BER {ber[p]:.3e} GMI "
                                    f"{gmi[p]:.4f} vs CPU {cpu[k][0][p]:.3e} "
                                    f"{cpu[k][1][p]:.4f}")
        # against the JAX package, whose noise realization differs: the
        # median over channels and polarizations
        med_ber = float(np.median([r[0] for r in scores]))
        med_gmi = float(np.median([r[1] for r in scores]))
        jax_med_ber = float(np.median(jax_ber[:n_channels]))
        jax_med_gmi = float(np.median(jax_gmi[:n_channels]))
        n_ok = sum(int(r[0][p] < 1e-3) for r in scores for p in range(2))
        n_ok_jax = sum(int(b < 1e-3) for r in jax_ber[:n_channels] for b in r)
        print(f"WDM {name}: median BER {med_ber:.3e} (JAX {jax_med_ber:.3e}), median GMI "
              f"{med_gmi:.4f} (JAX {jax_med_gmi:.4f}); polarizations with BER < 1e-3: "
              f"{n_ok} of {2 * n_channels} (JAX {n_ok_jax})")
        if not (med_ber <= 2 * jax_med_ber + 1e-4 and med_gmi >= jax_med_gmi - 0.05):
            failures.append(f"{name}: median BER {med_ber:.3e} GMI {med_gmi:.4f} vs JAX "
                            f"{jax_med_ber:.3e} {jax_med_gmi:.4f}")
        out[name] = dict(counts=counts, warm_s=warm_s, same=same, cfg=cfg_s)
    _check(not failures, "WDM bounds failed:\n  " + "\n  ".join(failures))
    return out


def run_psk_path(dev, n_sym=65536):
    """8-PSK polmux through mimo_rls_kernel (dd-rls): the K4 route."""
    from opticommpy_torch.kernels import rls

    psk = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    sig_pad, sym = _polmux(dev, psk, n_sym, 400)
    sig = sig_pad[7:7 + 2 * n_sym]
    rls.launches = rls.batch_launches = 0
    (y, H, Sd), s = _wall(lambda: rls.mimo_rls_kernel(sig, None, psk, alg="dd-rls",
                                                      n_taps=15, sps=2, lam=0.99))
    counts = dict(rls=rls.launches, rls_batch=rls.batch_launches)
    c = torch.as_tensor(psk, device=dev)
    dec = c[torch.argmin((y[2000:, :, None] - c).abs(), dim=-1)]
    ser = float((dec != sym[2000:]).float().mean())
    print(f"8-PSK dd-rls (mimo_rls_kernel, {n_sym} sym): {s:.3f} s, launches {counts}, "
          f"SER after 2000 symbols {ser:.2e}")
    _check(counts == dict(rls=1, rls_batch=0), f"8-PSK path launches {counts}")
    _check(bool(torch.isfinite(y).all()) and ser < 1e-3, f"8-PSK path SER {ser}")
    return counts


def main():
    dev = phase_device()
    phase_build()
    from opticommpy_torch.kernels import bps, mimo_eq
    from opticommpy_torch.pipelines import _norm_const

    const = _norm_const(16)
    report = phase_kernels_vs_plain(dev, const)
    report.update(phase_batch_kernels_vs_plain(dev, const))

    bps.launches = 0
    mimo_eq.launches = 0
    res, times = run_main_path(dev)
    launches = {"bps": bps.launches, "mimo_eq": mimo_eq.launches}
    print(f"main path launches: {launches}")

    n_samples = res["sig_tx"].shape[0]
    n_sym = res["d_ref"].shape[0]
    print(f"Tx: {times['tx_s']:.3f} s for {tuple(res['sig_tx'].shape)} samples x pols")
    print(f"SSFM: {times['ssfm_s']:.3f} s, {n_samples / times['ssfm_s']:.4e} samples/s "
          "(first call, 500 steps)")
    print(f"DSP chain: {times['dsp_s']:.3f} s, {n_sym / times['dsp_s'] / 1e6:.4f} Msym/s "
          "(first call)")
    print(f"BER {res['ber']}, GMI {res['gmi']} bit, EVM {res['evm']}, SNR {res['snr']} dB")

    # checks
    _check(launches["bps"] >= 1, "the main path never launched the BPS kernel")
    _check(launches["mimo_eq"] >= 3, "the main path launched the equalizer kernel "
           f"{launches['mimo_eq']} times, expected one per training pass (3)")
    y = res["y"]
    _check(tuple(y.shape) == (n_sym, 2) and y.is_cuda, f"unexpected output {tuple(y.shape)}")
    _check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(res["phases"]).all()),
           "non-finite chain output")
    _check(np.all(np.isfinite(res["ber"])) and np.all(np.isfinite(res["gmi"])),
           "non-finite metrics")
    for p in range(2):
        _check(res["ber"][p] <= 2 * JAX_BER[p] + 1e-4,
               f"BER {res['ber'][p]} above 2 x JAX {JAX_BER[p]} + 1e-4 (pol {p})")
        _check(res["gmi"][p] >= JAX_GMI[p] - 0.05,
               f"GMI {res['gmi'][p]} below JAX {JAX_GMI[p]} - 0.05 (pol {p})")

    # the same chain on CPU tensors (the kernels' plain versions), small input
    from opticommpy_torch.models import manakov_ssf
    from opticommpy_torch.pipelines import CoherentDSPConfig, coherent_dsp_chain

    small = CoherentDSPConfig(SpS_in=16, L=250, nTrain=2000, mu=(5e-3, 2e-3),
                              eqBackend="pallas", cprBackend="pallas")
    sig_s = res["sig_rx"][: 4096 * 16]
    ref_s = res["d_ref"][:4096]
    y_gpu, _ = coherent_dsp_chain(sig_s, ref_s, small)
    y_cpu, _ = coherent_dsp_chain(sig_s.cpu(), ref_s.cpu(), small)
    d = (y_gpu.cpu() - y_cpu).abs()
    far = float((d > 1e-3).float().mean())
    print(f"chain CUDA vs CPU plain (4096 symbols): max |diff| {float(d.max()):.3e}, "
          f"share > 1e-3: {far:.2e}")
    _check(far <= 1e-3 and float(d.max()) < 0.05, "chain on CUDA disagrees with CPU")

    # the whole main path again from the same seed: which stage is reproducible
    res2, _ = run_main_path(dev)
    for key in ("sig_tx", "sig_ch", "sig_rx", "d_ref", "y"):
        print(f"main path from the same seed twice: {key} bit-identical "
              f"{bool(torch.equal(res[key], res2[key]))} (max |diff| "
              f"{float((res[key] - res2[key]).abs().max()):.3e})")

    # warm re-runs for the phase times
    _, ssfm_warm = _wall(lambda: manakov_ssf(res["sig_tx"], res["cfg_ch"], res["gen"]))
    _, dsp_warm = _wall(lambda: coherent_dsp_chain(res["sig_rx"], res["d_ref"], res["cfg"]))
    print(f"SSFM warm: {ssfm_warm:.3f} s, {n_samples / ssfm_warm:.4e} samples/s")
    print(f"DSP chain warm: {dsp_warm:.3f} s, {n_sym / dsp_warm / 1e6:.4f} Msym/s")

    wdm = run_wdm_paths(dev, res)
    psk_counts = run_psk_path(dev)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kernels = [
        dict(name="bps", route="cuda", source="opticommpy_torch/csrc/bps.cu",
             replaces="opticommpy_tpu/kernels/bps_pallas.py:165",
             launches=launches["bps"], **report["bps"]),
        dict(name="mimo_eq", route="cuda", source="opticommpy_torch/csrc/mimo_eq.cu",
             replaces="opticommpy_tpu/kernels/mimo_pallas.py:227",
             launches=launches["mimo_eq"], **report["mimo_eq"]),
        dict(name="mimo_eq_batch", route="cuda", source="opticommpy_torch/csrc/mimo_eq.cu",
             replaces="opticommpy_tpu/kernels/mimo_pallas.py:467",
             launches=wdm["da-rde/dd-lms"]["counts"]["mimo_eq_batch"],
             **report["mimo_eq_batch"]),
        dict(name="rls_argmin", route="cuda", source="opticommpy_torch/csrc/rls.cu",
             replaces="opticommpy_tpu/kernels/rls_pallas.py:183",
             launches=psk_counts["rls"], **report["rls_argmin"]),
        dict(name="rls_batch", route="cuda", source="opticommpy_torch/csrc/rls.cu",
             replaces="opticommpy_tpu/kernels/rls_pallas.py:367",
             launches=wdm["rls/dd-rls"]["counts"]["rls_batch"], **report["rls_batch"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
