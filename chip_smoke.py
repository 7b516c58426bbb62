"""Drive the PyTorch port's coherent WDM main path once on one NVIDIA GPU.

Phases:
1. device: needs CUDA (exits non-zero otherwise); prints the card's
   ``nvidia-smi`` name and power limit; TF32 off for matmul and cuDNN.
2. build: compiles ``opticommpy_torch/csrc/*.cu`` with nvcc into
   ``build/torch_kernels/``.
3. kernel vs plain: each Hopper kernel against its plain PyTorch version
   on the card: blind phase search at the main path's shape (65,536 symbols
   x 2 modes, 64 test phases, 75-symbol window, 16-QAM) and on 8-PSK; the
   MIMO equalizer for each of its five rules at 4,096 symbols, 2x2, 15 taps;
   both timed (CUDA events), the equalizer also at the main path's first
   training pass (12,000 symbols, da-rde).
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
6. timing of every phase; then the kernels JSON line, and last the
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

BPS_MAX_MISMATCH = 0.01  # the JAX package's near-tie rule
EQ_Y_ATOL, EQ_H_ATOL = 2e-4, 1e-3  # the JAX package's scan-vs-kernel pins


def _cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA events)."""
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
        r = np.random.default_rng(seed)
        sym = const[r.integers(0, 16, size=(n_sym, 2))]
        x = np.zeros((n_sym * 2, 2), complex)
        x[::2] = sym
        h = np.array([[0.9, 0.15 + 0.05j], [-0.1 + 0.08j, 0.95]])
        sig = x @ h.T + 0.01 * (r.normal(size=x.shape) + 1j * r.normal(size=x.shape))
        pad = np.zeros((7 + 2 * n_sym + 7 + 2 + 15, 2), np.complex64)
        pad[7:7 + 2 * n_sym] = sig
        return (torch.as_tensor(pad, device=dev),
                torch.as_tensor(sym.astype(np.complex64), device=dev))

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
    out = dict(sig_tx=sig_tx, sig_ch=sig_ch, sig_rx=sig_rx, d_ref=d_ref, y=y,
               phases=phases, cfg=cfg, cfg_ch=cfg_ch, gen=gen,
               ber=ber.cpu().numpy(), gmi=gmi.cpu().numpy(), evm=evm.cpu().numpy(),
               snr=snr.cpu().numpy())
    return out, times


def main():
    dev = phase_device()
    phase_build()
    from opticommpy_torch.kernels import bps, mimo_eq
    from opticommpy_torch.pipelines import _norm_const

    const = _norm_const(16)
    report = phase_kernels_vs_plain(dev, const)

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

    # warm re-runs for the phase times
    _, ssfm_warm = _wall(lambda: manakov_ssf(res["sig_tx"], res["cfg_ch"], res["gen"]))
    _, dsp_warm = _wall(lambda: coherent_dsp_chain(res["sig_rx"], res["d_ref"], res["cfg"]))
    print(f"SSFM warm: {ssfm_warm:.3f} s, {n_samples / ssfm_warm:.4e} samples/s")
    print(f"DSP chain warm: {dsp_warm:.3f} s, {n_sym / dsp_warm / 1e6:.4f} Msym/s")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kernels = [
        dict(name="bps", route="cuda", source="opticommpy_torch/csrc/bps.cu",
             replaces="opticommpy_tpu/kernels/bps_pallas.py:165",
             launches=launches["bps"], **report["bps"]),
        dict(name="mimo_eq", route="cuda", source="opticommpy_torch/csrc/mimo_eq.cu",
             replaces="opticommpy_tpu/kernels/mimo_pallas.py:227",
             launches=launches["mimo_eq"], **report["mimo_eq"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
