"""The JAX package's result on chip_smoke.py's clock-recovery and serving
paths (A, B and C), for its bounds.

Runs opticommpy_tpu on the CPU at the configuration chip_smoke.py drives
through opticommpy_torch on the GPU. The field is the one of
tools/jax_main_path_reference.py and tools/jax_wdm_receiver_reference.py:
11 channels of 16-QAM polmux at 32 GBd, SpS 16, 2**18 bits per signal
(2**20 samples) on a 37.5 GHz grid at -2 dBm per channel, 5 x 50 km of
Manakov fiber (hz 0.5 km, fused linear steps, EDFA NF 4.5). The DSP
configuration is CoherentDSPConfig(SpS_in=16, L=250, nTrain=12000,
mu=(5e-3, 2e-3)).

A. Clock recovery, one channel: the centre channel received with a 10 dBm /
   100 kHz LO at +150 MHz, resampled to a receiver clock 200 ppm fast
   (clock_sampling_interp, sampling jitter 1e-3 / fs), then
   coherent_dsp_chain with runCR=True, crMethod="gardner", crNyquist=True,
   crKp=2e-3, crKi=1e-5, against the reference trimmed to
   int((1 - 500e-6) * n_dsp) // 2 symbols. Control: the same offset signal
   with runCR=False.
B. Feedforward clock recovery, 11 channels: channel k (LO at its grid
   frequency + 150 MHz) at its own clock offset -200 + 40 k ppm, all cut to
   the shortest, through the steps of coherent_dsp_chain_batch with
   runCR=True, crMethod="ffw".
C. Train, then serve, 11 channels: channel k with its LO at its grid
   frequency (no offset: the serving path has no FOE), resampled to 64
   GS/s (resample), the taps trained by mimo_adapt_equalizer_batch on
   pnorm(edc(fir_filter(rrc at SpS 2, x_k))) with the chain's schedule
   ("da-rde", "dd-lms"), then served through the steps of
   coherent_dsp_serve with the training-time pnorm scalars (BPS), and
   through mimo_apply_fused and cpr(alg="ddpll") with a pilot every 32nd
   symbol (DD-PLL).

Scores: per channel and polarization, BER, GMI and EVM after discarding
nTrain + 2000 symbols (and the last 100).

Kernels in interpret mode are too slow at these sizes, so this script runs
the forms the JAX package's own tests pin to them: Gardner with
crBackend="scan" (tests/test_carrier_clock.py:130-146 pins it to
gardner_pallas), the equalizer with backend="scan"
(tests/test_mimo_pallas.py:345-382), the broadcast bps for bps_pallas, and
cpr(alg="ddpll") for ddpll_pallas (tests/test_pallas_kernels.py:84-113).
The steps of coherent_dsp_chain_batch and coherent_dsp_serve are copied
here for that reason, in their order.

Usage: JAX_PLATFORMS=cpu python tools/jax_cr_serve_reference.py
Prints one JSON line with the scores of every path.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from opticommpy_tpu.comm.metrics import calc_evm, fast_ber_calc, monte_carlo_gmi  # noqa: E402
from opticommpy_tpu.comm.modulation import gray_mapping  # noqa: E402
from opticommpy_tpu.dsp import EDCConfig, MIMOEqualizerConfig, edc  # noqa: E402
from opticommpy_tpu.dsp.carrier_recovery import CPRConfig, bps, cpr, fourth_power_foe  # noqa: E402
from opticommpy_tpu.dsp.clock_recovery import (  # noqa: E402
    FFWClockRecoveryConfig,
    ffw_clock_recovery,
)
from opticommpy_tpu.dsp.equalization import (  # noqa: E402
    mimo_adapt_equalizer_batch,
    mimo_apply_fused,
)
from opticommpy_tpu.models import (  # noqa: E402
    LaserConfig,
    PDMFrontendConfig,
    SSFMConfig,
    basic_laser_model,
    manakov_ssf,
    pdm_coherent_receiver,
)
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx, wdm_freq_grid  # noqa: E402
from opticommpy_tpu.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync  # noqa: E402
from opticommpy_tpu.ops.signal import clock_sampling_interp, resample  # noqa: E402
from opticommpy_tpu.pipelines import CoherentDSPConfig, coherent_dsp_chain  # noqa: E402

N_CHANNELS, N_TRAIN, FS = 11, 12000, 16 * 32e9
DISC = N_TRAIN + 2000
CFG = CoherentDSPConfig(SpS_in=16, L=250, nTrain=N_TRAIN, mu=(5e-3, 2e-3))
EDC_CFG = EDCConfig(L=250, D=16, Fs=64e9, Rs=32e9)
PPM_A = 200.0
PPM_B = [-200.0 + 40.0 * k for k in range(N_CHANNELS)]
PILOT_EVERY = 32


def _const():
    c = gray_mapping(16, "qam")
    return (c / np.sqrt(np.mean(np.abs(c) ** 2))).astype(np.complex64)


def scores(y, ref):
    """Per polarization BER, GMI, EVM and SNR after DISC symbols."""
    yy, dd = y[DISC:-100], ref[DISC:-100]
    ber, _, snr = fast_ber_calc(yy, dd, 16, "qam")
    gmi, _ = monte_carlo_gmi(yy, dd, 16, "qam")
    evm = calc_evm(yy, 16, "qam", symb_tx=dd)
    return {"ber": np.asarray(ber).tolist(), "gmi": np.asarray(gmi).tolist(),
            "evm": np.asarray(evm).tolist(), "snr_db": np.asarray(snr).tolist()}


def retained_symbols(n_samples_in):
    """Symbols clock recovery keeps: int((1 - 500e-6) * n_dsp) // 2."""
    n_dsp = -(-n_samples_in // 8)
    return int((1 - 500e-6) * n_dsp) // 2


def synced_ref(sig_rx, symb_tx_k, sps_in):
    pulse = pulse_shape("rrc", sps_in, 1024, 0.01)
    pre = fir_filter(pulse, sig_rx)
    if sps_in != 2:
        pre = decimate(pre, sps_in, 2)
    pre = edc(pre, EDC_CFG)
    return pnorm(symbol_sync(pre, symb_tx_k, 2)), pre


def receive(sig_ch, lo_shift, k_lo, k_rx):
    lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=FS,
                                       freqShift=lo_shift, RIN_var=0.0), k_lo)
    return pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=FS), key=k_rx)


def path_a(sig_ch, symb_tx, k_lo, k_rx, k_j):
    sig_rx = receive(sig_ch, 150e6, k_lo, k_rx)
    d_ref, _ = synced_ref(sig_rx, symb_tx[:, :, 5], 16)
    sig_off = clock_sampling_interp(sig_rx, FS, FS * (1 + PPM_A * 1e-6),
                                    jitter_rms=1e-3 / FS, key=k_j)
    d_cr = d_ref[:retained_symbols(sig_off.shape[0])]
    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=N_TRAIN, mu=(5e-3, 2e-3),
                            runCR=True, crMethod="gardner", crBackend="scan",
                            crNyquist=True, crKp=2e-3, crKi=1e-5)
    y, _ = coherent_dsp_chain(sig_off, d_cr, cfg)
    y_n, _ = coherent_dsp_chain(sig_off, d_cr, CFG)
    return {"ppm": PPM_A, "n_sym": int(d_cr.shape[0]), "cr": scores(y, d_cr),
            "no_cr": scores(y_n, d_cr)}


B_CR_CFG = FFWClockRecoveryConfig(blockLen=CFG.crBlockLen, maxPPM=CFG.crMaxPPM,
                                  rollOff=CFG.rollOff, fit=CFG.crFit, sps=2)


def path_b_fronts(sig_ch, symb_tx, k_lo, k_rx, k_j):
    """Path B up to the feedforward stage: the (B, n_dsp, 2) signals it
    retimes (matched filter, decimation, EDC, pnorm of channel k at its
    offset, all cut to the shortest) and the (B, nSym, 2) references."""
    grid = wdm_freq_grid(N_CHANNELS, 37.5e9)
    offs, refs = [], []
    for k in range(N_CHANNELS):
        sig_rx = receive(sig_ch, float(grid[k]) + 150e6, jax.random.fold_in(k_lo, k),
                         jax.random.fold_in(k_rx, k))
        refs.append(synced_ref(sig_rx, symb_tx[:, :, k], 16)[0])
        offs.append(clock_sampling_interp(sig_rx, FS, FS * (1 + PPM_B[k] * 1e-6),
                                          jitter_rms=1e-3 / FS,
                                          key=jax.random.fold_in(k_j, k)))
    n = min(o.shape[0] for o in offs)
    n_keep = retained_symbols(n)
    ref_b = jnp.stack([r[:n_keep] for r in refs])
    # coherent_dsp_chain_batch(runCR=True, crMethod="ffw"), step by step
    pulse = jnp.asarray(pulse_shape("rrc", 16, 1024, 0.01).astype(np.float32))
    fronts = jnp.stack([pnorm(edc(decimate(fir_filter(pulse, o[:n]), 16, 2), EDC_CFG))
                        for o in offs])
    return fronts, ref_b


def path_b(sig_ch, symb_tx, k_lo, k_rx, k_j):
    fronts, ref_b = path_b_fronts(sig_ch, symb_tx, k_lo, k_rx, k_j)
    xs, est = [], []
    for x in fronts:
        x, (ppm, _) = ffw_clock_recovery(x, B_CR_CFG, return_est=True)
        x, _ = fourth_power_foe(pnorm(x), 64e9, 4)
        xs.append(pnorm(x))
        est.append(float(ppm))
    x_b = jnp.stack(xs)
    ref_b = jax.vmap(pnorm)(ref_b)
    n_sym = ref_b.shape[1]
    eq_cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=CFG.mu, alg=CFG.alg,
                                 L=(N_TRAIN, n_sym - N_TRAIN), M=16, numIter=2,
                                 backend="scan")
    y = mimo_adapt_equalizer_batch(x_b, eq_cfg, symb_ref=ref_b)
    out = _bps_derotate(y)
    return {"ppm": PPM_B, "ppm_est": est, "n_sym": int(n_sym),
            "channels": [scores(out[k], ref_b[k]) for k in range(N_CHANNELS)]}


def _bps_derotate(y):
    """BPS over all B * modes columns, unwrap, derotate: (B, nSym, modes)."""
    b, n, m = y.shape
    y_cols = jnp.moveaxis(y, 0, 1).reshape(n, b * m)
    ph = bps(y_cols, CFG.cpr_window // 2, jnp.asarray(_const()), CFG.cpr_phases)
    ph = jnp.unwrap(4 * ph, axis=0) / 4
    return jnp.moveaxis((y_cols * jnp.exp(1j * ph)).reshape(n, b, m), 1, 0)


def path_c(sig_ch, symb_tx, k_lo, k_rx):
    grid = wdm_freq_grid(N_CHANNELS, 37.5e9)
    pulse2 = pulse_shape("rrc", 2, 1024, 0.01).astype(np.float32)
    xs, fronts, scales, refs = [], [], [], []
    for k in range(N_CHANNELS):
        sig_rx = receive(sig_ch, float(grid[k]), jax.random.fold_in(k_lo, k),
                         jax.random.fold_in(k_rx, k))
        x = resample(sig_rx, FS, 64e9)
        ref, pre = synced_ref(x, symb_tx[:, :, k], 2)
        s = jnp.sqrt(jnp.mean((pre * jnp.conj(pre)).real))
        xs.append(x)
        fronts.append(pre / s)
        scales.append(s)
        refs.append(ref)
    x_b, front_b, ref_b = jnp.stack(xs), jnp.stack(fronts), jnp.stack(refs)
    scale_b = jnp.stack(scales)
    n_sym = ref_b.shape[1]
    eq_cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=CFG.mu, alg=CFG.alg,
                                 L=(N_TRAIN, n_sym - N_TRAIN), M=16, numIter=2,
                                 backend="scan")
    _, H_b, _ = mimo_adapt_equalizer_batch(front_b, eq_cfg, symb_ref=ref_b,
                                           return_results=True)
    # coherent_dsp_serve(x_b, H_b, CFG, scale=scale_b), step by step
    y = jax.vmap(lambda s, h, c: mimo_apply_fused(
        h, s, 2, pre=pulse2, edc_config=EDC_CFG, scale=c))(x_b, H_b, scale_b)
    y = y[:, :n_sym]
    served = _bps_derotate(y)
    # DD-PLL over the 22 columns, a pilot every PILOT_EVERY-th symbol
    y_cols = jnp.moveaxis(y, 0, 1).reshape(n_sym, -1)
    r_cols = jnp.moveaxis(ref_b, 0, 1).reshape(n_sym, -1)
    cpr_cfg = CPRConfig(alg="ddpll", M=16, Ts=1 / 32e9, runFOE=False)
    pll = cpr(y_cols, cpr_cfg, symb_tx=r_cols,
              pilot_ind=np.arange(0, n_sym, PILOT_EVERY))
    pll = jnp.moveaxis(pll.reshape(n_sym, N_CHANNELS, 2), 1, 0)
    return {"n_sym": int(n_sym),
            "serve": [scores(served[k], ref_b[k]) for k in range(N_CHANNELS)],
            "ddpll": [scores(pll[k], ref_b[k]) for k in range(N_CHANNELS)]}


def field():
    """(sig_ch, symb_tx, (k_lo, k_rx, k_j), (k_lo_c, k_rx_c)): the north-star
    field after the fiber and the keys of paths A/B and of path C."""
    k_tx, k_ch, k_lo, k_rx = jax.random.split(jax.random.PRNGKey(0), 4)
    k_j, k_lo_c, k_rx_c = jax.random.split(jax.random.PRNGKey(1), 3)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=16, nBits=2**18, nChannels=N_CHANNELS,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(-2.0,), wdmGridSpacing=37.5e9,
                         laserLinewidth=100e3)
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    cfg_ch = SSFMConfig(Ltotal=250, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3,
                        Fs=FS, amp="edfa", NF=4.5, nlprMethod=False, trapIters=1,
                        fusedLinear=True)
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    return sig_ch, symb_tx, (k_lo, k_rx, k_j), (k_lo_c, k_rx_c)


def main():
    t0 = time.time()
    sig_ch, symb_tx, (k_lo, k_rx, k_j), (k_lo_c, k_rx_c) = field()
    result = {"jax": jax.__version__}
    t = time.time()
    result["A"] = path_a(sig_ch, symb_tx, k_lo, k_rx, k_j)
    result["A"]["seconds"] = time.time() - t
    t = time.time()
    result["B"] = path_b(sig_ch, symb_tx, k_lo, k_rx, k_j)
    result["B"]["seconds"] = time.time() - t
    t = time.time()
    result["C"] = path_c(sig_ch, symb_tx, k_lo_c, k_rx_c)
    result["C"]["seconds"] = time.time() - t
    result["seconds"] = time.time() - t0
    print(json.dumps(result))


if __name__ == "__main__":
    main()
