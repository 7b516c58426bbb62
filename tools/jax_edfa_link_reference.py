"""The JAX package's result on the port's Giles-EDFA link, for chip_smoke.py's
bounds (path L).

Runs opticommpy_tpu on the CPU at the configuration chip_smoke.py drives
through opticommpy_torch on the GPU: examples/wdm_amp_transmission.py (the
BASELINE config 4 link) at the main path's widths. 11 channels of 16-QAM
polmux at 32 GBd, SpS 16, 2**18 bits per signal (2**20 samples) on a
37.5 GHz grid at -2 dBm per channel, RRC 0.01 with 1024 taps, 100 kHz
lasers; 3 spans, each 50 km of manakov_ssf (amp "none", nlprMethod,
maxNlinPhaseRot 2e-2) followed by edfa_sm (AGC 10 dB, 8 m of the synthetic
EDF, 60 mW forward pump, no backward pump, 100 GHz noise band, tolCtrl
0.5 dB, rng default_rng(span)); then the centre channel with its LO at
+80 MHz (10 dBm, 100 kHz), pdm_coherent_receiver, a 0.6 Rs low-pass of 501
taps, the matched filter, decimation to 2 SpS, edc over 150 km,
symbol_sync, mimo_adapt_equalizer (da-rde then dd-lms, 15 taps, mu
(5e-3, 2e-3), 2,000 training symbols, numIter 2) and BPS (N 35, B 64),
then BER, GMI and SNR after the first 2,500 and before the last 64 symbols.
The equalizer and BPS run their scan and broadcast forms
(backend="scan", alg="bps"), which the JAX package's tests pin to its
kernels.

Usage: JAX_PLATFORMS=cpu python tools/jax_edfa_link_reference.py [--seed S]
Prints one JSON line: per span the gain [dB], the forward pump [W] and the
seconds of the SSFM and of edfa_sm; then the per-polarization BER, GMI and
SNR. The seed (default 11) is that of the PRNGKey split into the
transmitter's, the LO's and the receiver's keys.
"""

import argparse
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

from opticommpy_tpu.comm.metrics import fast_ber_calc, monte_carlo_gmi  # noqa: E402
from opticommpy_tpu.dsp import (  # noqa: E402
    CPRConfig,
    EDCConfig,
    MIMOEqualizerConfig,
    cpr,
    edc,
    mimo_adapt_equalizer,
)
from opticommpy_tpu.models import (  # noqa: E402
    LaserConfig,
    PDMFrontendConfig,
    SSFMConfig,
    basic_laser_model,
    manakov_ssf,
    pdm_coherent_receiver,
)
from opticommpy_tpu.models.amplification import EDFASMConfig, edfa_sm  # noqa: E402
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx  # noqa: E402
from opticommpy_tpu.ops import (  # noqa: E402
    decimate,
    fir_filter,
    lowpass_fir,
    pnorm,
    pulse_shape,
    symbol_sync,
)

FC = 193.1e12
N_SPANS = 3
L_SPAN = 50.0
N_TRAIN = 2000


def main(seed=11):
    t_all = time.time()
    k_tx, k_lo, k_rx = jax.random.split(jax.random.PRNGKey(seed), 3)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=16, nBits=2**18, nChannels=11, nPolModes=2,
                         nFilterTaps=1024, pulseRollOff=0.01, powerPerChannel=(-2.0,),
                         laserLinewidth=100e3, wdmGridSpacing=37.5e9)
    fs = cfg_tx.Fs
    sig, symb_tx, grid = simple_wdm_tx(k_tx, cfg_tx)
    cfg_span = SSFMConfig(Ltotal=L_SPAN, Lspan=L_SPAN, alpha=0.2, D=16, gamma=1.3, Fs=fs,
                          amp="none", nlprMethod=True, maxNlinPhaseRot=2e-2)
    span = jax.jit(lambda e: manakov_ssf(e, cfg_span))
    cfg_edfa = EDFASMConfig(type="AGC", value=cfg_span.alpha * L_SPAN, lngth=8.0,
                            forPumpW=(60e-3,), bckPumpW=(0.0,), noiseBand=100e9,
                            tolCtrl=0.5)
    spans = []
    for n in range(N_SPANS):
        t0 = time.time()
        sig = span(sig).block_until_ready()
        t_ssfm = time.time() - t0
        t0 = time.time()
        sig_np = np.asarray(sig)
        amplified, ppf, ppb, noise_amp = edfa_sm(sig_np, fs, FC, cfg_edfa,
                                                 rng=np.random.default_rng(n))
        t_edfa = time.time() - t0
        gain = 10 * np.log10(np.mean(np.abs(amplified) ** 2) / np.mean(np.abs(sig_np) ** 2))
        sig = jnp.asarray(amplified.astype(np.complex64))
        row = dict(gain_db=float(gain), pump_f_w=float(np.ravel(ppf)[0]),
                   noise_amp_mean=float(np.mean(noise_amp)), ssfm_s=t_ssfm, edfa_s=t_edfa)
        spans.append(row)
        print(f"span {n + 1}: {json.dumps(row)}", file=sys.stderr, flush=True)

    center = cfg_tx.nChannels // 2
    lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig.shape[0], Fs=fs,
                                       freqShift=float(grid[center]) + 80e6, RIN_var=0.0),
                           k_lo)
    rx = pdm_coherent_receiver(sig, lo, PDMFrontendConfig(Fs=fs), key=k_rx)
    rx = fir_filter(jnp.asarray(lowpass_fir(0.6 * cfg_tx.Rs, fs, 501)), rx)
    pulse = jnp.asarray(pulse_shape("rrc", cfg_tx.SpS, 1024, cfg_tx.pulseRollOff))
    dec = decimate(fir_filter(pulse, rx), cfg_tx.SpS, 2)
    cd = edc(dec, EDCConfig(L=N_SPANS * L_SPAN, D=16, Fs=2 * cfg_tx.Rs, Rs=cfg_tx.Rs))
    d_ref = pnorm(symbol_sync(cd, symb_tx[:, :, center], 2))
    n_sym = d_ref.shape[0]
    y = mimo_adapt_equalizer(
        pnorm(cd),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
                            L=(N_TRAIN, n_sym - N_TRAIN), M=16, numIter=2, backend="scan"),
        symb_ref=d_ref)
    y = cpr(y, CPRConfig(alg="bps", M=16, N=35, B=64, Ts=1 / cfg_tx.Rs))
    disc = N_TRAIN + 500
    y, d = y[disc:-64], d_ref[disc:-64]
    ber, _, snr = fast_ber_calc(y, d, 16, "qam")
    gmi, _ = monte_carlo_gmi(y, d, 16, "qam")
    print(json.dumps({"seed": seed, "spans": spans, "ber": np.asarray(ber).tolist(),
                      "gmi": np.asarray(gmi).tolist(), "snr": np.asarray(snr).tolist(),
                      "seconds": time.time() - t_all, "jax": jax.__version__}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=11)
    main(ap.parse_args().seed)
