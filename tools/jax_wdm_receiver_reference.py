"""The JAX package's result on the port's 11-channel WDM receiver, for
chip_smoke.py's per-channel bounds.

Runs opticommpy_tpu on the CPU at the configuration chip_smoke.py drives
through opticommpy_torch on the GPU. The link is the one of
tools/jax_main_path_reference.py: 11 channels of 16-QAM polmux at 32 GBd,
SpS 16, 2**18 bits per signal (2**20 samples) on a 37.5 GHz grid at -2 dBm
per channel, 5 x 50 km of Manakov fiber (hz 0.5 km, fused linear steps,
EDFA NF 4.5). Every channel k is then received with its own LO (10 dBm,
100 kHz, at wdm_freq_grid(11, 37.5e9)[k] + 150 MHz) through the PDM
coherent receiver and synchronized against its own transmitted symbols.
The 11 signals go through the steps of coherent_dsp_chain_batch
(CoherentDSPConfig(SpS_in=16, L=250, nTrain=12000)) twice: with the
training schedule ("da-rde", "dd-lms"), mu (5e-3, 2e-3), and with
("rls", "dd-rls") at MIMOEqualizerConfig's default lambdaRLS 0.99. BER,
GMI and EVM are taken per channel after discarding nTrain + 2000 symbols.

The chain's steps are copied here rather than called, because its Pallas
kernels in interpret mode are too slow at 65,536 symbols x 11 signals: the
equalizer runs as mimo_adapt_equalizer_batch(backend="scan"), which the
JAX package's tests pin to its batched kernels
(tests/test_mimo_pallas.py:345-427), and carrier recovery as the broadcast
bps, which they pin to bps_pallas. The batch chain's order is kept:
4th-power FOE before the equalizer and none after it.

The da-rde/dd-lms schedule does not recover every channel: after the blind
da-rde stage the decision-directed stage and BPS can slip by quarter turns
(fast_ber_calc removes one constant quarter-turn offset, not slips), and
where that happens depends on each channel's phase-noise realization.

Usage: JAX_PLATFORMS=cpu python tools/jax_wdm_receiver_reference.py
Prints one JSON line: per schedule, per channel, the per-polarization BER,
GMI, EVM and SNR.
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
from opticommpy_tpu.dsp import EDCConfig, MIMOEqualizerConfig, edc  # noqa: E402
from opticommpy_tpu.dsp.carrier_recovery import bps, fourth_power_foe  # noqa: E402
from opticommpy_tpu.dsp.equalization import mimo_adapt_equalizer_batch  # noqa: E402
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
from opticommpy_tpu.comm.modulation import gray_mapping  # noqa: E402

SCHEDULES = {"da-rde/dd-lms": (("da-rde", "dd-lms"), (5e-3, 2e-3)),
             "rls/dd-rls": (("rls", "dd-rls"), (5e-3, 2e-3))}
N_CHANNELS, N_TRAIN = 11, 12000


def receive(sig_ch, fs, k_lo, k_rx, symb_tx):
    """Per channel: (front-end output at 2 SpS, synchronized reference)."""
    pulse = pulse_shape("rrc", 16, 1024, 0.01)
    grid = wdm_freq_grid(N_CHANNELS, 37.5e9)
    xs, refs = [], []
    for k in range(N_CHANNELS):
        lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=fs,
                                           freqShift=float(grid[k]) + 150e6, RIN_var=0.0),
                               jax.random.fold_in(k_lo, k))
        sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs),
                                       key=jax.random.fold_in(k_rx, k))
        # the chain's front end (matched filter, decimate, EDC, pnorm, FOE);
        # the reference sync runs on the same EDC output
        pre = edc(decimate(fir_filter(pulse, sig_rx), 16, 2),
                  EDCConfig(L=250, D=16, Fs=64e9, Rs=32e9))
        refs.append(pnorm(pnorm(symbol_sync(pre, symb_tx[:, :, k], 2))))
        x, _ = fourth_power_foe(pnorm(pre), 64e9, 4)
        xs.append(pnorm(x))
    return jnp.stack(xs), jnp.stack(refs)


def equalize_and_score(x_b, ref_b, algs, mus):
    n_sym = ref_b.shape[1]
    cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=mus, alg=algs,
                              L=(N_TRAIN, n_sym - N_TRAIN), M=16, numIter=2,
                              backend="scan")
    y = mimo_adapt_equalizer_batch(x_b, cfg, symb_ref=ref_b)  # (B, nSym, 2)
    const = gray_mapping(16, "qam")
    const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)
    b, n, m = y.shape
    y_cols = jnp.moveaxis(y, 0, 1).reshape(n, b * m)
    phases = jnp.unwrap(4 * bps(y_cols, 37, jnp.asarray(const), 64), axis=0) / 4
    out = jnp.moveaxis((y_cols * jnp.exp(1j * phases)).reshape(n, b, m), 1, 0)
    disc = N_TRAIN + 2000
    rows = []
    for k in range(b):
        yy, dd = out[k, disc:-100], ref_b[k, disc:-100]
        ber, _, snr = fast_ber_calc(yy, dd, 16, "qam")
        gmi, _ = monte_carlo_gmi(yy, dd, 16, "qam")
        evm = calc_evm(yy, 16, "qam", symb_tx=dd)
        rows.append({"ber": np.asarray(ber).tolist(), "gmi": np.asarray(gmi).tolist(),
                     "evm": np.asarray(evm).tolist(), "snr_db": np.asarray(snr).tolist()})
    return rows


def main():
    t0 = time.time()
    k_tx, k_ch, k_lo, k_rx = jax.random.split(jax.random.PRNGKey(0), 4)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=16, nBits=2**18, nChannels=N_CHANNELS,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(-2.0,), wdmGridSpacing=37.5e9,
                         laserLinewidth=100e3)
    fs = cfg_tx.Fs
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    cfg_ch = SSFMConfig(Ltotal=250, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3,
                        Fs=fs, amp="edfa", NF=4.5, nlprMethod=False, trapIters=1,
                        fusedLinear=True)
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    x_b, ref_b = receive(sig_ch, fs, k_lo, k_rx, symb_tx)
    result = {"jax": jax.__version__}
    for name, (algs, mus) in SCHEDULES.items():
        result[name] = equalize_and_score(x_b, ref_b, algs, mus)
    result["seconds"] = time.time() - t0
    print(json.dumps(result))


if __name__ == "__main__":
    main()
