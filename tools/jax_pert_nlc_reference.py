"""The JAX package's result on the port's perturbation-NLC link, for
chip_smoke.py's bounds (path M).

Runs opticommpy_tpu on the CPU at the configuration chip_smoke.py drives
through opticommpy_torch on the GPU: examples/perturbation_nlc.py with
98,304 64-QAM symbols per polarization. One channel of 64-QAM polmux at
32 GBd, SpS 8, RRC 0.01 with 1024 taps, no laser linewidth; five launch
powers (-2 to 4 dBm in 1.5 dB steps) as ten columns of one
set_power_for_par_ssfm / manakov_ssf call (16 x 50 km, hz 0.5 km, D 17,
ideal amplification, fused linear steps); per power the matched filter,
decimation to 2 SpS, EDC over 800 km, symbol_sync, mimo_adapt_equalizer
(15 taps, nlms then dd-lms, mu 2e-3, 4,000 training symbols, numIter 2) and
BPS (N 50, B 64), keeping the symbols after the first 5,000 and before the
last 100. Then three arms: EDC alone; NLC, perturbation_nlin (AMR,
matrixOrder 50, coeffTol -30 dB) on the ML hard decisions, subtracted with
the EVM-best of a 10 x 10 amplitude / phase grid; NLC-ideal, the same on
the true symbols. BER and SNR per polarization for each arm. The equalizer
and BPS run their scan and broadcast forms (backend="scan", alg="bps"),
which the JAX package's tests pin to its kernels.

Usage: JAX_PLATFORMS=cpu python tools/jax_pert_nlc_reference.py [--seed S]
[--save-symbols OUT.npz] [--tx-only]
Prints one JSON line: per power and arm the per-polarization BER and SNR.
The seed (default 7) is that of the PRNGKey split into the transmitter's
and the channel's keys. --save-symbols writes the transmitter's 64-QAM
indices (nSymbols, 2) uint8, compressed; chip_smoke.py builds path M's
transmitter from tools/pert_jax_seed7_symbols.npz, written so. --tx-only
stops after the transmitter.
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

from opticommpy_tpu.comm.metrics import fast_ber_calc  # noqa: E402
from opticommpy_tpu.comm.modulation import detector, gray_mapping  # noqa: E402
from opticommpy_tpu.dsp import (  # noqa: E402
    CPRConfig,
    EDCConfig,
    MIMOEqualizerConfig,
    cpr,
    edc,
    mimo_adapt_equalizer,
)
from opticommpy_tpu.models import SSFMConfig, manakov_ssf  # noqa: E402
from opticommpy_tpu.models.perturbation import PerturbationConfig, perturbation_nlin  # noqa: E402
from opticommpy_tpu.models.tx import (  # noqa: E402
    WDMTxConfig,
    set_power_for_par_ssfm,
    simple_wdm_tx,
)
from opticommpy_tpu.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync  # noqa: E402

M = 64
RS = 32e9
SPS = 8
N_SYMBOLS = 98_304
LINK_KM, SPAN_KM = 800.0, 50.0
DISP = 17.0
POWERS_DBM = (-2.0, -0.5, 1.0, 2.5, 4.0)
N_TRAIN = 4000
DISCARD = N_TRAIN + 1000


def linear_rx(sig_rx, symb_ref, pulse):
    sig_dec = decimate(fir_filter(pulse, sig_rx), SPS, 2)
    sig_edc = edc(sig_dec, EDCConfig(L=LINK_KM, D=DISP, Fs=2 * RS, Rs=RS))
    d_ref = pnorm(symbol_sync(sig_edc, symb_ref, 2))
    n_sym = d_ref.shape[0]
    y = mimo_adapt_equalizer(
        pnorm(sig_edc),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(2e-3, 2e-3), alg=("nlms", "dd-lms"),
                            L=(N_TRAIN, n_sym - N_TRAIN), M=M, numIter=2, backend="scan"),
        symb_ref=d_ref)
    y = cpr(y, CPRConfig(alg="bps", M=M, N=50, B=64, Ts=1 / RS))
    return pnorm(y[DISCARD:-100]), d_ref[DISCARD:-100]


def nlc_correct(symb_rx, symb_hat, p_dbm, n_grid=10):
    cfg = PerturbationConfig(D=DISP, alpha=0.2, lspan=SPAN_KM, length=LINK_KM, gamma=1.3,
                             Rs=RS, mode="AMR", coeffTol=-30.0, matrixOrder=50, Pin=p_dbm)
    nlin = perturbation_nlin(symb_hat, cfg)
    p_peak = 0.5 * 10 ** (p_dbm / 10) * 1e-3
    symb_pert = jnp.sqrt(p_peak) * pnorm(symb_hat) + nlin
    delta = pnorm(symb_pert) - pnorm(symb_hat)
    amps = jnp.linspace(0.1, 4.1, n_grid)
    phases = jnp.linspace(0, 2 * jnp.pi, n_grid, endpoint=False)
    scale = (amps[:, None] * jnp.exp(1j * phases[None, :])).reshape(-1)
    cand = symb_rx[None, :, :] - scale[:, None, None] * delta[None, :, :]
    cand = cand / jnp.sqrt(jnp.mean(jnp.abs(cand) ** 2, axis=(1, 2), keepdims=True))
    evm = jnp.mean(jnp.abs(cand - pnorm(symb_hat)[None]) ** 2, axis=(1, 2))
    return cand[jnp.argmin(evm)]


def main(seed=7, save_symbols=None, tx_only=False):
    t0 = time.time()
    k_tx, k_ch = jax.random.split(jax.random.PRNGKey(seed))
    cfg_tx = WDMTxConfig(M=M, Rs=RS, SpS=SPS, nBits=6 * N_SYMBOLS, nChannels=1, nPolModes=2,
                         nFilterTaps=1024, pulseRollOff=0.01, powerPerChannel=(0.0,),
                         laserLinewidth=0.0)
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    symb_ref = symb_tx[:, :, 0]
    if save_symbols:
        const = gray_mapping(M, "qam")
        const = const / np.sqrt(np.mean(np.abs(const) ** 2))
        idx = np.argmin(np.abs(np.asarray(symb_ref)[:, :, None] - const), axis=-1)
        np.savez_compressed(save_symbols, idx=idx.astype(np.uint8), seed=seed)
    if tx_only:
        return
    sig_batch = set_power_for_par_ssfm(jnp.concatenate([sig_tx] * len(POWERS_DBM), axis=1),
                                       jnp.asarray(POWERS_DBM))
    cfg_ch = SSFMConfig(Ltotal=LINK_KM, Lspan=SPAN_KM, hz=0.5, alpha=0.2, D=DISP, gamma=1.3,
                        Fs=cfg_tx.Fs, amp="ideal", nlprMethod=False, trapIters=1,
                        fusedLinear=True)
    sig_rx_all = manakov_ssf(sig_batch, cfg_ch, key=k_ch)
    sig_rx_all.block_until_ready()
    t_ssfm = time.time() - t0
    pulse = jnp.asarray(pulse_shape("rrc", SPS, 1024, 0.01))
    const = pnorm(gray_mapping(M, "qam"))
    out = {}
    for i, p_dbm in enumerate(POWERS_DBM):
        y, d = linear_rx(sig_rx_all[:, 2 * i:2 * i + 2], symb_ref, pulse)
        symb_hat = jnp.stack([detector(y[:, k], 0.5, const, rule="ML")[0] for k in range(2)],
                             axis=1)
        arms = {"edc": y, "nlc": nlc_correct(y, symb_hat, p_dbm),
                "nlc_ideal": nlc_correct(y, d, p_dbm)}
        row = {}
        for name, sig in arms.items():
            ber, _, snr = fast_ber_calc(sig, d, M, "qam")
            row[name] = dict(ber=np.asarray(ber).tolist(), snr=np.asarray(snr).tolist())
        out[str(p_dbm)] = row
        print(f"{p_dbm:+.1f} dBm: {json.dumps(row)}", file=sys.stderr, flush=True)
    print(json.dumps({"seed": seed, "powers": out, "ssfm_seconds": t_ssfm,
                      "seconds": time.time() - t0, "jax": jax.__version__}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--save-symbols", default=None)
    ap.add_argument("--tx-only", action="store_true")
    a = ap.parse_args()
    main(a.seed, a.save_symbols, a.tx_only)
