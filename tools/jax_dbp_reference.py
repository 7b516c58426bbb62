"""The JAX package's result on the port's digital-backpropagation path, for
chip_smoke.py's bounds (path I).

Runs opticommpy_tpu on the CPU at the configuration chip_smoke.py drives
through opticommpy_torch on the GPU, examples/nlc_dbp_transmission.py (the
BASELINE config 5 link) at 2**18 bits: one channel of 16-QAM polmux at
32 GBd, SpS 8 (2**16 symbols, 2**19 samples per polarization), RRC 0.01
with 1024 taps, no laser linewidth; five launch powers (-2 to 6 dBm) as
ten columns of one set_power_for_par_ssfm / manakov_ssf call (8 x 50 km,
hz 0.25 km, ideal amplification, fused linear steps); per power the matched
filter and decimation to 2 SpS, then two arms: EDC, and the launch-power
rescale plus manakov_dbp (hz 5 km, 64 GS/s). Each arm runs symbol_sync,
mimo_adapt_equalizer (15 taps, nlms then dd-lms, mu 2e-3, 4,000 training
symbols, numIter 2) and BPS (N 50, B 64), then BER, GMI, MI and SNR after
discarding the first 5,000 and the last 100 symbols. The equalizer and BPS
run their scan and broadcast forms (backend="scan", alg="bps"), which the
JAX package's tests pin to its kernels.

Usage: JAX_PLATFORMS=cpu python tools/jax_dbp_reference.py [--seed S]
[--save-tx OUT.npz] [--save-symbols OUT.npz] [--tx-only]
Prints one JSON line: per power and arm the per-polarization BER, GMI, MI
and SNR, and the mean SNR gain of DBP over EDC. The seed (default 7) is
that of the PRNGKey split into the transmitter's and the channel's keys.
--save-tx writes the transmitted field at 0 dBm per channel and its
symbols (sig_tx, symb_ref) for tools/torch_dbp_witness.py, which runs the
port's path I on them. --save-symbols writes the transmitter's 16-QAM
indices (nSymbols, 2) uint8, compressed (~70 kB); chip_smoke.py builds
path I's second transmitter from tools/dbp_jax_seed7_symbols.npz, written
so. --tx-only stops after the transmitter.
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

from opticommpy_tpu.comm.metrics import fast_ber_calc, monte_carlo_gmi, monte_carlo_mi  # noqa: E402
from opticommpy_tpu.comm.modulation import gray_mapping  # noqa: E402
from opticommpy_tpu.dsp import (  # noqa: E402
    CPRConfig,
    EDCConfig,
    MIMOEqualizerConfig,
    cpr,
    edc,
    manakov_dbp,
    mimo_adapt_equalizer,
)
from opticommpy_tpu.models import SSFMConfig, manakov_ssf  # noqa: E402
from opticommpy_tpu.models.tx import WDMTxConfig, set_power_for_par_ssfm, simple_wdm_tx  # noqa: E402
from opticommpy_tpu.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync  # noqa: E402

POWERS_DBM = (-2.0, 0.0, 2.0, 4.0, 6.0)
N_TRAIN = 4000
DISC = 5000


def arm(sig_cd, symb_ref):
    d_ref = pnorm(symbol_sync(sig_cd, symb_ref, 2))
    n_sym = d_ref.shape[0]
    y = mimo_adapt_equalizer(
        pnorm(sig_cd),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(2e-3, 2e-3), alg=("nlms", "dd-lms"),
                            L=(N_TRAIN, n_sym - N_TRAIN), M=16, numIter=2,
                            backend="scan"),
        symb_ref=d_ref)
    y = cpr(y, CPRConfig(alg="bps", M=16, N=50, B=64, Ts=1 / 32e9))
    y, d = y[DISC:-100], d_ref[DISC:-100]
    ber, _, snr = fast_ber_calc(y, d, 16, "qam")
    gmi, _ = monte_carlo_gmi(y, d, 16, "qam")
    mi = monte_carlo_mi(y, d, 16, "qam")
    return {k: np.asarray(v).tolist() for k, v in
            dict(ber=ber, gmi=gmi, mi=mi, snr=snr).items()}


def main(seed=7, save_tx=None, save_symbols=None, tx_only=False):
    t0 = time.time()
    k_tx, k_ch = jax.random.split(jax.random.PRNGKey(seed))
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=2**18, nChannels=1, nPolModes=2,
                         nFilterTaps=1024, pulseRollOff=0.01, powerPerChannel=(0.0,),
                         laserLinewidth=0.0)
    fs = cfg_tx.Fs
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    symb_ref = symb_tx[:, :, 0]
    if save_tx:
        os.makedirs(os.path.dirname(os.path.abspath(save_tx)), exist_ok=True)
        np.savez(save_tx, sig_tx=np.asarray(sig_tx), symb_ref=np.asarray(symb_ref), seed=seed)
    if save_symbols:
        const = gray_mapping(16, "qam")
        const = const / np.sqrt(np.mean(np.abs(const) ** 2))
        idx = np.argmin(np.abs(np.asarray(symb_ref)[:, :, None] - const), axis=-1)
        np.savez_compressed(save_symbols, idx=idx.astype(np.uint8), seed=seed)
    if tx_only:
        return
    sig_batch = set_power_for_par_ssfm(jnp.concatenate([sig_tx] * len(POWERS_DBM), axis=1),
                                       jnp.asarray(POWERS_DBM))
    cfg_ch = SSFMConfig(Ltotal=400, Lspan=50, hz=0.25, alpha=0.2, D=16, gamma=1.3, Fs=fs,
                        amp="ideal", nlprMethod=False, trapIters=1, fusedLinear=True)
    sig_rx_all = manakov_ssf(sig_batch, cfg_ch, key=k_ch)
    sig_rx_all.block_until_ready()
    t_ssfm = time.time() - t0
    cfg_dbp = SSFMConfig(Ltotal=400, Lspan=50, hz=5.0, alpha=0.2, D=16, gamma=1.3,
                         Fs=64e9, amp="ideal", nlprMethod=False, trapIters=1,
                         fusedLinear=True)
    pulse = pulse_shape("rrc", 8, 1024, 0.01)
    out = {}
    for i, p_dbm in enumerate(POWERS_DBM):
        sig_dec = decimate(fir_filter(pulse, sig_rx_all[:, 2 * i:2 * i + 2]), 8, 2)
        sig_edc = edc(sig_dec, EDCConfig(L=400, D=16, Fs=64e9, Rs=32e9))
        scale = jnp.sqrt(10 ** (p_dbm / 10) * 1e-3 / 2
                         / jnp.mean((sig_dec * jnp.conj(sig_dec)).real))
        sig_dbp = manakov_dbp(sig_dec * scale, cfg_dbp)
        row = {"edc": arm(sig_edc, symb_ref), "dbp": arm(sig_dbp, symb_ref)}
        row["dbp_gain_db"] = float(np.mean(row["dbp"]["snr"]) - np.mean(row["edc"]["snr"]))
        out[str(p_dbm)] = row
        print(f"{p_dbm:+.0f} dBm: {json.dumps(row)}", file=sys.stderr, flush=True)
    print(json.dumps({"seed": seed, "powers": out, "ssfm_seconds": t_ssfm,
                      "seconds": time.time() - t0, "jax": jax.__version__}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--save-tx", default=None)
    ap.add_argument("--save-symbols", default=None)
    ap.add_argument("--tx-only", action="store_true")
    a = ap.parse_args()
    main(a.seed, a.save_tx, a.save_symbols, a.tx_only)
