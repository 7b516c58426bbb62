"""The JAX package's blocked training (blockUpdate 16) on the port's
11-channel WDM receiver, for the bounds of chip_smoke.py's phase K.

The field, the receivers and the front end are those of
tools/jax_wdm_receiver_reference.py (imported from it): 11 channels of
16-QAM polmux at 32 GBd, 2**20 samples, 5 x 50 km, each channel through its
own LO and the steps of coherent_dsp_chain_batch (4th-power FOE before the
equalizer). The equalizer then runs the schedule ("da-rde", "dd-lms") with
mu (5e-3, 1e-3) and numIter 2, once with blockUpdate 16 (the blocked
route, as phase K's K-batch) and once with blockUpdate 1 (the per-symbol
route at the same steps, the control). BER, GMI and EVM per channel after
nTrain + 2000 symbols, and the medians over the 22 polarizations.

Usage: JAX_PLATFORMS=cpu python tools/jax_blocked_wdm_reference.py
Prints one JSON line: per run, per channel, the per-polarization BER, GMI,
EVM and SNR, and the median BER and GMI.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import jax_wdm_receiver_reference as wdm  # noqa: E402
from opticommpy_tpu.comm.metrics import calc_evm, fast_ber_calc, monte_carlo_gmi  # noqa: E402
from opticommpy_tpu.comm.modulation import gray_mapping  # noqa: E402
from opticommpy_tpu.dsp import MIMOEqualizerConfig  # noqa: E402
from opticommpy_tpu.dsp.carrier_recovery import bps  # noqa: E402
from opticommpy_tpu.dsp.equalization import mimo_adapt_equalizer_batch  # noqa: E402
from opticommpy_tpu.models import SSFMConfig, manakov_ssf  # noqa: E402
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx  # noqa: E402

RUNS = {"blocked K=16": 16, "per-symbol K=1": 1}
MUS = (5e-3, 1e-3)


def equalize_and_score(x_b, ref_b, k_block):
    n_sym = ref_b.shape[1]
    cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=MUS, alg=("da-rde", "dd-lms"),
                              L=(wdm.N_TRAIN, n_sym - wdm.N_TRAIN), M=16, numIter=2,
                              blockUpdate=k_block, backend="scan")
    y = mimo_adapt_equalizer_batch(x_b, cfg, symb_ref=ref_b)
    const = gray_mapping(16, "qam")
    const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)
    b, n, m = y.shape
    y_cols = jnp.moveaxis(y, 0, 1).reshape(n, b * m)
    phases = jnp.unwrap(4 * bps(y_cols, 37, jnp.asarray(const), 64), axis=0) / 4
    out = jnp.moveaxis((y_cols * jnp.exp(1j * phases)).reshape(n, b, m), 1, 0)
    disc = wdm.N_TRAIN + 2000
    rows = []
    for k in range(b):
        yy, dd = out[k, disc:-100], ref_b[k, disc:-100]
        ber, _, snr = fast_ber_calc(yy, dd, 16, "qam")
        gmi, _ = monte_carlo_gmi(yy, dd, 16, "qam")
        evm = calc_evm(yy, 16, "qam", symb_tx=dd)
        rows.append({"ber": np.asarray(ber).tolist(), "gmi": np.asarray(gmi).tolist(),
                     "evm": np.asarray(evm).tolist(), "snr_db": np.asarray(snr).tolist()})
    return dict(channels=rows, median_ber=float(np.median([r["ber"] for r in rows])),
                median_gmi=float(np.median([r["gmi"] for r in rows])))


def main():
    t0 = time.time()
    k_tx, k_ch, k_lo, k_rx = jax.random.split(jax.random.PRNGKey(0), 4)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=16, nBits=2**18, nChannels=wdm.N_CHANNELS,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(-2.0,), wdmGridSpacing=37.5e9,
                         laserLinewidth=100e3)
    fs = cfg_tx.Fs
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    cfg_ch = SSFMConfig(Ltotal=250, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3,
                        Fs=fs, amp="edfa", NF=4.5, nlprMethod=False, trapIters=1,
                        fusedLinear=True)
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    x_b, ref_b = wdm.receive(sig_ch, fs, k_lo, k_rx, symb_tx)
    result = {"jax": jax.__version__, "mu": MUS}
    for name, k_block in RUNS.items():
        result[name] = equalize_and_score(x_b, ref_b, k_block)
    result["seconds"] = time.time() - t0
    print(json.dumps(result))


if __name__ == "__main__":
    main()
