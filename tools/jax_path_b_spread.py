"""How much chip_smoke.py's path B median moves with the realization, in the
JAX package.

Path B (tools/jax_cr_serve_reference.py): every channel of the north-star
field at its own receiver clock offset, feedforward clock recovery and the
da-rde/dd-lms batch chain. Its median BER over the 22 polarizations sits
where some channels slip quarter turns and some clock estimates miss, so
it depends on the noise realization. This script reruns path B with other
LO, receiver and jitter keys, at the chip_smoke offsets (-200 + 40 k ppm)
and at a quarter of them, and prints the median BER and GMI, the number of
polarizations below BER 1e-2 and the offset estimates of each run.

Usage: JAX_PLATFORMS=cpu python tools/jax_path_b_spread.py [seed ...]
(default seeds 2 3; about 95 s per run on 8 CPU cores after the SSFM).
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

import numpy as np  # noqa: E402

import jax_cr_serve_reference as ref  # noqa: E402
from opticommpy_tpu.models import SSFMConfig, manakov_ssf  # noqa: E402
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx  # noqa: E402


def main(seeds):
    k_tx, k_ch, _, _ = jax.random.split(jax.random.PRNGKey(0), 4)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=16, nBits=2**18, nChannels=ref.N_CHANNELS,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(-2.0,), wdmGridSpacing=37.5e9,
                         laserLinewidth=100e3)
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    cfg_ch = SSFMConfig(Ltotal=250, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3, Fs=ref.FS,
                        amp="edfa", NF=4.5, nlprMethod=False, trapIters=1, fusedLinear=True)
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    base = list(ref.PPM_B)
    for scale in (1.0, 0.25):
        ref.PPM_B = [scale * p for p in base]
        for seed in seeds:
            k_lo, k_rx, k_j = jax.random.split(jax.random.PRNGKey(seed), 3)
            t0 = time.time()
            out = ref.path_b(sig_ch, symb_tx, k_lo, k_rx, k_j)
            bers = np.array([c["ber"] for c in out["channels"]]).ravel()
            gmis = np.array([c["gmi"] for c in out["channels"]]).ravel()
            print(json.dumps({"ppm_scale": scale, "seed": seed,
                              "median_ber": float(np.median(bers)),
                              "median_gmi": float(np.median(gmis)),
                              "n_below_1e-2": int(np.sum(bers < 1e-2)),
                              "ppm_est": out["ppm_est"], "seconds": time.time() - t0}),
                  flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [2, 3])
