"""Save the signals the JAX package's feedforward clock recovery retimes on
chip_smoke.py's path B, with its estimates and outputs, for
tools/torch_ffw_on_jax_inputs.py.

The signals are those of tools/jax_cr_serve_reference.py (same field, same
keys): channel k of the north-star field at a receiver clock -200 + 40 k
ppm fast, through the matched filter, decimation to 2 samples/symbol, EDC
and pnorm, all cut to the shortest. On each, ffw_clock_recovery with the
chain's configuration (blockLen 4096, maxPPM 500, rollOff 0.01, linear fit)
gives the clock estimate in ppm, the per-block timing and the retimed
signal.

Usage: JAX_PLATFORMS=cpu python tools/jax_path_b_inputs.py [OUT.npz]
(default build/path_b_inputs.npz, about 50 MB; about 90 s on 8 CPU cores).
"""

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
from opticommpy_tpu.dsp.clock_recovery import ffw_clock_recovery  # noqa: E402


def main(out_path):
    t0 = time.time()
    sig_ch, symb_tx, (k_lo, k_rx, k_j), _ = ref.field()
    fronts, _ = ref.path_b_fronts(sig_ch, symb_tx, k_lo, k_rx, k_j)
    ys, ppms, taus = [], [], []
    for x in fronts:
        y, (ppm, tau) = ffw_clock_recovery(x, ref.B_CR_CFG, return_est=True)
        ys.append(np.asarray(y))
        ppms.append(float(ppm))
        taus.append(np.asarray(tau))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, x=np.asarray(fronts), y=np.stack(ys), ppm=np.array(ppms),
             tau=np.stack(taus), ppm_true=np.array(ref.PPM_B),
             block_len=ref.B_CR_CFG.blockLen, max_ppm=ref.B_CR_CFG.maxPPM,
             roll_off=ref.B_CR_CFG.rollOff)
    print(f"saved {out_path}: signals {tuple(fronts.shape)}, JAX ppm estimates "
          f"{[round(p, 4) for p in ppms]}, {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "build/path_b_inputs.npz")
