"""The JAX package's result on chip_smoke.py's IM-DD serving path (path H),
for its bounds.

Runs opticommpy_tpu on the CPU at the configuration of bench.run_imdd_chain
(bench.py:410-466), which chip_smoke.py drives through opticommpy_torch on
the GPU: 8 links of PAMTxConfig(M=4, Rs=25e9, SpS=8, nBits=2**17,
pulseType="nrz", power=3.0), each through linear_fiber_channel
(LinearFiberConfig(L=10, alpha=0.2, D=17, Fs=200e9)) and photodiode
(PhotodiodeConfig(Fs=200e9, B=20e9)), drawn from PRNGKey(5) as bench.py
draws them; then imdd_dsp_chain_batch with IMDDConfig(SpS_in=8, nTapsFF=15,
nTapsFB=5, mu=2e-3, nTrain=8000), the DFE and the FFE (its kernel in
interpret mode, as the JAX package runs it on the CPU).

Scores per link: BER after 2 * nTrain symbols (fast_ber_calc against the
pnorm-ed reference, as bench.py scores it) and the MSE of the last 4000
symbols.

Also the JAX Volterra scan (``volterra``) on the signal of
bench_dsp.bench_volterra (bench_dsp.py:350-360: PAM4 at SpS 2, 16,384
symbols, 13 / 7 / 5 taps, mu 1e-3, nTrain 4000) with the 8 noise draws
chip_smoke.py's K14 phase uses (rng seeds 4-11), at order 2 and 3: the BER
after nTrain per row, which chip_smoke.py requires to be 0 on the card.

Usage: JAX_PLATFORMS=cpu python tools/jax_imdd_reference.py
Prints one JSON line with the scores of both equalizers and the Volterra
BERs.
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

from opticommpy_tpu.comm.metrics import fast_ber_calc  # noqa: E402
from opticommpy_tpu.dsp.equalization import VolterraConfig, volterra  # noqa: E402
from opticommpy_tpu.models import (  # noqa: E402
    LinearFiberConfig,
    PhotodiodeConfig,
    linear_fiber_channel,
    photodiode,
)
from opticommpy_tpu.models.tx import PAMTxConfig, pam_transmitter  # noqa: E402
from opticommpy_tpu.ops.signal import pnorm  # noqa: E402
from opticommpy_tpu.pipelines import IMDDConfig, imdd_dsp_chain_batch  # noqa: E402

N_LINKS = 8


def links(n_bits=2**17, seed=5):
    """(currents (B, N) f32, references (B, nSym) f32), as bench.run_imdd_chain
    synthesizes them."""
    cfg_tx = PAMTxConfig(M=4, Rs=25e9, SpS=8, nBits=n_bits, pulseType="nrz", power=3.0)
    fs = cfg_tx.Fs

    @jax.jit
    def synth(key):
        def one(k):
            k_tx, k_pd = jax.random.split(k)
            sig, symb = pam_transmitter(k_tx, cfg_tx)
            rx = linear_fiber_channel(sig, LinearFiberConfig(L=10, alpha=0.2, D=17, Fs=fs))
            i_rx = photodiode(rx, PhotodiodeConfig(Fs=fs, B=20e9), k_pd)
            return i_rx.astype(jnp.float32), symb.real.astype(jnp.float32)

        return jax.vmap(one)(jax.random.split(key, N_LINKS))

    return synth(jax.random.PRNGKey(seed))


def scores(y, mse, ref, n_train):
    post = 2 * n_train
    out = []
    for b in range(y.shape[0]):
        ber = fast_ber_calc(y[b, post:].real, pnorm(ref[b])[post:], 4, "pam")[0]
        out.append((float(ber[0]), float(jnp.mean(mse[b, -4000:]))))
    return out


def volterra_bers(order, n_rows=N_LINKS, n_sym=16384, sps=2, seed=4):
    """BER after nTrain of the JAX Volterra scan on each row of
    bench_dsp.py's signal, row b drawn from rng seed ``seed + b``."""
    cfg = VolterraConfig(n1Taps=13, n2Taps=7, n3Taps=5, SpS=sps, mu=1e-3, nTrain=4000,
                         order=order, M=4, constType="pam")
    run = jax.jit(lambda s, r: volterra(s, r, cfg)[0])
    out = []
    for b in range(n_rows):
        rng = np.random.default_rng(seed + b)
        sym = (2 * rng.integers(0, 4, size=n_sym) - 3).astype(np.float32)
        sig = np.repeat(sym, sps) + 0.1 * rng.normal(size=n_sym * sps)
        sig = (sig + 0.05 * sig**2).astype(np.float32)
        y = run(jnp.asarray(sig), jnp.asarray(sym))
        ber = fast_ber_calc(y[cfg.nTrain:], pnorm(jnp.asarray(sym))[cfg.nTrain:], 4, "pam")[0]
        out.append(float(ber[0]))
    return out


def main():
    t0 = time.perf_counter()
    i_b, ref_b = links()
    i_b.block_until_ready()
    result = {"synth_s": time.perf_counter() - t0}
    for eq in ("dfe", "ffe"):
        cfg = IMDDConfig(SpS_in=8, nTapsFF=15, nTapsFB=5, mu=2e-3, nTrain=8000, eq=eq)
        t0 = time.perf_counter()
        y, mse = imdd_dsp_chain_batch(i_b, ref_b, cfg)
        result[eq] = scores(y, mse, ref_b, cfg.nTrain)
        result[f"{eq}_s"] = time.perf_counter() - t0
    for order in (2, 3):
        result[f"volterra_order{order}_ber"] = volterra_bers(order)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
