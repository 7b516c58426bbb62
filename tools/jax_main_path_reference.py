"""The JAX package's result on the port's main path, for chip_smoke.py's bounds.

Runs opticommpy_tpu on the CPU at the configuration chip_smoke.py drives
through opticommpy_torch on the GPU: 11 channels of 16-QAM polmux at
32 GBd, SpS 16, 2**18 bits per signal (2**20 samples) on a 37.5 GHz grid at
-2 dBm per channel, 5 x 50 km of Manakov fiber (hz 0.5 km, fused linear
steps, EDFA NF 4.5), a 10 dBm / 100 kHz / 150 MHz-offset LO, the PDM
coherent receiver, the centre channel through coherent_dsp_chain (L 250 km,
nTrain 12000, mu (5e-3, 2e-3)), and BER, GMI and EVM after discarding
nTrain + 2000 symbols. The equalizer and BPS run their scan and broadcast
forms, which the JAX package's tests pin to its kernels.

Usage: JAX_PLATFORMS=cpu python tools/jax_main_path_reference.py
Prints one JSON line with the per-polarization BER, GMI and EVM.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from opticommpy_tpu.comm.metrics import calc_evm, fast_ber_calc, monte_carlo_gmi  # noqa: E402
from opticommpy_tpu.dsp import EDCConfig, edc  # noqa: E402
from opticommpy_tpu.models import (  # noqa: E402
    LaserConfig,
    PDMFrontendConfig,
    SSFMConfig,
    basic_laser_model,
    manakov_ssf,
    pdm_coherent_receiver,
)
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx  # noqa: E402
from opticommpy_tpu.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync  # noqa: E402
from opticommpy_tpu.pipelines import CoherentDSPConfig, coherent_dsp_chain  # noqa: E402


def main():
    t0 = time.time()
    k_tx, k_ch, k_lo, k_rx = jax.random.split(jax.random.PRNGKey(0), 4)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=16, nBits=2**18, nChannels=11,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(-2.0,), wdmGridSpacing=37.5e9,
                         laserLinewidth=100e3)
    fs = cfg_tx.Fs
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    cfg_ch = SSFMConfig(Ltotal=250, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3,
                        Fs=fs, amp="edfa", NF=4.5, nlprMethod=False, trapIters=1,
                        fusedLinear=True)
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=fs,
                                       freqShift=150e6, RIN_var=0.0), k_lo)
    sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), key=k_rx)
    pulse = pulse_shape("rrc", 16, 1024, 0.01)
    pre = decimate(fir_filter(pulse, sig_rx), 16, 2)
    pre = edc(pre, EDCConfig(L=250, D=16, Fs=64e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(pre, symb_tx[:, :, 5], 2))
    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=12000, mu=(5e-3, 2e-3),
                            eqBackend="scan", cprBackend="xla")
    y, _ = coherent_dsp_chain(sig_rx, d_ref, cfg)
    disc = cfg.nTrain + 2000
    y, d = y[disc:-100], d_ref[disc:-100]
    ber, _, snr = fast_ber_calc(y, d, 16, "qam")
    gmi, _ = monte_carlo_gmi(y, d, 16, "qam")
    evm = calc_evm(y, 16, "qam", symb_tx=d)
    print(json.dumps({"ber": np.asarray(ber).tolist(), "gmi": np.asarray(gmi).tolist(),
                      "evm": np.asarray(evm).tolist(), "snr_db": np.asarray(snr).tolist(),
                      "seconds": time.time() - t0, "jax": jax.__version__}))


if __name__ == "__main__":
    main()
