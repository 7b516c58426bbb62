"""Coherent 16-QAM polmux over the nonlinear Manakov channel with the full
DSP chain, on the PyTorch port (examples/coherent_wdm_transmission.py's
flow, BASELINE config 3): WDM Tx -> Manakov SSFM + EDFAs -> PDM coherent
receiver -> matched filter -> decimation -> EDC -> sync -> MIMO adaptive EQ
(K2) -> BPS carrier recovery (K1) -> BER/GMI/EVM. Saves ``wdm_const.png``.

Usage: python examples/port/coherent_wdm_transmission.py [--cpu]
(--cpu runs on CPU tensors, where the kernels' plain versions run.)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from opticommpy_torch.comm.metrics import calc_evm, fast_ber_calc, monte_carlo_gmi  # noqa: E402
from opticommpy_torch.dsp import (  # noqa: E402
    CPRConfig,
    EDCConfig,
    MIMOEqualizerConfig,
    cpr,
    edc,
    mimo_adapt_equalizer,
)
from opticommpy_torch.models import (  # noqa: E402
    LaserConfig,
    PDMFrontendConfig,
    SSFMConfig,
    basic_laser_model,
    manakov_ssf,
    pdm_coherent_receiver,
)
from opticommpy_torch.models.tx import WDMTxConfig, simple_wdm_tx  # noqa: E402
from opticommpy_torch.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync  # noqa: E402


def main():
    dev = torch.device("cpu" if "--cpu" in sys.argv else "cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=2**17, nChannels=1, nPolModes=2,
                         nFilterTaps=1024, pulseRollOff=0.01, powerPerChannel=(1.0,),
                         laserLinewidth=100e3)
    fs = cfg_tx.Fs
    t0 = time.time()
    sig_tx, symb_tx, _ = simple_wdm_tx(gen, cfg_tx)
    print(f"Tx: {tuple(sig_tx.shape)} on {sig_tx.device} in {time.time() - t0:.1f}s")

    cfg_ch = SSFMConfig(Ltotal=400, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fs=fs, amp="edfa",
                        NF=4.5, nlprMethod=True)
    t0 = time.time()
    sig_ch = manakov_ssf(sig_tx, cfg_ch, gen)
    if sig_ch.is_cuda:
        torch.cuda.synchronize()
    print(f"Manakov SSFM 400 km: {time.time() - t0:.1f}s")

    lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=fs,
                                       freqShift=150e6, RIN_var=0.0), gen)
    sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), generator=gen)

    t0 = time.time()
    sig_mf = fir_filter(pulse_shape("rrc", cfg_tx.SpS, 1024, cfg_tx.pulseRollOff), sig_rx)
    sig_dec = decimate(sig_mf, cfg_tx.SpS, 2)
    sig_cd = edc(sig_dec, EDCConfig(L=400, D=16, Fs=2 * 32e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(sig_cd, symb_tx[:, :, 0], 2))
    n_sym = d_ref.shape[0]
    n_train = 12000
    y_eq = mimo_adapt_equalizer(
        pnorm(sig_cd),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
                            L=(n_train, n_sym - n_train), M=16, numIter=2, backend="pallas"),
        symb_ref=d_ref,
    )
    y = cpr(y_eq, CPRConfig(alg="bps-pallas", M=16, N=75, B=64, Ts=1 / 32e9))
    print(f"DSP chain: {time.time() - t0:.1f}s")

    disc = n_train + 2000
    y, d = y[disc:-100], d_ref[disc:-100]
    ber, _, snr = fast_ber_calc(y, d, 16, "qam")
    gmi, ngmi = monte_carlo_gmi(y, d, 16, "qam")
    evm = calc_evm(y, 16, "qam", symb_tx=d)
    print(f"BER  = {ber.cpu().numpy()}")
    print(f"SNR  = {snr.cpu().numpy()} dB")
    print(f"GMI  = {gmi.cpu().numpy()} bits  (NGMI {ngmi.cpu().numpy()})")
    print(f"EVM  = {100 * evm.cpu().numpy()} %")

    from opticommpy_torch.plot import pconst

    ax = pconst(y, density=True)
    ax.figure.savefig("wdm_const.png", dpi=120, bbox_inches="tight")
    print("saved wdm_const.png")


if __name__ == "__main__":
    main()
