"""WDM transmission with the physical (Giles) EDFA amplifying each span, on
the PyTorch port (examples/wdm_amp_transmission.py's flow).

3-channel polmux 16-QAM WDM -> per span {Manakov SSFM (amp='none') on the
device, Giles EDFA with AGC: FFTs and ASE noise on the device, its
boundary-value solver and PID loop on the host} -> coherent detection of the
centre channel -> the DSP chain on the Hopper kernels (the equalizer on K2,
BPS on K1) -> BER/SNR/GMI.

Usage: python examples/port/wdm_amp_transmission.py [--cpu]
(--cpu runs on CPU tensors, where the kernels' plain versions run.)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from opticommpy_torch.comm.metrics import fast_ber_calc, monte_carlo_gmi  # noqa: E402
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
from opticommpy_torch.models.amplification import EDFASMConfig, edfa_sm  # noqa: E402
from opticommpy_torch.models.tx import WDMTxConfig, simple_wdm_tx  # noqa: E402
from opticommpy_torch.ops import (  # noqa: E402
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


def main():
    dev = torch.device("cpu" if "--cpu" in sys.argv else "cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    cfg_tx = WDMTxConfig(
        M=16, Rs=32e9, SpS=8, nBits=2**14, nChannels=3, nPolModes=2,
        nFilterTaps=1024, pulseRollOff=0.01, powerPerChannel=(-2.0,),
        laserLinewidth=100e3, wdmGridSpacing=50e9,
    )
    fs = cfg_tx.Fs
    sig, symb_tx, grid = simple_wdm_tx(gen, cfg_tx)
    print(f"Tx: {cfg_tx.nChannels}-ch WDM, {sig.shape[0]} samples @ {fs / 1e9:.0f} GHz "
          f"on {sig.device}")

    # one span of fiber, no inline amplification (loss stays in the field)
    cfg_span = SSFMConfig(Ltotal=L_SPAN, Lspan=L_SPAN, alpha=0.2, D=16, gamma=1.3, Fs=fs,
                          amp="none", nlprMethod=True, maxNlinPhaseRot=2e-2)
    # physical EDFA restoring the 10 dB span loss via AGC pump control
    cfg_edfa = EDFASMConfig(type="AGC", value=cfg_span.alpha * L_SPAN, lngth=8.0,
                            forPumpW=(60e-3,), bckPumpW=(0.0,), noiseBand=100e9,
                            tolCtrl=0.5)
    for n in range(N_SPANS):
        t0 = time.time()
        sig = manakov_ssf(sig, cfg_span)
        t_ssfm = time.time() - t0
        t0 = time.time()
        amplified, ppf, _, _ = edfa_sm(sig, fs, FC, cfg_edfa, generator=gen)
        gain = 10 * torch.log10(torch.mean(amplified.abs() ** 2)
                                / torch.mean(sig.abs().double() ** 2))
        sig = amplified.to(torch.complex64)
        print(f"span {n + 1}: SSFM {t_ssfm:.1f}s | Giles EDFA {time.time() - t0:.1f}s, "
              f"gain {float(gain):.2f} dB, pump {1e3 * float(ppf[0]):.1f} mW")

    # --- coherent detection of the centre channel ---------------------------
    centre = cfg_tx.nChannels // 2
    lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig.shape[0], Fs=fs,
                                       freqShift=float(grid[centre]) + 80e6, RIN_var=0.0), gen)
    rx = pdm_coherent_receiver(sig, lo, PDMFrontendConfig(Fs=fs), generator=gen)
    rx = fir_filter(lowpass_fir(0.6 * cfg_tx.Rs, fs, 501), rx)
    mf = fir_filter(pulse_shape("rrc", cfg_tx.SpS, 1024, cfg_tx.pulseRollOff), rx)
    dec = decimate(mf, cfg_tx.SpS, 2)
    cd = edc(dec, EDCConfig(L=N_SPANS * L_SPAN, D=16, Fs=2 * cfg_tx.Rs, Rs=cfg_tx.Rs))
    d_ref = pnorm(symbol_sync(cd, symb_tx[:, :, centre], 2))
    n_sym = d_ref.shape[0]
    n_train = min(2000, n_sym // 2)
    y = mimo_adapt_equalizer(
        pnorm(cd),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
                            L=(n_train, n_sym - n_train), M=16, numIter=2, backend="pallas"),
        symb_ref=d_ref,
    )
    y = cpr(y, CPRConfig(alg="bps-pallas", M=16, N=35, B=64, Ts=1 / cfg_tx.Rs))

    disc = n_train + 500
    y, d = y[disc:-64], d_ref[disc:-64]
    ber, _, snr = fast_ber_calc(y, d, 16, "qam")
    gmi, ngmi = monte_carlo_gmi(y, d, 16, "qam")
    print(f"centre channel after {N_SPANS * L_SPAN:.0f} km w/ Giles EDFAs:")
    print(f"  BER = {ber.cpu().numpy()}")
    print(f"  SNR = {snr.cpu().numpy()} dB")
    print(f"  GMI = {gmi.cpu().numpy()} bits (NGMI {ngmi.cpu().numpy()})")


if __name__ == "__main__":
    main()
