"""Perturbation-based nonlinearity compensation (NLC) on a coherent link, on
the PyTorch port (examples/perturbation_nlc.py's flow).

A single-channel 64-QAM polmux link is propagated with the Manakov SSFM
across a launch-power sweep (one batched SSFM call), received with the
linear DSP chain (matched filter, EDC, the adaptive MIMO equalizer on K2,
BPS on K1), and then the intra-channel NLIN is estimated from the
hard-decided symbols with the first-order perturbation model and
subtracted at the EVM-best amplitude/phase of a 10 x 10 grid. Saves
``perturbation_nlc.png``.

Usage: python examples/port/perturbation_nlc.py [--cpu]
(--cpu runs on CPU tensors, where the kernels' plain versions run;
OPTICOMMPY_TORCH_FAST=1 runs a smaller link.)
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from opticommpy_torch.comm.metrics import fast_ber_calc  # noqa: E402
from opticommpy_torch.comm.modulation import detector, norm_const  # noqa: E402
from opticommpy_torch.dsp import (  # noqa: E402
    CPRConfig,
    EDCConfig,
    MIMOEqualizerConfig,
    cpr,
    edc,
    mimo_adapt_equalizer,
)
from opticommpy_torch.models import SSFMConfig, manakov_ssf  # noqa: E402
from opticommpy_torch.models.perturbation import PerturbationConfig, perturbation_nlin  # noqa: E402
from opticommpy_torch.models.tx import (  # noqa: E402
    WDMTxConfig,
    set_power_for_par_ssfm,
    simple_wdm_tx,
)
from opticommpy_torch.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync  # noqa: E402
from opticommpy_torch.utils.units import ber2qfactor  # noqa: E402

M = 64
RS = 32e9
SPS = 8
FAST = os.environ.get("OPTICOMMPY_TORCH_FAST") == "1"
N_SYMBOLS = 2**12 if FAST else 98_304  # per polarization
LINK_KM, SPAN_KM = (200.0 if FAST else 800.0), 50.0
DISP = 17.0
POWERS_DBM = tuple(np.arange(-2.0, 5.0, 3.0 if FAST else 1.5))
N_TRAIN = 1000 if FAST else 4000
DISCARD = N_TRAIN + (200 if FAST else 1000)


def linear_rx(sig_rx, symb_ref, pulse):
    """Matched filter -> EDC -> MIMO equalizer (K2) -> BPS (K1)."""
    sig_dec = decimate(fir_filter(pulse, sig_rx), SPS, 2)
    sig_edc = edc(sig_dec, EDCConfig(L=LINK_KM, D=DISP, Fs=2 * RS, Rs=RS))
    d_ref = pnorm(symbol_sync(sig_edc, symb_ref, 2))
    n_sym = d_ref.shape[0]
    y = mimo_adapt_equalizer(
        pnorm(sig_edc),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(2e-3, 2e-3), alg=("nlms", "dd-lms"),
                            L=(N_TRAIN, n_sym - N_TRAIN), M=M, numIter=2, backend="pallas"),
        symb_ref=d_ref,
    )
    y = cpr(y, CPRConfig(alg="bps-pallas", M=M, N=50, B=64, Ts=1 / RS))
    return pnorm(y[DISCARD:-100]), d_ref[DISCARD:-100]


def nlc_correct(symb_rx, symb_hat, p_dbm, n_grid=10):
    """Estimate NLIN from symb_hat, subtract with EVM-optimal amp/phase."""
    cfg = PerturbationConfig(D=DISP, alpha=0.2, lspan=SPAN_KM, length=LINK_KM, gamma=1.3,
                             Rs=RS, mode="AMR", coeffTol=-30.0,
                             matrixOrder=10 if FAST else 50, Pin=p_dbm)
    nlin = perturbation_nlin(symb_hat, cfg)
    p_peak = 0.5 * 10 ** (p_dbm / 10) * 1e-3
    delta = pnorm(math.sqrt(p_peak) * pnorm(symb_hat) + nlin) - pnorm(symb_hat)
    dev = symb_rx.device
    amps = torch.linspace(0.1, 4.1, n_grid, device=dev)
    phases = torch.arange(n_grid, device=dev, dtype=torch.float32) * (2 * math.pi / n_grid)
    scale = (amps[:, None] * torch.exp(1j * phases[None, :])).reshape(-1)
    cand = symb_rx[None] - scale[:, None, None] * delta[None]
    cand = cand / torch.sqrt(torch.mean(cand.abs() ** 2, dim=(1, 2), keepdim=True))
    evm = torch.mean((cand - pnorm(symb_hat)[None]).abs() ** 2, dim=(1, 2))
    return cand[torch.argmin(evm)]


def main():
    dev = torch.device("cpu" if "--cpu" in sys.argv else "cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg_tx = WDMTxConfig(M=M, Rs=RS, SpS=SPS, nBits=6 * N_SYMBOLS, nChannels=1, nPolModes=2,
                         nFilterTaps=1024, pulseRollOff=0.01, powerPerChannel=(0.0,),
                         laserLinewidth=0.0)
    sig_tx, symb_tx, _ = simple_wdm_tx(gen, cfg_tx)
    symb_ref = symb_tx[:, :, 0]
    sig_batch = set_power_for_par_ssfm(torch.cat([sig_tx] * len(POWERS_DBM), dim=1),
                                       POWERS_DBM)
    cfg_ch = SSFMConfig(Ltotal=LINK_KM, Lspan=SPAN_KM, hz=0.5, alpha=0.2, D=DISP, gamma=1.3,
                        Fs=cfg_tx.Fs, amp="ideal", nlprMethod=False, trapIters=1,
                        fusedLinear=True)
    sig_rx_all = manakov_ssf(sig_batch, cfg_ch, gen)
    pulse = pulse_shape("rrc", SPS, 1024, 0.01)
    const = torch.as_tensor(norm_const(M, "qam"), device=dev)

    results = {k: [] for k in ("edc", "nlc", "nlc_ideal")}
    print(f"{'P[dBm]':>7} {'SNR_EDC':>8} {'SNR_NLC':>8} {'SNR_NLCid':>9} "
          f"{'BER_EDC':>9} {'BER_NLC':>9}")
    for i, p_dbm in enumerate(POWERS_DBM):
        y, d = linear_rx(sig_rx_all[:, 2 * i:2 * i + 2], symb_ref, pulse)
        # hard decisions feed the data-driven NLC; true symbols the ideal bound
        symb_hat = torch.stack([detector(y[:, k], 0.5, const, rule="ML")[0] for k in range(2)],
                               dim=1)
        arms = (("edc", y), ("nlc", nlc_correct(y, symb_hat, float(p_dbm))),
                ("nlc_ideal", nlc_correct(y, d, float(p_dbm))))
        row = []
        for name, sig in arms:
            ber, _, snr = fast_ber_calc(sig, d, M, "qam")
            results[name].append((float(torch.mean(ber)), float(torch.mean(snr))))
            row.append(results[name][-1])
        print(f"{p_dbm:7.1f} {row[0][1]:8.2f} {row[1][1]:8.2f} {row[2][1]:9.2f} "
              f"{row[0][0]:9.2e} {row[1][0]:9.2e}")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 1, figsize=(6, 10), sharex=True)
    style = {"edc": ("x-", "EDC only"), "nlc": ("o-", "NLC hard decisions"),
             "nlc_ideal": ("k--", "NLC ideal decisions")}
    for name, vals in results.items():
        ber = np.array([max(v[0], 1e-7) for v in vals])
        fmt, label = style[name]
        axes[0].semilogy(POWERS_DBM, ber, fmt, label=label)
        axes[1].plot(POWERS_DBM, ber2qfactor(torch.as_tensor(np.clip(ber, 1e-7, 0.49))).numpy(),
                     fmt, label=label)
        axes[2].plot(POWERS_DBM, [v[1] for v in vals], fmt, label=label)
    axes[0].set_ylabel("BER")
    axes[1].set_ylabel("$Q^2$ [dB]")
    axes[2].set_ylabel("SNR [dB]")
    axes[2].set_xlabel("launch power [dBm]")
    for ax in axes:
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    axes[0].set_title(f"DP-{M}QAM, {LINK_KM:.0f} km, D={DISP} ps/nm/km")
    fig.tight_layout()
    fig.savefig(os.path.join(os.path.dirname(os.path.abspath(__file__)), "perturbation_nlc.png"),
                dpi=110)
    print("saved perturbation_nlc.png")


if __name__ == "__main__":
    main()
