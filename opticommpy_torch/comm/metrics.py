"""Performance metrics: BER/SER/SNR, OOK BER and Q, LLRs, GMI, EVM, and
the AWGN theory curves.

Port of ``opticommpy_tpu/comm/metrics.py`` (the part the coherent and IM-DD
paths use). All Monte-Carlo metrics are batched over modes and stay on the
input's device; :func:`theory_ber` is host NumPy/SciPy.
"""

import math

import numpy as np
import torch
from scipy.special import erf

from opticommpy_torch.comm.modulation import (
    bit_map,
    demodulate_gray,
    gray_mapping,
    min_euclid,
)
from opticommpy_torch.ops.signal import pnorm
from opticommpy_torch.utils.units import db2lin

__all__ = ["bert", "fast_ber_calc", "calc_llr", "monte_carlo_gmi", "calc_evm", "qfunc",
           "theory_ber"]


def qfunc(x):
    """Gaussian tail function Q(x) = 0.5*erfc(x/sqrt(2)) (metrics.py:550),
    as ``0.5 - 0.5*erf(x/sqrt(2))``; a tensor stays a tensor, anything else
    is computed in NumPy."""
    if isinstance(x, torch.Tensor):
        return 0.5 - 0.5 * torch.special.erf(x / math.sqrt(2.0))
    return 0.5 - 0.5 * erf(np.asarray(x) / np.sqrt(2.0))


def bert(i_rx, bits_tx):
    """OOK BER and Q factor from received intensities (metrics.py:37).

    Per-level means and deviations, the optimal threshold
    ``Id = (s1*I0 + s0*I1)/(s1+s0)``, ``Q = (I1 - I0)/(s1 + s0)``, and the
    BER of the decisions ``i_rx > Id`` against ``bits_tx`` (required).
    Returns (ber, q) as 0-dim tensors on the input's device.
    """
    i_rx = torch.as_tensor(i_rx).reshape(-1)
    bits_tx = torch.as_tensor(bits_tx).to(i_rx.device).reshape(-1)
    is1 = bits_tx == 1
    zero = torch.zeros((), dtype=i_rx.dtype, device=i_rx.device)
    n1 = torch.sum(is1)
    n0 = bits_tx.shape[0] - n1
    i1 = torch.sum(torch.where(is1, i_rx, zero)) / n1
    i0 = torch.sum(torch.where(is1, zero, i_rx)) / n0
    var1 = torch.sum(torch.where(is1, (i_rx - i1) ** 2, zero)) / n1
    var0 = torch.sum(torch.where(is1, zero, (i_rx - i0) ** 2)) / n0
    std1, std0 = torch.sqrt(var1), torch.sqrt(var0)
    i_d = (std1 * i0 + std0 * i1) / (std1 + std0)
    q = (i1 - i0) / (std1 + std0)
    bits_rx = (i_rx > i_d).to(torch.int32)
    ber = torch.mean(torch.abs(bits_rx - bits_tx.to(torch.int32)).to(torch.float32))
    return ber, q


def _as_columns(x):
    x = torch.as_tensor(x)
    if x.ndim == 1:
        return x[:, None]
    return x.T if x.shape[1] > x.shape[0] else x


def _phase_align(rx, tx, const_type):
    """Correct a possible constant phase ambiguity: rx *= mean(tx/rx)."""
    if const_type in ("qam", "psk"):
        rx = torch.mean(tx / rx, dim=0, keepdim=True) * rx
    return rx


def _pnorm_cols(x):
    return x / torch.sqrt(torch.mean((x * x.conj()).real, dim=0, keepdim=True))


def _const_tensor(const, device):
    return torch.as_tensor(np.asarray(const).astype(np.complex64), device=device)


def fast_ber_calc(rx, tx, M, const_type, px=None):
    """Monte-Carlo BER/SER/SNR per mode (metrics.py:111).

    Returns (BER, SER, SNR_dB) tensors of length nModes.
    """
    if const_type == "ook":
        M = 2
    if px is None:
        px = np.ones(M) / M
    const = gray_mapping(M, const_type)
    es = float(np.sum(np.abs(const) ** 2 * np.asarray(px).reshape(-1)))
    rx = _as_columns(rx)
    tx = _as_columns(tx).to(rx.device)
    rx = _pnorm_cols(_phase_align(rx, tx, const_type))
    tx = _pnorm_cols(tx)

    err_pow = torch.mean(torch.abs(rx - tx) ** 2, dim=0)
    sig_pow_ = torch.mean(torch.abs(tx) ** 2, dim=0)
    snr = 10 * torch.log10(sig_pow_ / err_pow)

    bmap = torch.as_tensor(bit_map(M, const_type), device=rx.device)
    const_t = _const_tensor(const, rx.device)
    ind_rx = min_euclid(math.sqrt(es) * rx, const_t)
    ind_tx = min_euclid(math.sqrt(es) * tx, const_t)
    err = bmap[ind_rx] != bmap[ind_tx]  # (N, modes, b)
    ber = err.float().mean(dim=(0, 2))
    ser = err.any(dim=2).float().mean(dim=0)
    return ber, ser, snr


def calc_llr(rx_symb, noise_var, const_symb, bitmap, px):
    """Bit LLRs under a circular AWGN model (metrics.py:198), interleaved,
    length N*log2(M)."""
    rx_symb = torch.as_tensor(rx_symb).reshape(-1)
    dev = rx_symb.device
    const_symb = _const_tensor(const_symb, dev).reshape(-1)
    bitmap = torch.as_tensor(np.asarray(bitmap), device=dev).float()
    px = torch.as_tensor(np.asarray(px, np.float32).reshape(-1), device=dev)
    d2 = torch.abs(rx_symb[:, None] - const_symb[None, :]) ** 2
    logw = -d2 / noise_var + torch.log(px)[None, :]
    w = torch.exp(logw - torch.max(logw, dim=1, keepdim=True).values)
    p1 = w @ bitmap
    p0 = w @ (1.0 - bitmap)
    return (torch.log(p0) - torch.log(p1)).reshape(-1)


def monte_carlo_gmi(rx, tx, M, const_type, px=None):
    """Monte-Carlo generalized mutual information (metrics.py:329).

    Returns (GMI, NGMI) per mode, from the bitwise-MI estimator
    ``H/b - mean(log2(1 + exp((2b-1)*LLR)))``.
    """
    const = gray_mapping(M, const_type)
    b = int(np.log2(M))
    bmap = bit_map(M, const_type)
    if px is None:
        px = np.ones(M) / M
    px = np.asarray(px).reshape(-1)
    es = np.sum(np.abs(const) ** 2 * px)
    const_n = const / np.sqrt(es)
    H = float(-np.sum(px * np.log2(px)))

    rx = _as_columns(rx)
    tx = _as_columns(tx).to(rx.device)
    rx = _pnorm_cols(_phase_align(rx, tx, const_type))
    tx = _pnorm_cols(tx)
    d = rx - tx
    noise_var = (torch.abs(d - d.mean(dim=0, keepdim=True)) ** 2).mean(dim=0)

    gmi = []
    for k in range(rx.shape[1]):
        btx = demodulate_gray(math.sqrt(es) * tx[:, k], M, const_type)
        llrs = calc_llr(rx[:, k], noise_var[k], const_n, bmap, px)
        llrs = torch.clamp(llrs, -500.0, 500.0)
        sign = 2 * btx.float() - 1
        penalty = torch.logaddexp(torch.zeros_like(llrs), sign * llrs) / math.log(2.0)
        gmi.append(torch.sum(H / b - penalty.reshape(-1, b).mean(dim=0)))
    gmi = torch.stack(gmi)
    return gmi, gmi / H


def calc_evm(symb, M, const_type, symb_tx=None):
    """Error vector magnitude per mode (metrics.py:572)."""
    symb = _as_columns(pnorm(torch.as_tensor(symb)))
    const = pnorm(_const_tensor(gray_mapping(M, const_type), symb.device))
    if symb_tx is not None:
        symb_tx = pnorm(_as_columns(torch.as_tensor(symb_tx).to(symb.device)))
        symb = _phase_align(symb, symb_tx, const_type)
        decided = symb_tx
    else:
        decided = const[min_euclid(symb, const)]
    return (torch.mean(torch.abs(symb - decided) ** 2, dim=0)
            / torch.mean(torch.abs(decided) ** 2, dim=0))


def theory_ber(M, ebn0_db, const_type):
    """Approximate AWGN bit error probability for PAM/QAM/PSK
    (metrics.py:640), in NumPy float64."""
    ebn0 = db2lin(np.asarray(ebn0_db, np.float64))
    k = np.log2(M)
    if const_type == "qam":
        L = np.sqrt(M)
        return (2 * (1 - 1 / L) / np.log2(L)
                * qfunc(np.sqrt(3 * np.log2(L) / (L**2 - 1) * (2 * ebn0))))
    elif const_type == "psk":
        ps = 2 * qfunc(np.sqrt(2 * k * ebn0) * np.sin(np.pi / M))
        return ps / k
    elif const_type == "pam":
        ps = (2 * (M - 1) / M) * qfunc(np.sqrt(6 * np.log2(M) / (M**2 - 1) * ebn0))
        return ps / k
    raise ValueError("const_type must be 'qam', 'psk' or 'pam'")
