"""Performance metrics: BER/SER/SNR, OOK BER and Q, LLRs and extrinsic
LLRs, MI and GMI, EVM, the AWGN theory curves and the GN-model budget.

Port of ``opticommpy_tpu/comm/metrics.py``. All Monte-Carlo metrics are
batched over modes and stay on the input's device; :func:`theory_ber`,
:func:`theory_mi` (SciPy 2-D quadrature) and the GN-model and OSNR
functions are host NumPy/SciPy, copies of the JAX package's.
"""

import math

import numpy as np
import scipy.constants as sconst
import torch
from scipy.integrate import dblquad
from scipy.special import erf

from opticommpy_torch.comm.modulation import (
    bit_map,
    demodulate_gray,
    gray_mapping,
    min_euclid,
)
from opticommpy_torch.ops.signal import pnorm
from opticommpy_torch.utils.rng import as_device_tensor
from opticommpy_torch.utils.units import db2lin, llr2bit_prob

__all__ = ["bert", "fast_ber_calc", "calc_llr", "calc_extr_llr", "monte_carlo_gmi",
           "monte_carlo_mi", "calc_mi", "calc_evm", "qfunc", "theory_ber", "theory_mi",
           "gn_model_nyquist_wdm", "ase_nyquist_wdm", "gn_model_osnr", "calc_lin_osnr"]


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
    i_rx = as_device_tensor(i_rx).reshape(-1)
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


def _noise_var(rx, tx):
    """Per-column variance of ``rx - tx`` (``jnp.var``: mean of |d - mean|^2)."""
    d = rx - tx
    return (torch.abs(d - d.mean(dim=0, keepdim=True)) ** 2).mean(dim=0)


def _px_tensor(px, M, device):
    """``px`` (uniform when None) as float32 on ``device``."""
    if px is None:
        return torch.ones(M, device=device) / M
    return torch.as_tensor(np.asarray(px, np.float32).reshape(-1), device=device)


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
    rx = _as_columns(as_device_tensor(rx))
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
    rx_symb = as_device_tensor(rx_symb).reshape(-1)
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

    rx = _as_columns(as_device_tensor(rx))
    tx = _as_columns(tx).to(rx.device)
    rx = _pnorm_cols(_phase_align(rx, tx, const_type))
    tx = _pnorm_cols(tx)
    noise_var = _noise_var(rx, tx)

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


def calc_extr_llr(bit_llr, x, x_mu, x_nu, const_symb, bitmap, px=None):
    """Extrinsic bit LLRs under an auxiliary Gaussian model (metrics.py:242).

    Batched (N, M, b) tensors: the Gaussian likelihoods ``psi``, the symbol
    priors from the bit probabilities (clipped to [1e-4, 1 - 1e-4]) and the
    leave-one-bit-out prior division; variances floored at 1e-3, the
    extrinsic probabilities clipped as the bit probabilities. Interleaved,
    length N*b.
    """
    x = as_device_tensor(x).reshape(-1)
    dev = x.device
    const_symb = _const_tensor(const_symb, dev).reshape(-1)
    bitmap_f = torch.as_tensor(np.asarray(bitmap), device=dev).to(torch.float32)
    M, b = bitmap_f.shape
    px = _px_tensor(px, M, dev)
    x_mu = torch.as_tensor(x_mu).to(dev).reshape(-1)
    var = torch.clamp(torch.as_tensor(x_nu).to(dev).reshape(-1), min=1e-3)
    pb1 = torch.clamp(llr2bit_prob(torch.as_tensor(bit_llr).to(dev).reshape(-1, b)),
                      1e-4, 1 - 1e-4)
    pb0 = 1.0 - pb1
    d2 = torch.abs(x[:, None] - x_mu[:, None] * const_symb[None, :]) ** 2
    psi = (1.0 / (math.pi * var[:, None])) * torch.exp(-d2 / var[:, None]) * px[None, :]
    bm = bitmap_f[None, :, :]
    prob_prod = pb1[:, None, :] * bm + pb0[:, None, :] * (1.0 - bm)  # (N, M, b)
    extr_prior = torch.prod(prob_prod, dim=2)[:, :, None] / prob_prod
    weighted = psi[:, :, None] * extr_prior
    pe1 = torch.clamp(torch.sum(weighted * bm, dim=1), 1e-4, 1 - 1e-4)
    pe0 = torch.clamp(torch.sum(weighted * (1.0 - bm), dim=1), 1e-4, 1 - 1e-4)
    return torch.log(pe0 / pe1).reshape(-1)


_LOG2E = float(np.float32(np.log2(np.e)))


def calc_mi(rx, tx, noise_var, const_symb, px):
    """Mutual information for a circular AWGN channel (metrics.py:496):
    ``H(X) - H(X|Y)`` with ``p(y)`` by a max-shifted log-sum-exp over the
    constellation."""
    rx = as_device_tensor(rx).reshape(-1)
    dev = rx.device
    tx = torch.as_tensor(tx).to(dev).reshape(-1)
    const_symb = _const_tensor(const_symb, dev).reshape(-1)
    px = _px_tensor(px, const_symb.shape[0], dev)
    h_x = -torch.sum(px * torch.log2(px))
    ind = torch.argmin(torch.abs(tx[:, None] - const_symb[None, :]) ** 2, dim=1)
    neg_inv = -(1.0 / torch.as_tensor(noise_var, dtype=torch.float32, device=dev))
    log2_pygx = neg_inv * torch.abs(rx - tx) ** 2 * _LOG2E
    logw = neg_inv * torch.abs(rx[:, None] - const_symb[None, :]) ** 2
    mx = torch.max(logw, dim=1).values
    py = torch.exp(mx) * torch.sum(torch.exp(logw - mx[:, None]) * px[None, :], dim=1)
    h_xgy = -torch.mean(log2_pygx + torch.log2(px[ind]) - torch.log2(py))
    return h_x - h_xgy


def monte_carlo_mi(rx, tx, M, const_type, px=None):
    """Monte-Carlo MI per mode (metrics.py:429), after the phase-ambiguity
    correction and per-mode power normalization of :func:`fast_ber_calc`."""
    if px is None:
        px = np.ones(M) / M
    px = np.asarray(px).reshape(-1)
    const = gray_mapping(M, const_type)
    const = const / np.sqrt(np.sum(np.abs(const) ** 2 * px))
    rx = _as_columns(as_device_tensor(rx))
    tx = _as_columns(tx).to(rx.device)
    rx = _pnorm_cols(_phase_align(rx, tx, const_type))
    tx = _pnorm_cols(tx)
    noise_var = _noise_var(rx, tx)
    return torch.stack([calc_mi(rx[:, k], tx[:, k], noise_var[k], const, px)
                        for k in range(rx.shape[1])])


def calc_evm(symb, M, const_type, symb_tx=None):
    """Error vector magnitude per mode (metrics.py:572)."""
    symb = _as_columns(pnorm(as_device_tensor(symb)))
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


# ---------------------------------------------------------------------------
# Theory MI by 2-D quadrature, GN model and OSNR budget (host NumPy/SciPy,
# copies of the JAX package's host functions)
# ---------------------------------------------------------------------------


def _cond_entropy(y_i, y_q, const, p_x, ind, sigma):
    """Integrand: H(X|Y=y) contribution of symbol ``ind`` (metrics.py:689)."""
    d2 = (y_i - const.real) ** 2 + (y_q - const.imag) ** 2
    g = 1 / (2 * np.pi * sigma**2) * np.exp(-d2 / (2 * sigma**2))
    p_y = max(np.sum(g * p_x), 1e-50)
    exp_term = g[ind]
    int1 = exp_term * np.log2(max(exp_term, 1e-50))
    int2 = exp_term * np.log2(p_x[ind])
    int3 = exp_term * np.log2(p_y)
    return -(int1 + int2 - int3) * p_x[ind]


def theory_mi(M, const_type, snr_db, px=None, symmetry=True, lim=np.inf, tol=1e-3):
    """DCMC AWGN mutual information by 2-D quadrature (metrics.py:770);
    with ``symmetry``, one ``dblquad`` per ring of equal |s|."""
    const = gray_mapping(M, const_type)
    es = np.sum(np.mean(np.abs(const) ** 2))
    const = np.asarray(const / np.sqrt(es), dtype=np.complex128)
    sigma = np.sqrt(0.5 / float(db2lin(snr_db)))
    if px is None:
        px = np.ones(M) / M
    mi = -np.sum(px * np.log2(px))
    if symmetry:
        groups = {}
        for i, s in enumerate(const):
            groups.setdefault(round(abs(s) / 1e-12), []).append(i)
        items = [(idxs[0], len(idxs)) for idxs in groups.values()]
    else:
        items = [(i, 1) for i in range(M)]
    for rep, count in items:
        val, _ = dblquad(_cond_entropy, -lim, lim, -lim, lim,
                         args=(const, px, rep, sigma), epsabs=tol)
        mi -= val * count
    return mi


def gn_model_nyquist_wdm(rs, n_ch, df, alpha_db, gamma_, l_span, n_spans,
                         ptx_dbm, disp, b_ref, fc):
    """GN-model NLIN variance for Nyquist-WDM (metrics.py:851, Poggiolini
    2012), with the reference's trailing factor of two and its Nch
    exponents, as the JAX package keeps them."""
    lam = sconst.c / fc * 1e-3  # km
    c_kms = sconst.c / 1.5 * 1e-3
    alpha = alpha_db / (10 * np.log10(np.exp(1)))
    leff = (1 - np.exp(-2 * alpha * l_span)) / (2 * alpha)
    leffa = 1 / (2 * alpha)
    ptx = 10 ** (ptx_dbm / 10) * 1e-3
    beta2 = -disp * lam**2 / (2 * np.pi * c_kms)
    var_nli = ((8 / 27) * gamma_**2 * leff**2 * (ptx / rs) ** 3
               * np.arcsinh(np.pi**2 / 2 * np.abs(beta2) * leffa * n_ch ** (2 * rs / df)
                            * rs**2)
               / (np.pi * np.abs(beta2) * leffa) * b_ref)
    epsilon = (3 / 10) * np.log(
        1 + 6 / l_span * leffa
        / np.arcsinh((np.pi**2 / 2) * np.abs(beta2) * leffa * (n_ch**2) ** (2 * rs / df)
                     * rs**2))
    return 2 * (n_spans ** (1 + epsilon)) * var_nli


def ase_nyquist_wdm(alpha_db, l_span, n_spans, nf_db, b_ref, fc):
    """Accumulated ASE power over n_spans EDFAs (metrics.py:901)."""
    g_lin = 10 ** (alpha_db * l_span / 10)
    nf_lin = 10 ** (nf_db / 10)
    nsp = (g_lin * nf_lin - 1) / (2 * (g_lin - 1))
    n_ase = n_spans * (g_lin - 1) * nsp * sconst.h * fc
    return 2 * n_ase * b_ref


def gn_model_osnr(rs, n_ch, df, ptx_dbm_list, ltotal=800, l_span=50,
                  alpha_db=0.2, disp=16, gamma_=1.3, fc=193.1e12, nf_db=4.5,
                  b_ref=12.5e9):
    """OSNR prediction from the GN model (metrics.py:917): (osnr, p_nli,
    p_ase) per launch power."""
    n_spans = int(ltotal // l_span)
    ptx_dbm_list = np.atleast_1d(ptx_dbm_list)
    p_nli = np.array([gn_model_nyquist_wdm(rs, n_ch, df, alpha_db, gamma_, l_span, n_spans,
                                           p, disp, b_ref, fc) for p in ptx_dbm_list])
    p_ase = np.full_like(p_nli, ase_nyquist_wdm(alpha_db, l_span, n_spans, nf_db, b_ref, fc))
    osnr = 10 ** (ptx_dbm_list / 10) * 1e-3 / (p_nli + p_ase)
    return osnr, p_nli, p_ase


def calc_lin_osnr(n_spans, p_in, alpha_db, l_span, osnr_in, nf_db=4.5,
                  fc=193.1e12, b_ref=12.5e9):
    """OSNR evolution across a chain of spans and EDFAs (metrics.py:942)."""
    g_db = alpha_db * l_span
    nf_lin = 10 ** (nf_db / 10)
    g_lin = 10 ** (g_db / 10)
    nsp = (g_lin * nf_lin - 1) / (2 * (g_lin - 1))
    n_ase = (g_lin - 1) * nsp * sconst.h * fc
    p_ase_dbm = 10 * np.log10((2 * n_ase * b_ref) / 1e-3)
    pn_in = (p_in - osnr_in) - alpha_db * l_span
    osnr = np.zeros(n_spans + 1)
    osnr[0] = osnr_in
    for span in range(1, n_spans + 1):
        pn_out = 10 * np.log10(10 ** ((pn_in + g_db) / 10) + 10 ** (p_ase_dbm / 10))
        osnr[span] = p_in - pn_out
        pn_in = pn_out - alpha_db * l_span
    return osnr
