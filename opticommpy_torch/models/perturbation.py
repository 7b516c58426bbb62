"""First-order intrachannel nonlinear perturbation model (NLIN) (port of
``opticommpy_tpu/models/perturbation.py``).

- :func:`calc_pert_coeff_matrix` ~ perturbation.py:29 — coefficient
  matrices (IFWM/IXPM/ISPM, optional power-weighted multi-span form), host
  SciPy as in the JAX package; NumPy arrays out.
- :func:`calc_nlin_perturbation` ~ perturbation.py:200 — ``method='fft'``
  factors the (2L+1)^2 window double sum into per-lag products and one
  batched FFT correlation; ``method='chunk'`` keeps the direct
  (chunk, 2L+1, 2L+1) triple-product contraction as the oracle.
- :func:`calc_nlin_perturbation_simplified` ~ perturbation.py:342 — the
  coefficient-pruned ('AMR') contraction.
- :func:`perturbation_nlin` ~ perturbation.py:505 — additive +
  multiplicative NLIN assembly.

Every contraction is an explicit complex product and sum in float32
(never a matmul, so never TF32). Sliding windows are ``Tensor.unfold``
views. Index conventions match the reference: with m the column offset and
n the row offset, ``dx[t] = sum_{m,n} C_ifwm[n,m] (x[t+n]x*[t+n+m] +
y[t+n]y*[t+n+m]) x[t+m] + x[t] sum_n C_ixpm(m=0,n) |y[t+n]|^2``.

One deliberate fix vs the reference, kept from the JAX package: the ISPM
phase term uses the *center* symbol power |x[t]|^2 + |y[t]|^2 (the
reference indexes the window corner x[t-L], perturbation.py:329).
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
from scipy.integrate import quad
from scipy.special import comb, exp1, gammaincc

from opticommpy_torch.comm.modulation import _host
from opticommpy_torch.ops.signal import pnorm
from opticommpy_torch.utils.rng import as_device_tensor
from opticommpy_torch.utils.units import dbm2w

__all__ = [
    "PerturbationConfig",
    "calc_pert_coeff_matrix",
    "calc_nlin_perturbation",
    "calc_nlin_perturbation_simplified",
    "perturbation_nlin",
]


@dataclass(frozen=True)
class PerturbationConfig:
    """NLIN perturbation-model parameters (reference perturbation.py:65-79)."""

    D: float = 17.0  # [ps/nm/km]
    alpha: float = 0.2  # [dB/km]
    lspan: float = 50.0  # [km]
    length: float = 800.0  # [km]
    pulseWidth: float = 0.5  # fraction of symbol period
    gamma: float = 1.3  # [1/W/km]
    Fc: float = 193.2e12
    powerWeighted: bool = False
    Rs: float = 32e9
    powerWeightN: int = 10
    matrixOrder: int = 25
    mode: str = "AM"  # 'AM' | 'AMR' (coefficient-pruned)
    Pin: float = 0.0  # [dBm]
    coeffTol: float = -20.0  # [dB], AMR pruning threshold


def calc_pert_coeff_matrix(config: PerturbationConfig):
    """Perturbation coefficient matrices (reference perturbation.py:29).

    Returns NumPy (C, C_ifwm, C_ixpm, C_ispm), complex64, with the
    (2L+1, 2L+1) layout C[i, j] = C(m = j - L, n = L - i).
    """
    cfg = config
    c_kms = 299792458.0 / 1e3
    ts = 1 / cfg.Rs
    tau = cfg.pulseWidth * ts
    lam = c_kms / cfg.Fc
    alpha = cfg.alpha / (10 * np.log10(np.e))
    beta2 = -cfg.D * lam**2 / (2 * np.pi * c_kms)
    leff = (1 - np.exp(-alpha * cfg.lspan)) / alpha
    n_spans = int(cfg.length / cfg.lspan)
    L = cfg.matrixOrder

    m_vals = np.arange(-L, L + 1)
    M, N = np.meshgrid(m_vals, m_vals[::-1])  # M[i,j]=m, N[i,j]=n

    # ISPM: numerical integral of 1/sqrt(tau^4/(3 b2^2) + z^2)
    c_int = tau**4 / (3 * beta2**2)
    c_ispm, _ = quad(lambda z: 1.0 / np.sqrt(c_int + z**2), 0, cfg.length)

    if cfg.powerWeighted:
        a_coef = M * N * ts**2 / beta2
        norder = cfg.powerWeightN
        sum1 = np.zeros_like(M, dtype=complex)
        with np.errstate(divide="ignore", invalid="ignore"):
            for span in range(1, n_spans + 1):
                b_coef = -norder / (alpha * a_coef) + ((span - 1) * cfg.lspan) / a_coef
                sum2 = np.zeros_like(M, dtype=complex)
                for kk in range(1, norder + 1):
                    if span != 1:
                        g_prev = gammaincc(
                            1 - kk, 1j * (1 / b_coef - a_coef / ((span - 1) * cfg.lspan))
                        )
                    else:
                        g_prev = np.zeros_like(M, dtype=complex)
                    g_next = gammaincc(
                        1 - kk, 1j * (1 / b_coef - a_coef / (span * cfg.lspan))
                    )
                    sum2 = sum2 + (
                        (-1) ** (kk + norder)
                        * comb(norder - 1, kk - 1)
                        * (1j / b_coef) ** kk
                        * (g_prev - g_next)
                    )
                sum1 = sum1 + (np.exp(1j / b_coef) / b_coef ** (norder - 1)) * sum2
            c_ifwm = (norder / alpha) ** norder * (a_coef ** -norder) * sum1
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            c_ifwm = exp1(-1j * M * N * ts**2 / (beta2 * cfg.length))

    with np.errstate(divide="ignore", invalid="ignore"):
        c_ixpm = 0.5 * exp1(
            (N - M) ** 2 * ts**2 * tau**2 / (3 * np.abs(beta2) ** 2 * cfg.length**2)
        )

    # singular entries (m*n = 0 for IFWM, m = n for IXPM diagonal at 0)
    bad = ~np.isfinite(np.abs(c_ifwm))
    ifwm_mask = bad.astype(float)
    c_ifwm = np.where(bad, 0, c_ifwm)
    c_ixpm = np.where(~np.isfinite(np.abs(c_ixpm)), 0, c_ixpm)
    c_ixpm = ifwm_mask * c_ixpm  # IXPM defined only where IFWM was singular

    scale = 1j * (8 / 9) * cfg.gamma * tau**2 / (np.sqrt(3) * np.abs(beta2)) * leff / cfg.lspan
    if cfg.powerWeighted:
        c_ifwm = -(8 / 9) * cfg.gamma * tau**2 / (np.sqrt(3) * beta2) * c_ifwm
    else:
        c_ifwm = scale * c_ifwm
    c_ixpm = scale * c_ixpm
    c_ispm = scale * c_ispm

    C = c_ifwm + c_ixpm
    return (
        C.astype(np.complex64),
        c_ifwm.astype(np.complex64),
        c_ixpm.astype(np.complex64),
        np.complex64(c_ispm),
    )


def _coeffs(c_ifwm, c_ixpm, c_ispm, device):
    """(cf, cx1, cx2, c_ispm) complex64 on ``device``: the IFWM matrix, the
    IXPM row at n = 0 (indexed by m) and column at m = 0 (indexed by n)."""
    c_ixpm = _host(c_ixpm)
    L = (c_ixpm.shape[0] - 1) // 2

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.complex64), device=device)

    return (dev(_host(c_ifwm)), dev(c_ixpm[L, :]), dev(c_ixpm[:, L]), dev(_host(c_ispm)))


def _xpm_terms(x_c, y_c, ax_n, ay_n, ax_m, ay_m, cx1, cx2, c_ispm):
    """The IXPM additive term at m = 0 and the IXPM phase at n = 0 plus the
    centre-symbol ISPM: (dx_add, dy_add, phi_x, phi_y). ``a*_n`` and
    ``a*_m`` are the |.|^2 windows (T, 2L+1) at the n and m positions."""
    dx = x_c * torch.sum(ay_n * cx2, dim=1)
    dy = y_c * torch.sum(ax_n * cx2, dim=1)
    p_c = torch.abs(x_c) ** 2 + torch.abs(y_c) ** 2
    phi_x = torch.imag(torch.sum((2 * ax_m + ay_m) * cx1, dim=1) + p_c * c_ispm)
    phi_y = torch.imag(torch.sum((2 * ay_m + ax_m) * cx1, dim=1) + p_c * c_ispm)
    return dx, dy, phi_x, phi_y


def _windows(x, y, chunk, L):
    """Zero-padded symbols and their (n_pad, 4L+1) sliding windows
    ``xw[t, k] = x[t + k - 2L]`` (``Tensor.unfold`` views), complex64."""
    n_sym = x.shape[0]
    d = 2 * L
    n_pad = int(np.ceil(n_sym / chunk)) * chunk
    pad = (d, d + (n_pad - n_sym))
    xp = torch.nn.functional.pad(x.to(torch.complex64), pad)
    yp = torch.nn.functional.pad(y.to(torch.complex64), pad)
    return xp.unfold(0, 2 * d + 1, 1), yp.unfold(0, 2 * d + 1, 1), n_pad


def _nlin_chunks(x, y, cf, cx1, cx2, c_ispm, chunk):
    """Chunked window contraction for the additive + phase NLIN terms
    (JAX ``_nlin_kernel``); one block of ``chunk`` symbols at a time."""
    n_sym = x.shape[0]
    ind_l = cf.shape[0]
    L = (ind_l - 1) // 2
    xw, yw, n_pad = _windows(x, y, chunk, L)
    dev = x.device
    # window positions: pos_m[j] = L+j, pos_n[i] = 3L-i, pos_mn[i, j] = 2L+j-i
    k = torch.arange(ind_l, device=dev)
    pm, pn, pmn = k + L, 3 * L - k, 2 * L + k[None, :] - k[:, None]
    outs = []
    for tb in range(0, n_pad, chunk):
        xb, yb = xw[tb:tb + chunk], yw[tb:tb + chunk]
        xm, ym, xn, yn = xb[:, pm], yb[:, pm], xb[:, pn], yb[:, pn]
        t1 = xn[:, :, None] * torch.conj(xb[:, pmn]) + yn[:, :, None] * torch.conj(yb[:, pmn])
        s = torch.sum(cf * t1, dim=1)  # contract over n (rows): (chunk, indL)
        dx, dy, phi_x, phi_y = _xpm_terms(
            xb[:, 2 * L], yb[:, 2 * L], torch.abs(xn) ** 2, torch.abs(yn) ** 2,
            torch.abs(xm) ** 2, torch.abs(ym) ** 2, cx1, cx2, c_ispm)
        outs.append((torch.sum(s * xm, dim=1) + dx, torch.sum(s * ym, dim=1) + dy,
                     phi_x, phi_y))
    return tuple(torch.cat(parts)[:n_sym] for parts in zip(*outs))


def _nlin_fft(x, y, cf, cx1, cx2, c_ispm):
    """FFT formulation of the NLIN contraction — O(L N log N).

    With lag products ``u_m[t] = x[t] x*[t+m] + y[t] y*[t+m]`` the IFWM
    double sum is ``dx[t] = sum_m (sum_n C(m, n) u_m[t+n]) x[t+m]``: 2L+1
    FIR correlations of length 2L+1 over the lag-product signals, one
    batched zero-padded FFT convolution.
    """
    n_sym = x.shape[0]
    ind_l = cf.shape[0]
    L = (ind_l - 1) // 2
    xp = torch.nn.functional.pad(x, (L, L))
    yp = torch.nn.functional.pad(y, (L, L))
    # shifted copies xs[j, t] = x[t + j - L]
    xs = xp.unfold(0, n_sym, 1)
    ys = yp.unfold(0, n_sym, 1)
    u = x[None, :] * torch.conj(xs) + y[None, :] * torch.conj(ys)  # (indL, N)
    n_fft = int(2 ** np.ceil(np.log2(n_sym + 2 * ind_l)))
    # conv kernel h_j[i] = cf[i, j]; g_j[t] = conv(u_j, h_j)[t + L]
    uf = torch.fft.fft(u, n=n_fft, dim=1)
    hf = torch.fft.fft(cf.T.contiguous(), n=n_fft, dim=1)
    g = torch.fft.ifft(uf * hf, dim=1)[:, L:L + n_sym]
    dx = torch.sum(g * xs, dim=0)
    dy = torch.sum(g * ys, dim=0)
    # the shifted stacks hold a[t + j - L] in row j: the IXPM m = 0 weight
    # of row j is cx2[2L - j], and the n = 0 phase weight cx1[j]
    ax = torch.abs(xs) ** 2
    ay = torch.abs(ys) ** 2
    w2 = torch.flip(cx2, (0,))[:, None]
    dx = dx + x * torch.sum(w2 * ay, dim=0)
    dy = dy + y * torch.sum(w2 * ax, dim=0)
    p_c = torch.abs(x) ** 2 + torch.abs(y) ** 2
    phi_x = torch.imag(torch.sum(cx1[:, None] * (2 * ax + ay), dim=0) + p_c * c_ispm)
    phi_y = torch.imag(torch.sum(cx1[:, None] * (2 * ay + ax), dim=0) + p_c * c_ispm)
    return dx, dy, phi_x, phi_y


def calc_nlin_perturbation(c_ifwm, c_ixpm, c_ispm, x, y, chunk=512,
                           method="fft"):
    """Additive/multiplicative NLIN waveforms (reference perturbation.py:200).

    ``method``: 'fft' (default — lag-product + batched FFT correlation form,
    O(L N log N)) or 'chunk' (the windowed triple-product tensor the
    reference's prange kernel maps to, O(L^2 N); kept as the oracle).
    ``x`` is the main input: a tensor keeps its device, anything else goes
    to the CUDA device; ``y`` and the coefficients follow it. Returns
    (dx, dy, phi_ixpm_x, phi_ixpm_y), each of length len(x).
    """
    x = pnorm(as_device_tensor(x))
    y = pnorm(torch.as_tensor(y).to(x.device))
    cf, cx1, cx2, c_ispm = _coeffs(c_ifwm, c_ixpm, c_ispm, x.device)
    x = x.to(torch.complex64)
    y = y.to(torch.complex64)
    if method == "fft":
        return _nlin_fft(x, y, cf, cx1, cx2, c_ispm)
    return _nlin_chunks(x, y, cf, cx1, cx2, c_ispm, chunk)


def calc_nlin_perturbation_simplified(c_ifwm, c_ixpm, c_ispm, x, y,
                                      coeff_tol=-20.0, chunk=512):
    """Pruned NLIN computation (reference perturbation.py:342).

    Drops IFWM coefficients more than |coeff_tol| dB below the largest one
    (the pairs are chosen on the host). ``x`` is the main input, as in
    :func:`calc_nlin_perturbation`. Returns (dx, dy, phi_x, phi_y, n_kept,
    reduction_percent).
    """
    x = pnorm(as_device_tensor(x))
    y = pnorm(torch.as_tensor(y).to(x.device))
    dev = x.device
    n_sym = x.shape[0]
    _, cx1, cx2, c_ispm_t = _coeffs(c_ifwm, c_ixpm, c_ispm, dev)
    c_ifwm = _host(c_ifwm)
    c_ixpm = _host(c_ixpm)
    L = (c_ifwm.shape[0] - 1) // 2

    C = c_ifwm + c_ixpm
    C[L, L] = _host(c_ispm)
    abs_c = np.abs(C)
    keep = 20 * np.log10(np.maximum(abs_c, 1e-300) / abs_c.max()) > coeff_tol
    i_sel, j_sel = np.nonzero(keep)
    n_kept = int(i_sel.size)
    reduction = round(100 * (1 - n_kept / C.size), 2)
    cf_sel = torch.as_tensor(c_ifwm[i_sel, j_sel], device=dev)
    pos_n = torch.as_tensor(3 * L - i_sel, device=dev)
    pos_m = torch.as_tensor(L + j_sel, device=dev)
    pos_mn = torch.as_tensor(2 * L + j_sel - i_sel, device=dev)
    ind_l = 2 * L + 1
    pm = torch.arange(ind_l, device=dev) + L
    pn = 3 * L - torch.arange(ind_l, device=dev)

    xw, yw, n_pad = _windows(x, y, chunk, L)
    outs = []
    for tb in range(0, n_pad, chunk):
        xb, yb = xw[tb:tb + chunk], yw[tb:tb + chunk]
        xm_s, ym_s = xb[:, pos_m], yb[:, pos_m]
        t1 = xb[:, pos_n] * torch.conj(xb[:, pos_mn]) + yb[:, pos_n] * torch.conj(yb[:, pos_mn])
        dx, dy, phi_x, phi_y = _xpm_terms(
            xb[:, 2 * L], yb[:, 2 * L], torch.abs(xb[:, pn]) ** 2, torch.abs(yb[:, pn]) ** 2,
            torch.abs(xb[:, pm]) ** 2, torch.abs(yb[:, pm]) ** 2, cx1, cx2, c_ispm_t)
        outs.append((torch.sum(t1 * xm_s * cf_sel, dim=1) + dx,
                     torch.sum(t1 * ym_s * cf_sel, dim=1) + dy, phi_x, phi_y))
    dx, dy, phi_x, phi_y = (torch.cat(parts)[:n_sym] for parts in zip(*outs))
    return dx, dy, phi_x, phi_y, n_kept, reduction


def perturbation_nlin(e_in, config: PerturbationConfig = PerturbationConfig()):
    """Intrachannel NLIN via the first-order perturbation model.

    Parity with reference perturbationNLIN (perturbation.py:505): normalizes
    each polarization, computes the additive (dx, dy) and multiplicative
    (phi) terms, and assembles
    ``nlin = sqrt(P) E (exp(j phi) - 1) + delta exp(j phi)`` with
    ``delta = P^{3/2} d`` and peak power P = launch/2. ``e_in`` (N, 2): a
    tensor keeps its device, anything else goes to the CUDA device.
    """
    cfg = config
    e_in = as_device_tensor(e_in)
    x = pnorm(e_in[:, 0])
    y = pnorm(e_in[:, 1])

    _, c_ifwm, c_ixpm, c_ispm = calc_pert_coeff_matrix(cfg)
    if cfg.mode == "AMR":
        dx, dy, phi_x, phi_y, _, _ = calc_nlin_perturbation_simplified(
            c_ifwm, c_ixpm, c_ispm, x, y, cfg.coeffTol
        )
    else:
        dx, dy, phi_x, phi_y = calc_nlin_perturbation(c_ifwm, c_ixpm, c_ispm, x, y)

    p_peak = 0.5 * float(dbm2w(cfg.Pin))
    delta_x = p_peak**1.5 * dx
    delta_y = p_peak**1.5 * dy
    phi_x = p_peak * phi_x
    phi_y = p_peak * phi_y
    rot_x = torch.exp(1j * phi_x)
    rot_y = torch.exp(1j * phi_y)
    nlin_x = math.sqrt(p_peak) * x * (rot_x - 1) + delta_x * rot_x
    nlin_y = math.sqrt(p_peak) * y * (rot_y - 1) + delta_y * rot_y
    return torch.stack([nlin_x, nlin_y], dim=1)
