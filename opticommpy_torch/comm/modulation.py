"""Digital modulation: constellations, Gray mapping, (de)mapping, symbol
detection and soft mapping.

Port of ``opticommpy_tpu/comm/modulation.py``. Constellation generation is
the same host NumPy code; the per-symbol operations run on tensors: the
detector as one broadcast distance tensor, the soft estimator as matmuls
against the bit map, the MLSE (:func:`mlse`) as a Viterbi recursion over
the symbols with all trellis states at once.
"""

import numpy as np
import torch

from opticommpy_torch.ops.signal import pnorm
from opticommpy_torch.utils.rng import as_device_tensor
from opticommpy_torch.utils.units import llr2bit_prob

__all__ = [
    "gray_code",
    "gray_mapping",
    "norm_const",
    "pam_const",
    "qam_const",
    "psk_const",
    "apsk_const",
    "bit_map",
    "min_euclid",
    "demap",
    "modulate_gray",
    "demodulate_gray",
    "detector",
    "soft_estimator",
    "soft_mapper",
    "mlse",
]


# ---------------------------------------------------------------------------
# Constellation generation (host-side NumPy, offline)
# ---------------------------------------------------------------------------


def gray_code(n):
    """n-bit Gray code as integer array: g(i) = i ^ (i >> 1)."""
    i = np.arange(1 << n)
    return i ^ (i >> 1)


def pam_const(M):
    """M-PAM levels {-(M-1), ..., -1, 1, ..., M-1} (modulation.py:121)."""
    L = M - 1
    return np.arange(-L, L + 1, 2).astype(np.float32)


def qam_const(M):
    """Square M-QAM grid with serpentine row ordering (modulation.py:143)."""
    L = int(np.sqrt(M)) - 1
    pam = np.arange(-L, L + 1, 2)
    grid = np.tile(pam, (L + 1, 1))
    const = grid + 1j * np.flipud(grid.T)
    for row in range(1, L + 1, 2):
        const[row] = const[row][::-1]
    return const.astype(np.complex64)


def psk_const(M):
    """M-PSK points on the unit circle (modulation.py:177)."""
    phases = 2 * np.pi * np.arange(M) / M
    return np.exp(1j * phases).astype(np.complex64)


def apsk_const(M, m1=None, phase_offset=None):
    """M-APSK multi-ring constellation (modulation.py:200).

    ``m1`` bits index the rings; ring radii follow the Gaussian-quantile rule
    of Liu et al. (2011); alternate rings are phase-flipped for Gray-ness.
    """
    if m1 is None:
        m1 = {16: 1, 32: 2, 64: 2, 128: 3, 256: 3, 512: 4, 1024: 4}[M]
    n_rings = 1 << m1
    m2 = int(np.log2(M)) - m1
    per_ring = 1 << m2
    if phase_offset is None:
        phase_offset = np.pi / per_ring
    const = np.zeros(M, dtype=np.complex64)
    for r in range(n_rings):
        radius = np.sqrt(-np.log(1 - ((r + 1) - 0.5) * per_ring / M))
        ring = psk_const(per_ring)
        if (r + 1) % 2 == 1:
            ring = np.flip(ring)
        const[r * per_ring : (r + 1) * per_ring] = radius * ring
    return (const * np.exp(1j * phase_offset)).astype(np.complex64)


def gray_mapping(M, const_type):
    """Constellation ordered by Gray-mapped bit label (modulation.py:64).

    Index ``i`` of the returned array is the symbol whose Gray bit label, read
    as an integer, equals ``i``.
    """
    if const_type == "ook":
        M = 2
    bits_per_symbol = int(np.log2(M))
    code = gray_code(bits_per_symbol)
    if const_type == "ook":
        const = np.arange(2).astype(np.float32)
    elif const_type == "pam":
        const = pam_const(M)
    elif const_type == "qam":
        const = qam_const(M)
    elif const_type == "psk":
        const = psk_const(M)
    elif const_type == "apsk":
        const = apsk_const(M)
    else:
        raise ValueError(f"unknown constellation type: {const_type}")
    const = const.reshape(-1)
    # position symbols so that const_out[gray_label] = const[natural_index]
    order = np.argsort(code)
    return const[order]


def norm_const(M, const_type):
    """Gray-mapped constellation at unit average energy, complex64."""
    c = gray_mapping(M, const_type)
    return (c / np.sqrt(np.mean(np.abs(c) ** 2))).astype(np.complex64)


def bit_map(M, const_type):
    """(M, log2(M)) bit labels of :func:`gray_mapping` order (MSB first).

    Row ``i`` of the map is just the binary expansion of ``i`` — by
    construction of gray_mapping, index == bit label (this is what the
    reference computes via minEuclid(const, const) + dec2bitarray in
    demodulateGray, modulation.py:399-403).
    """
    b = int(np.log2(M)) if const_type != "ook" else 1
    idx = np.arange(1 << b)
    shifts = np.arange(b - 1, -1, -1)
    return ((idx[:, None] >> shifts[None, :]) & 1).astype(np.int32)


# ---------------------------------------------------------------------------
# Per-symbol operations
# ---------------------------------------------------------------------------


def min_euclid(symb, const):
    """Index of the closest constellation point per symbol (modulation.py:271)."""
    symb = as_device_tensor(symb)
    const = torch.as_tensor(const, device=symb.device)
    d2 = torch.abs(symb[..., None] - const) ** 2
    return torch.argmin(d2, dim=-1)


def demap(ind_symb, bitmap):
    """Symbol indices -> interleaved bit sequence (modulation.py:302)."""
    ind_symb = as_device_tensor(ind_symb)
    bits = torch.as_tensor(bitmap, device=ind_symb.device)[ind_symb]
    return bits.reshape(-1)


def modulate_gray(bits, M, const_type):
    """Bits -> Gray-mapped constellation symbols (modulation.py:334)."""
    if const_type == "ook":
        M = 2
    b = int(np.log2(M))
    bits = as_device_tensor(bits)
    const = torch.as_tensor(gray_mapping(M, const_type), device=bits.device)
    weights = torch.as_tensor(1 << np.arange(b - 1, -1, -1), device=bits.device)
    idx = torch.sum(bits.reshape(-1, b).long() * weights, dim=1)
    return const[idx]


def demodulate_gray(symb, M, const_type):
    """Hard demodulation: minimum-distance + Gray demapping (modulation.py:369)."""
    if const_type == "ook":
        M = 2
    symb = as_device_tensor(symb)
    const = torch.as_tensor(gray_mapping(M, const_type), device=symb.device)
    return demap(min_euclid(symb, const), bit_map(M, const_type))


def detector(r, noise_var, const_symb, px=None, rule="MAP"):
    """MAP/ML symbol detection (modulation.py:411), one broadcast distance
    tensor over the constellation. Returns (decided symbols, indices)."""
    r = as_device_tensor(r)
    const_symb = torch.as_tensor(const_symb).to(r.device)
    M = const_symb.shape[0]
    if px is None or rule == "ML":
        px = torch.ones(M, device=r.device) / M
    px = torch.as_tensor(px).to(device=r.device, dtype=torch.float32)
    d2 = torch.abs(r[..., None] - const_symb) ** 2
    if rule == "MAP":
        ind = torch.argmax(-d2 / noise_var + torch.log(px), dim=-1)
    elif rule == "ML":
        ind = torch.argmin(d2, dim=-1)
    else:
        raise ValueError("Detection rule should be either MAP or ML")
    return const_symb[ind], ind


def _real_matmul(a, b):
    """``a @ b`` for real ``a`` and real or complex ``b`` (the real and
    imaginary parts as two real products)."""
    if b.is_complex():
        return torch.complex(a @ b.real, a @ b.imag)
    return a @ b


def soft_estimator(llr, bitmap, const_symb):
    """Soft symbol mean and variance from bit LLRs (modulation.py:522).

    The symbol probabilities come from two matmuls in the log domain,
    ``log P(m) = log(Pb1) @ B^T + log(Pb0) @ (1 - B)^T``, with the JAX
    package's clips (LLRs to +-300, bit probabilities to [1e-30, 1]). The
    constellation takes the LLRs' precision, as a float64 NumPy
    constellation takes float32 in the JAX package.
    """
    llr = torch.clamp(as_device_tensor(llr), -300.0, 300.0)
    dev = llr.device
    bitmap = torch.as_tensor(np.asarray(bitmap), device=dev).to(torch.float32)
    const_symb = torch.as_tensor(const_symb).to(dev)
    const_symb = const_symb.to(llr.dtype.to_complex() if const_symb.is_complex() else llr.dtype)
    pb1 = torch.clamp(llr2bit_prob(llr), 1e-30, 1.0)
    pb0 = torch.clamp(1.0 - pb1, 1e-30, 1.0)
    log_p = torch.log(pb1) @ bitmap.T + torch.log(pb0) @ (1.0 - bitmap.T)
    prob = torch.exp(log_p)
    soft_mean = _real_matmul(prob, const_symb)
    soft_var = prob @ (torch.abs(const_symb) ** 2) - torch.abs(soft_mean) ** 2
    return soft_mean, soft_var


def soft_mapper(llr, M, const_type):
    """Interleaved bit LLRs to soft symbol estimates (modulation.py:484)."""
    b = int(np.log2(M))
    llr = as_device_tensor(llr)
    const = pnorm(torch.as_tensor(gray_mapping(M, const_type), device=llr.device))
    return soft_estimator(llr.reshape(-1, b), bit_map(M, const_type), const)


# ---------------------------------------------------------------------------
# MLSE (Viterbi): one step per symbol, all states at once
# ---------------------------------------------------------------------------


_MLSE_CHUNK = 4096  # steps whose branch metrics are computed at once


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def mlse(y, h, const_symb):
    """Maximum-likelihood sequence estimation via Viterbi (modulation.py:581;
    port of the JAX ``mlse``).

    Trellis states are the channel memory contents (M**L states, L =
    len(h) - 1, the most recent symbol the least significant base-M
    digit). ``y_expected`` (the channel output per state and input
    symbol), the predecessors ``pred`` and the emitted symbols ``emit`` are
    built on the host, as in the JAX package. The forward recursion runs
    on the device of ``y`` (a tensor keeps its device, any other input goes
    to the CUDA device), one step per symbol over all states: float32 path
    metrics that start at zero and are never renormalized, and the
    survivor of each state the first of its M candidates with the least
    metric (``torch.min`` over a state's candidates takes the first index
    on a tie, as ``jnp.argmin`` does). The branch metrics are computed for
    4,096 steps at a time, so a step is four ops. The traceback copies the
    (N, S) survivor choices to the host once and walks them back there.
    With L = 0 the decision is the nearest point to ``y / h[0]``.

    Returns the detected symbols (N,), float32 for a real constellation,
    else complex64.
    """
    y = as_device_tensor(y)
    const_symb = _host(const_symb)
    h = _host(h)
    dev = y.device
    M = len(const_symb)
    L = len(h) - 1
    const_t = torch.as_tensor(const_symb.astype(
        np.complex64 if np.iscomplexobj(const_symb) else np.float32), device=dev)
    if L == 0:
        h0 = complex(h[0]) if np.iscomplexobj(h) else float(h[0])
        return const_t[min_euclid(y / h0, const_t)]

    n_states = M**L
    s = np.arange(n_states)
    digits = np.stack([(s // (M**i)) % M for i in range(L)], axis=1)  # (S, L)
    y_expected = np.outer(np.ones(n_states), h[0] * const_symb).astype(complex)
    for i in range(1, L + 1):
        y_expected += h[i] * const_symb[digits[:, i - 1]][:, None]
    y_exp = torch.as_tensor(y_expected.astype(np.complex64), device=dev)  # (S, M)
    pred = s[:, None] // M + np.arange(M)[None, :] * (M ** (L - 1))  # (S, M)
    emit = s % M  # symbol emitted entering state s
    pred_t = torch.as_tensor(pred, device=dev)
    flat_t = torch.as_tensor(pred * M + emit[:, None], device=dev)  # bm[pred, emit]

    y = y.to(torch.complex64).reshape(-1)
    n = y.shape[0]
    pm = torch.zeros(n_states, dtype=torch.float32, device=dev)
    best = torch.empty((n, n_states), dtype=torch.int64, device=dev)
    for start in range(0, n, _MLSE_CHUNK):
        # branch metrics of a chunk of steps at once, (steps, S, M), each
        # candidate's bm[pred[s, j], emit[s]] gathered in one op
        bm = torch.abs(y[start:start + _MLSE_CHUNK, None, None] - y_exp) ** 2
        bm = bm.reshape(bm.shape[0], -1)[:, flat_t]
        for k in range(bm.shape[0]):
            pm, best[start + k] = torch.min(pm[pred_t] + bm[k], dim=1)

    j_best = best.cpu().numpy()
    state = int(torch.argmin(pm))
    states = np.empty(n, np.int64)
    for k in range(n - 1, -1, -1):
        states[k] = state
        state = pred[state, j_best[k, state]]
    return const_t[torch.as_tensor(emit[states], device=dev)]
