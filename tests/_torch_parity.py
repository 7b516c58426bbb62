"""Shared helpers for the tests that hold opticommpy_torch to opticommpy_tpu.

Inputs are made from a seed with NumPy. The JAX package takes them as NumPy
arrays; the port takes them as CPU tensors (:func:`cpu`), because the port's
entry points send a NumPy input to the CUDA device and only a CPU tensor asks
for the CPU. torch cannot reproduce ``jax.random`` streams, so noise is either
drawn on the JAX side and passed to both, or switched off.
"""

import numpy as np
import torch


def cpu(*arrays):
    """CPU tensors of NumPy arrays (or lists, scalars, JAX arrays): one tensor
    for one argument, else a tuple. Each is a view of a C-ordered copy, so
    a read-only or strided array is accepted."""
    out = tuple(torch.from_numpy(np.ascontiguousarray(np.array(a))) for a in arrays)
    return out[0] if len(out) == 1 else out


def to_np(x):
    """NumPy copy of a torch tensor or a JAX/NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(a, b):
    """||a - b|| / ||b|| over all elements."""
    a, b = to_np(a).astype(np.complex128), to_np(b).astype(np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def norm_qam(M=16):
    """Gray-mapped square QAM at unit average energy, complex64."""
    from opticommpy_torch.comm.modulation import gray_mapping

    c = gray_mapping(M, "qam")
    return (c / np.sqrt(np.mean(np.abs(c) ** 2))).astype(np.complex64)


def mixed_polmux(seed, n_sym, sps=2, M=16, noise=0.01):
    """(signal (n_sym*sps, 2), symbols (n_sym, 2)) complex64: QAM symbols at
    sps samples/symbol through a fixed 2x2 mixing matrix plus noise."""
    rng = np.random.default_rng(seed)
    const = norm_qam(M)
    sym = const[rng.integers(0, M, size=(n_sym, 2))]
    x = np.zeros((n_sym * sps, 2), complex)
    x[::sps] = sym
    h = np.array([[0.9, 0.15 + 0.05j], [-0.1 + 0.08j, 0.95]])
    sig = x @ h.T + noise * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    return sig.astype(np.complex64), sym.astype(np.complex64)


def noisy_symbols(seed, n, modes, const, snr_db=22.0, lw_ts=2e-6):
    """Symbols with a random-walk phase and AWGN, complex64 (n, modes)."""
    rng = np.random.default_rng(seed)
    sym = const[rng.integers(0, len(const), size=(n, modes))]
    phi = np.cumsum(rng.normal(scale=np.sqrt(2 * np.pi * lw_ts), size=(n, modes)), axis=0)
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    noise = sigma * (rng.normal(size=(n, modes)) + 1j * rng.normal(size=(n, modes)))
    return (sym * np.exp(1j * phi) + noise).astype(np.complex64)


def zero_codeword_llrs(seed, esn0_db, n=64800):
    """BPSK LLRs (n, len(esn0_db)) float32 of the all-zero codeword, one
    column per Es/N0 [dB]."""
    rng = np.random.default_rng(seed)
    cols = []
    for snr in esn0_db:
        sigma = np.sqrt(0.5 * 10 ** (-snr / 10))
        cols.append(2 * (1.0 + sigma * rng.normal(size=n)) / sigma**2)
    return np.stack(cols, axis=1).astype(np.float32)


def assert_qc_decodes_alike(out_t, out_j, rel=1e-5):
    """QC decoder outputs (totals, n_iters, fail) of the port and of JAX:
    iteration counts, fail flags and signs equal; totals within ``rel`` of
    the largest."""
    o_t, it_t, f_t = (to_np(a) for a in out_t)
    o_j, it_j, f_j = np.asarray(out_j[0], np.float32), np.asarray(out_j[1]), np.asarray(out_j[2])
    np.testing.assert_array_equal(it_t, it_j)
    np.testing.assert_array_equal(f_t, f_j)
    assert not (np.signbit(o_t) != np.signbit(o_j)).any()
    err = np.abs(o_t - o_j).max() / np.abs(o_j).max()
    assert err < rel, err


def require_cuda():
    """Skip the calling test when no CUDA device is present."""
    import pytest

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def padded_modes(seed, n_batch, n_sym, modes, n_taps, sps=2, const=None):
    """(padded signals (B, rows, modes), symbols (B, n_sym, modes)) complex64
    NumPy: symbols of ``const`` (16-QAM by default) at ``sps`` samples per
    symbol through a random mixing matrix near the identity, plus noise of
    0.01, with n_taps // 2 zero rows in front and n_taps behind (an
    odd row count times an odd ``modes`` puts odd signals of a batch off
    16-byte alignment)."""
    rng = np.random.default_rng(seed)
    const = norm_qam(16) if const is None else np.asarray(const, np.complex64)
    sym = const[rng.integers(0, len(const), size=(n_batch, n_sym, modes))]
    x = np.zeros((n_batch, n_sym * sps, modes), complex)
    x[:, ::sps] = sym
    h = np.eye(modes) + 0.1 * (rng.normal(size=(modes, modes))
                               + 1j * rng.normal(size=(modes, modes)))
    sig = x @ h.T + 0.01 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    rows = n_taps // 2 + n_sym * sps + n_taps
    pad = np.zeros((n_batch, rows, modes), np.complex64)
    pad[:, n_taps // 2:n_taps // 2 + n_sym * sps] = sig
    return pad, sym.astype(np.complex64)


def spike_taps(n_batch, modes, n_taps):
    """(B, modes, modes, n_taps) complex64 NumPy taps: a unit centre tap on
    each mode's own path."""
    h = np.zeros((n_batch, modes, modes, n_taps), np.complex64)
    h[:, np.arange(modes), np.arange(modes), n_taps // 2] = 1.0
    return h
