"""Blind phase search: the port's plain version and kernel against the JAX
package's Pallas kernel (interpret mode) and broadcast BPS.

Tolerance: the phase-index decisions may differ only at float32 near-ties
between test phases, on fewer than 1% of the symbols (the JAX package's
own rule, tests/test_pallas_kernels.py). On the card the kernel is held to
its plain version bit for bit.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.dsp import carrier_recovery as jcr  # noqa: E402
from opticommpy_tpu.kernels.bps_pallas import _square_qam_levels, bps_pallas  # noqa: E402
from opticommpy_torch.dsp import carrier_recovery as tcr  # noqa: E402
from opticommpy_torch.kernels import bps as tbps  # noqa: E402

from _torch_parity import noisy_symbols, norm_qam, require_cuda, to_np  # noqa: E402

MAX_MISMATCH = 0.01


def _psk8():
    c = np.exp(2j * np.pi * np.arange(8) / 8)
    return (c / np.sqrt(np.mean(np.abs(c) ** 2))).astype(np.complex64)


@pytest.mark.parametrize("n,modes,n_half,n_phases", [
    (3000, 2, 37, 64),   # the chain's window and phase count
    (1111, 1, 8, 32),    # odd length, one mode
    (900, 3, 10, 64),    # three modes
])
def test_plain_matches_pallas_square_qam(n, modes, n_half, n_phases):
    const = norm_qam(16)
    sig = noisy_symbols(n + modes, n, modes, const)
    ref = np.asarray(bps_pallas(sig, n_half, const, n_phases, interpret=True))
    out = tbps.bps_kernel(torch.as_tensor(sig), n_half, const, n_phases)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert np.mean(to_np(out) != ref) < MAX_MISMATCH


def test_plain_matches_pallas_nonsquare():
    """8-PSK has no square grid: the M-point distance path."""
    const = _psk8()
    assert _square_qam_levels(const.real, const.imag) is None
    sig = noisy_symbols(4, 1500, 2, const, snr_db=22.0, lw_ts=1e-6)
    ref = np.asarray(bps_pallas(sig, 12, const, 64, interpret=True))
    out = to_np(tbps.bps_kernel(torch.as_tensor(sig), 12, const, 64))
    # 8-PSK distances are pi/4-periodic: test phases pi/4 apart tie exactly
    d = np.angle(np.exp(1j * 8 * (out - ref))) / 8
    assert np.mean(np.abs(d) > 1e-4) < MAX_MISMATCH


def test_grid_path_only_for_numpy_constellation():
    """As in the JAX package, a tensor constellation takes the M-point path;
    both paths decide alike."""
    const = norm_qam(16)
    sig = torch.as_tensor(noisy_symbols(5, 2000, 2, const))
    a = tbps.bps_indices(sig, 20, const, 64)
    b = tbps.bps_indices(sig, 20, torch.as_tensor(const), 64)
    assert float((a != b).float().mean()) < MAX_MISMATCH


def test_broadcast_bps_matches_jax():
    const = norm_qam(16)
    sig = noisy_symbols(6, 2000, 2, const)
    ref = np.asarray(jcr.bps(sig, 16, const, 64))
    out = to_np(tcr.bps(torch.as_tensor(sig), 16, torch.as_tensor(const), 64))
    assert np.mean(out != ref) < MAX_MISMATCH


def test_cpr_matches_jax():
    const = norm_qam(16)
    sig = noisy_symbols(7, 3000, 2, const, lw_ts=1e-6)
    t = np.arange(3000)[:, None] / 32e9
    sig = (sig * np.exp(2j * np.pi * 2e8 * t)).astype(np.complex64)
    jcfg = jcr.CPRConfig(alg="bps", M=16, N=35, B=64, Ts=1 / 32e9)
    y_j = np.asarray(jcr.cpr(sig, jcfg))
    outs = {}
    for alg in ("bps", "bps-pallas"):  # the JAX package runs the latter on TPU only
        tcfg = tcr.CPRConfig(alg=alg, M=16, N=35, B=64, Ts=1 / 32e9)
        outs[alg] = to_np(tcr.cpr(torch.as_tensor(sig), tcfg))
        assert np.mean(np.abs(outs[alg] - y_j) < 1e-4) > 1 - MAX_MISMATCH, alg
    with pytest.raises(ValueError, match="incorrectly specified"):
        tcr.cpr(torch.as_tensor(sig), tcr.CPRConfig(alg="pll"))


def _const(kind):
    """A case's constellation as the callers pass it: a NumPy array (the
    grid where it is a square QAM) or, as ``cpr`` passes it, a CPU tensor."""
    name = kind.split()[0]
    c = _psk8() if name == "psk8" else norm_qam(int(name[3:]))
    return torch.as_tensor(c) if kind.endswith("tensor") else c


# (constellation, N, modes, n_half, B): the chain's call, path C's, path I's
# (the M-point route at window 51), 8-PSK, and small cases that run the
# kernel's other instances and edges
GPU_CASES = [
    ("qam16", 65536, 2, 37, 64),
    ("qam16", 65536, 22, 37, 64),
    ("qam16 tensor", 60436, 2, 25, 64),
    ("psk8", 20000, 2, 37, 64),
    ("qam4", 1001, 3, 0, 32),
    ("qam64", 4099, 2, 12, 64),
    ("qam64 tensor", 3001, 1, 25, 32),
    ("qam16", 50, 2, 37, 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n,modes,n_half,n_phases", GPU_CASES)
def test_kernel_matches_plain_on_gpu(kind, n, modes, n_half, n_phases):
    """K1 equals its plain version bit for bit: every index, and the phases
    ``bps_kernel`` writes; one launch a call."""
    dev = require_cuda()
    const = _const(kind)
    sig = torch.as_tensor(noisy_symbols(8, n, modes, np.asarray(const)), device=dev)
    before = tbps.launches
    idx_k = tbps.bps_indices(sig, n_half, const, n_phases)
    est_k = tbps.bps_kernel(sig, n_half, const, n_phases)
    assert tbps.launches == before + 2
    idx_p = tbps.bps_indices_plain(sig, n_half, const, n_phases)
    torch.cuda.synchronize()
    assert idx_k.dtype == torch.int64 and est_k.dtype == torch.float32
    assert int((idx_k != idx_p).sum()) == 0
    assert torch.equal(est_k, tbps._test_phases(n_phases, idx_p.device)[0][idx_p])


@pytest.mark.gpu
@pytest.mark.parametrize("run_blocks", [1, 2, 3, 7, 1000])
def test_kernel_bits_do_not_depend_on_run_length_on_gpu(run_blocks):
    """Blocks are counted from the padded start, not from a CTA's run: any
    number of output blocks per CTA gives the same bits."""
    dev = require_cuda()
    const = norm_qam(16)
    sig = torch.as_tensor(noisy_symbols(9, 7000, 3, const), device=dev)
    ref = tbps.bps_indices_plain(sig, 37, const, 64)
    out = tbps._launch(sig, 37, const, 64, tbps._OUT_INDEX, run_blocks=run_blocks)
    assert torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 16, 64])
def test_threshold_slicer_on_every_float32_on_gpu(M):
    """The kernel's threshold slicer takes every one of the 2^32 float32
    inputs to the level of the true division (bps_exact_check)."""
    dev = require_cuda()
    c = norm_qam(M)
    count, first = tbps.bps_exact_check(*tbps._square_qam_levels(c.real, c.imag), dev)
    assert count == 0, first
