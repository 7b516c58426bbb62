"""K1's plain version in the kernel's order, and the kernel's host tables.

The window sums of ``bps_indices_plain`` are block prefix and suffix sums
(``csrc/bps.cu`` adds in the same order); its grid slicer divides, where the
kernel compares with host thresholds. Pinned here on the CPU:

- the plain version against the JAX package's Pallas kernel (interpret
  mode) and its broadcast ``bps``, at windows 75, 51 and 1, N shorter than a
  window and not a multiple of it, 1-22 modes, 32 and 64 test phases, on
  the grid and the M-point routes (path I's tensor 16-QAM at window 51):
  the decisions may differ only at float32 near-ties, on fewer than 1% of
  the symbols (the JAX package's rule, tests/test_pallas_kernels.py);
- the window sums against a float64 sum of the same distances, within
  w * eps relative (a cumulative-sum difference would lose eps * N);
- the kernel's threshold slicers (a chain of selects up to 4 levels, a
  binary search above) against NumPy's float32 division on every float32
  within 2^20 ulps of each threshold, +-0, +-inf, NaN and every subnormal.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from opticommpy_tpu.dsp import carrier_recovery as jcr  # noqa: E402
from opticommpy_tpu.kernels.bps_pallas import bps_pallas  # noqa: E402
from opticommpy_torch.kernels import bps as tbps  # noqa: E402

from _torch_parity import noisy_symbols, norm_qam, to_np  # noqa: E402

MAX_MISMATCH = 0.01
EPS32 = float(np.finfo(np.float32).eps)


def _psk8():
    c = np.exp(2j * np.pi * np.arange(8) / 8)
    return (c / np.sqrt(np.mean(np.abs(c) ** 2))).astype(np.complex64)


def _wrapped(d, m):
    """Phase differences folded to the constellation's symmetry 2 pi / m:
    test phases 2 pi / m apart tie exactly (8-PSK: pi / 4)."""
    return np.angle(np.exp(1j * m * d)) / m


# (constellation, N, modes, n_half, B)
CASES = [
    ("qam16", 3000, 2, 37, 64),       # the chain's window
    ("qam16", 2500, 2, 25, 64),       # window 51 on the grid
    ("qam16 tensor", 2500, 2, 25, 64),  # path I's call: M-point route, window 51
    ("qam16", 777, 3, 0, 64),         # window 1
    ("qam16", 60, 2, 37, 64),         # N shorter than one window
    ("qam16", 1001, 1, 37, 32),       # N not a multiple of the window, 1 mode
    ("qam64", 900, 3, 10, 64),        # the searched grid, 3 modes
    ("qam16", 600, 22, 25, 64),       # path C's 22 columns
    ("qam4", 1200, 2, 37, 32),        # the grid of 2 levels
    ("psk8", 1500, 2, 12, 64),        # no grid: M points
]


def _case(kind, n, modes, seed):
    name = kind.split()[0]
    c = _psk8() if name == "psk8" else norm_qam(int(name[3:]))
    sig = noisy_symbols(seed, n, modes, c, snr_db=22.0 if name != "qam64" else 28.0,
                        lw_ts=1e-6)
    return c, sig


@pytest.mark.parametrize("kind,n,modes,n_half,n_phases", CASES)
def test_block_order_matches_jax(kind, n, modes, n_half, n_phases):
    c, sig = _case(kind, n, modes, n + modes)
    tensor = kind.endswith("tensor")
    const_t = torch.as_tensor(c) if tensor else c
    idx = tbps.bps_indices_plain(torch.as_tensor(sig), n_half, const_t, n_phases)
    out = to_np(tbps._test_phases(n_phases, idx.device)[0][idx])
    assert out.shape == (n, modes)
    # a device array takes the Pallas kernel's M-point route, as in path I
    ref_p = np.asarray(bps_pallas(sig, n_half, jnp.asarray(c) if tensor else c, n_phases,
                                  interpret=True))
    ref_b = np.asarray(jcr.bps(sig, n_half, c, n_phases))
    m = 8 if kind == "psk8" else 4
    for ref in (ref_p, ref_b):
        assert np.mean(np.abs(_wrapped(out - ref, m)) > 1e-4) < MAX_MISMATCH


@pytest.mark.parametrize("w", [75, 51, 5, 1])
def test_window_sums_within_w_eps_of_float64(w):
    """Each window sum within w * eps of the float64 sum of its float32
    terms, at 20,000 windows (a cumulative-sum difference would be off by
    ~eps times the sum of all 20,000 terms)."""
    rng = np.random.default_rng(w)
    n = 20000
    q = (-(-n // w) + 1) * w
    d = (rng.random((q, 2, 8)) ** 4 * 2.0).astype(np.float32)  # >= 0, wide spread
    d[rng.random(q) < 0.01] *= 1e3
    sums = to_np(tbps._window_sums_plain(torch.as_tensor(d), n, w)).astype(np.float64)
    exact = np.zeros((n, 2, 8))
    for j in range(w):  # float64 sums of the float32 terms (rel. err < w * 2^-53)
        exact += d[j:j + n]
    assert np.all(np.abs(sums - exact) <= w * EPS32 * exact)


def test_window_sums_equal_the_direct_sum_at_block_starts_and_windows_of_1():
    rng = np.random.default_rng(3)
    d = rng.random((8 * 7, 3, 4)).astype(np.float32)
    got = tbps._window_sums_plain(torch.as_tensor(d), 7 * 7, 7)
    # a window that starts a block is its block's serial suffix sum
    for b in range(7):
        acc = d[7 * b + 6].copy()
        for i in range(5, -1, -1):
            acc = d[7 * b + i] + acc
        np.testing.assert_array_equal(to_np(got[7 * b]), acc)
    one = tbps._window_sums_plain(torch.as_tensor(d), 55, 1)
    np.testing.assert_array_equal(to_np(one), d[:55])


def _kernel_level(x, route, thr, lev):
    """The kernel's slicer (csrc/bps.cu: Grid4 / GridSearch) in NumPy."""
    if route == tbps.GRID4:
        q = np.full(x.shape, lev[0], np.float32)
        for k in (1, 2, 3):
            q = np.where(x >= thr[k], lev[k], q)
        return q
    k = np.zeros(x.shape, np.int64)
    half = len(thr) // 2
    while half:
        k += np.where(x >= thr[k + half], half, 0)
        half //= 2
    return lev[k]


def _division_level(x, lo, step, n_lev):
    """clip(rint((x - lo) / step), 0, top) * step + lo in float32, NaN to
    level 0 (fmaxf / fminf), as the division route computes it."""
    k = tbps.slicer_index(x, lo, step, n_lev)
    return k * np.float32(step) + np.float32(lo)


@pytest.mark.parametrize("M", [4, 16, 64])
def test_slicer_thresholds_decide_as_the_division(M):
    c = norm_qam(M)
    lo, step, n_lev = tbps._square_qam_levels(c.real, c.imag)
    route, thr, lev = tbps.slicer_tables(lo, step, n_lev)
    assert route == (tbps.GRID4 if n_lev <= 4 else tbps.GRID_SEARCH)
    assert thr.dtype == lev.dtype == np.float32 and len(thr) == len(lev)
    th = thr[1:n_lev]
    assert np.all(np.isfinite(th)) and np.all(np.diff(th) > 0)
    assert np.all(np.isposinf(thr[n_lev:])) and np.all(lev[n_lev:] == lev[n_lev - 1])
    keys = tbps._to_key(th)[:, None] + np.arange(-2**20, 2**20 + 1)[None, :]
    around = tbps._from_key(keys.ravel())
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38, -3.4e38], np.float32)
    sub = np.arange(1, 2**23, dtype=np.uint32)
    inputs = [around, special]
    for chunk in np.array_split(sub, 4):  # every subnormal, both signs
        inputs += [chunk.view(np.float32), (chunk | np.uint32(2**31)).view(np.float32)]
    for x in inputs:
        got = _kernel_level(x, route, thr, lev)
        want = _division_level(x, lo, step, n_lev)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_plain_slicer_divides_truly():
    """The plain version's slicer equals NumPy's float32 division route (a
    CUDA tensor divided by a Python float would be multiplied by the
    reciprocal instead, which can round a near-tie the other way)."""
    c = norm_qam(16)
    lo, step, n_lev = tbps._square_qam_levels(c.real, c.imag)
    _, thr, _ = tbps.slicer_tables(lo, step, n_lev)
    rng = np.random.default_rng(0)
    keys = tbps._to_key(thr[1:n_lev])[:, None] + np.arange(-5000, 5001)[None, :]
    x = np.concatenate([tbps._from_key(keys.ravel()),
                        rng.normal(scale=2.0, size=10**5).astype(np.float32)])
    got = to_np(tbps._slice_plain(torch.as_tensor(x), lo, step, n_lev))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _division_level(x, lo, step, n_lev).view(np.uint32))


@pytest.mark.parametrize("kind,route", [("qam16", tbps.GRID4), ("qam4", tbps.GRID4),
                                        ("qam64", tbps.GRID_SEARCH), ("psk8", tbps.POINTS),
                                        ("qam16 tensor", tbps.POINTS),
                                        ("qam16 list", tbps.POINTS)])
def test_kernel_tables_route_like_the_plain_version(kind, route):
    """The kernel's tables: the grid only for a NumPy square QAM (as the
    plain version and the JAX package decide), the constellation itself
    otherwise; uploaded once per content and device."""
    name = kind.split()[0]
    c = _psk8() if name == "psk8" else norm_qam(int(name[3:]))
    arg = (torch.as_tensor(c) if kind.endswith("tensor") else
           c.tolist() if kind.endswith("list") else c)
    cpu = torch.device("cpu")
    got = tbps._kernel_tables(arg, cpu)
    assert got[0] == route
    if route == tbps.POINTS:
        assert got[1].dtype == torch.complex64 and got[3] == len(c)
        np.testing.assert_array_equal(to_np(got[1]), c)
    else:
        _, thr, lev = tbps.slicer_tables(*tbps._square_qam_levels(c.real, c.imag))
        np.testing.assert_array_equal(to_np(got[1]), thr)
        np.testing.assert_array_equal(to_np(got[2]), lev)
        assert got[3] == len(thr)
    again = tbps._kernel_tables(arg, cpu)
    assert again[1].data_ptr() == got[1].data_ptr() or kind.endswith("tensor")
