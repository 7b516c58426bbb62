"""K15, the unwrap-and-derotate kernel (``kernels/unwrap.py``,
``csrc/unwrap.cu``), and its routing in ``dsp/carrier_recovery``.

On the CPU: the wrapper's argument checks and the CPU route of ``unwrap``
and ``unwrap_derotate`` (the plain twin's PyTorch ops, along any dim and in
any floating dtype). On the card: K15 against its plain twin, phases (and so
turns) bit for bit and the derotated symbols within 1e-6 of |y|
(``sincosf`` against ``torch.exp``), two runs bit-identical, and the
routing: a CUDA tensor runs K15 or raises. The plain twin is held to
``jnp.unwrap`` in ``tests/test_torch_ops.py``.
"""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_torch.dsp import carrier_recovery as tcr  # noqa: E402
from opticommpy_torch.kernels import unwrap as tunwrap  # noqa: E402

from _torch_parity import noisy_symbols, norm_qam, require_cuda  # noqa: E402


def _phases(seed, n, c):
    """BPS-like phases in [0, pi/2): a wrapped random walk of 4 phi."""
    rng = np.random.default_rng(seed)
    p = np.cumsum(rng.normal(scale=0.8, size=(n, c)), axis=0)
    return (np.mod(p, 2 * np.pi) / 4).astype(np.float32)


def _inputs(seed, n, c, device="cpu"):
    phi = torch.as_tensor(_phases(seed, n, c), device=device)
    y = torch.as_tensor(noisy_symbols(seed, n, c, norm_qam(16)), device=device)
    return phi, y


BAD_ARGS = {
    "3-D": lambda: (torch.zeros(8, 2, 2), None),
    "float64": lambda: (torch.zeros(8, 2, dtype=torch.float64), None),
    "not contiguous": lambda: (torch.zeros(2, 8).t(), None),
    "y of another shape": lambda: (torch.zeros(8, 2), torch.zeros(8, 3, dtype=torch.complex64)),
    "y complex128": lambda: (torch.zeros(8, 2), torch.zeros(8, 2, dtype=torch.complex128)),
    "CPU tensors": lambda: (torch.zeros(8, 2), torch.zeros(8, 2, dtype=torch.complex64)),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_kernel_rejects_what_it_does_not_take(case):
    """A clear error, before any launch, for input the kernel does not take."""
    phi, y = BAD_ARGS[case]()
    with pytest.raises(ValueError, match="unwrap kernel"):
        tunwrap.unwrap_derotate_kernel(phi, y)


def test_cpu_route_is_the_pytorch_ops():
    """On the CPU, ``unwrap_derotate`` and ``unwrap`` are the plain twin:
    ``unwrap(4 phi) / 4`` within a rounding, ``y exp(1j theta)`` exactly,
    no launch."""
    phi, y = _inputs(3, 3000, 3)
    before = tunwrap.launches
    out, theta = tcr.unwrap_derotate(phi, y, 4)
    want_theta, want_out = tunwrap.unwrap_derotate_plain(phi, y, 4)
    assert torch.equal(theta, want_theta) and torch.equal(out, want_out)
    assert torch.equal(out, y * torch.exp(1j * theta))
    assert torch.equal(tcr.unwrap(4 * phi, dim=0), tunwrap.unwrap_derotate_plain(4 * phi, m=1)[0])
    assert torch.allclose(theta, tcr.unwrap(4 * phi, dim=0) / 4, rtol=0, atol=1e-5)
    assert tunwrap.launches == before


@pytest.mark.parametrize("n", [1, 2])
def test_plain_twin_short_columns(n):
    """One row is its own phase, no turns; two rows one step."""
    phi = torch.tensor([[0.0, 1.5, 0.1], [1.5, 0.0, 0.2]], dtype=torch.float32)[:n]
    theta, y_out = tunwrap.unwrap_derotate_plain(phi, None, 4)
    turns = tunwrap.turns(theta, phi, 4)
    assert theta.shape == turns.shape == (n, 3) and y_out is None
    assert torch.equal(turns[0], torch.zeros(3, dtype=torch.int64))
    assert torch.equal(theta[0], phi[0])
    if n == 2:  # 4 x 1.5 = 6.0 rad: a step of about one turn, down or up
        assert turns[1].tolist() == [-1, 1, 0]
        # the float route rounds the correction and the sum: an ulp or two apart
        assert torch.allclose(theta, tcr.unwrap(4 * phi, dim=0) / 4, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,dim", [((40, 3000), 1), ((3000, 4, 5), 0), ((6, 2000, 3), 1),
                                       ((0, 3), 0), ((3, 0), 0)])
def test_cpu_unwrap_any_dim_is_the_columns_unwrapped(shape, dim):
    """Along any dim of any shape, ``unwrap`` is each line along ``dim``
    unwrapped as a column of its own, bit for bit."""
    rng = np.random.default_rng(sum(shape) + dim)
    p = torch.as_tensor(np.angle(np.exp(1j * np.cumsum(rng.normal(scale=1.5, size=shape),
                                                       axis=dim))).astype(np.float32))
    got = tcr.unwrap(p, dim=dim)
    x = p.movedim(dim, 0)
    cols = x.reshape(x.shape[0], math.prod(x.shape[1:]))
    want = tunwrap.unwrap_derotate_plain(cols, m=1)[0].reshape(x.shape).movedim(0, dim)
    assert got.shape == p.shape and torch.equal(got, want)


def test_unwrap_derotate_rejects_y_of_another_shape():
    phi, y = _inputs(4, 100, 2)
    with pytest.raises(ValueError, match="unwrap_derotate"):
        tcr.unwrap_derotate(phi, y[:, :1], 4)


# (N, C): the batch chain's and path C's 11 polmux signals, the single
# chain's 2 modes, and edges: one chunk of 352 rows at 22 columns (no first
# launch), a last chunk of one row, one row, one column, more columns than
# one CTA takes, a ragged last chunk
GPU_SHAPES = [(65536, 22), (65536, 2), (352, 22), (353, 22), (1, 3), (5000, 1), (1000, 40),
              (70001, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,c", GPU_SHAPES)
@pytest.mark.parametrize("m", [1, 4])
def test_kernel_matches_plain_on_gpu(n, c, m):
    """Phases bit for bit, and so the turns read back from them, derotated
    symbols within 1e-6 of |y|; one call counted; without ``y`` the same
    phases."""
    dev = require_cuda()
    phi, y = _inputs(n + c, n, c, dev)
    phi = phi * (4.0 / m)
    before = tunwrap.launches
    theta_k, y_k = tunwrap.unwrap_derotate_kernel(phi, y, m)
    assert tunwrap.launches == before + 1
    theta_p, y_p = tunwrap.unwrap_derotate_plain(phi, y, m)
    torch.cuda.synchronize()
    assert torch.equal(tunwrap.turns(theta_k, phi, m), tunwrap.turns(theta_p, phi, m))
    assert torch.equal(theta_k, theta_p)
    assert torch.equal(tunwrap.unwrap_derotate_kernel(phi, None, m)[0], theta_p)
    assert float((y_k - y_p).abs().max()) <= 1e-6 * float(y.abs().max())


@pytest.mark.gpu
def test_kernel_runs_are_bit_identical_on_gpu():
    dev = require_cuda()
    phi, y = _inputs(5, 65536, 22, dev)
    a = tunwrap.unwrap_derotate_kernel(phi, y, 4)
    b = tunwrap.unwrap_derotate_kernel(phi, y, 4)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.gpu
def test_kernel_nan_spreads_like_the_plain_twin_on_gpu():
    """A NaN phase makes its row and every later row of its column NaN."""
    dev = require_cuda()
    phi, y = _inputs(6, 5000, 3, dev)
    phi[1234, 1] = math.nan
    theta_k, y_k = tunwrap.unwrap_derotate_kernel(phi, y, 4)
    theta_p, _ = tunwrap.unwrap_derotate_plain(phi, y, 4)
    assert torch.equal(torch.isnan(theta_k), torch.isnan(theta_p))
    assert bool(torch.isnan(theta_k[1234:, 1]).all())
    assert not bool(torch.isnan(theta_k[:1234]).any())
    ok = ~torch.isnan(theta_p)
    assert torch.equal(theta_k[ok], theta_p[ok]) and bool(torch.isnan(y_k[1234:, 1]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["3-D", "float64", "not contiguous", "y complex128"])
def test_kernel_rejects_cuda_input_it_does_not_take_on_gpu(case):
    dev = require_cuda()
    phi, y = BAD_ARGS[case]()
    with pytest.raises(ValueError, match="unwrap kernel"):
        tunwrap.unwrap_derotate_kernel(phi.to(dev), None if y is None else y.to(dev))


@pytest.mark.gpu
def test_routing_on_gpu():
    """A CUDA float32 tensor goes to K15 along any dim and of any shape, and
    agrees with the CPU route (turns equal, phases within a rounding); a CUDA
    tensor K15 does not take raises, with no PyTorch route behind it."""
    dev = require_cuda()
    phi, y = _inputs(7, 3000, 4, dev)
    before = tunwrap.launches
    u1 = tcr.unwrap(4 * phi, dim=0)
    u2 = tcr.unwrap(4 * phi[:, 0], dim=0)
    u3 = tcr.unwrap((4 * phi).t(), dim=1)
    u4 = tcr.unwrap((4 * phi).reshape(3000, 2, 2), dim=0)
    out, theta = tcr.unwrap_derotate(phi, y, 4)
    assert tunwrap.launches == before + 5
    x = 4 * phi.cpu()
    ref = tcr.unwrap(x, dim=0)
    assert torch.equal(tunwrap.turns(u1.cpu(), x, 1), tunwrap.turns(ref, x, 1))
    assert float((u1.cpu() - ref).abs().max()) < 1e-5
    assert torch.equal(u2, u1[:, 0]) and torch.equal(u3, u1.t())
    assert torch.equal(u4, u1.reshape(3000, 2, 2))
    assert float((theta.cpu() - ref / 4).abs().max()) < 1e-5
    assert float((out - y * torch.exp(1j * theta)).abs().max()) <= 1e-6 * float(y.abs().max())
    with pytest.raises(ValueError, match="float32"):
        tcr.unwrap((4 * phi).double(), dim=0)
    with pytest.raises(ValueError, match="complex64"):
        tcr.unwrap_derotate(phi, y.to(torch.complex128), 4)
    with pytest.raises(ValueError, match="float32"):
        tcr.unwrap_derotate(phi.double(), y, 4)
    assert tunwrap.launches == before + 5
