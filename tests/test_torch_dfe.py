"""The port's DFE / FFE against the JAX package: ``dfe`` / ``ffe`` against
the JAX scans, and K13's plain version (``kernels/dfe.py``, behind
``dfe_kernel`` / ``ffe_kernel``) against ``dfe_pallas`` / ``ffe_pallas`` in
interpret mode; batch against single and the real instance against the
complex one, both bit for bit; the route to the kernel; and, on a card,
the kernel against its plain version.

Tolerances:
- ``y`` and taps within 1e-5 relative of JAX (the JAX package's own pin
  between its kernel and its scan, ``tests/test_pallas_kernels.py:139-219``).
  The port's tap sums run as a pairwise tree, JAX's in XLA's order.
- The JAX kernel keeps updating the taps over the padded tail of its last
  1024-symbol block when ``trainingMode="fulltime"`` (zero reference,
  windows running into the zero padding); the port loops over exactly the
  symbols. So at fulltime the final taps are held to the JAX kernel with a
  block that divides the symbol count, and to the JAX scan otherwise.
- Kernel against plain on the card, batch against single, real against
  complex instance: equal bit for bit.
"""

import contextlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm.modulation import gray_mapping  # noqa: E402
from opticommpy_tpu.dsp import equalization as jeq  # noqa: E402
from opticommpy_tpu.kernels.dfe_pallas import dfe_pallas, ffe_pallas  # noqa: E402
from opticommpy_torch.convert import config_from_jax  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.kernels import dfe as k13  # noqa: E402

from _torch_parity import rel_err, require_cuda, to_np  # noqa: E402

REL = 1e-5
PSK8 = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)


def _pam_isi(seed=0, n=3000, h=(0.15, 1.0, 0.3, -0.1), noise=0.02):
    rng = np.random.default_rng(seed)
    const = gray_mapping(4, "pam").real
    sym = const[rng.integers(0, 4, size=n)].astype(np.float32)
    x = np.convolve(sym, np.asarray(h), "same") + noise * rng.normal(size=n)
    return x.astype(np.float32), sym


def _cplx_isi(const, seed=1, n=2000):
    rng = np.random.default_rng(seed)
    sym = const[rng.integers(0, len(const), size=n)].astype(np.complex64)
    h = np.array([0.1 + 0.05j, 1.0, 0.2 - 0.1j], np.complex64)
    x = np.convolve(sym, h, "same") + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return x.astype(np.complex64), sym


def _qam4():
    c = gray_mapping(4, "qam")
    return (c / np.sqrt(np.mean(np.abs(c) ** 2))).astype(np.complex64)


PAM_DFE = dict(nTapsFF=7, nTapsFB=5, SpS=1, mu=2e-3, nTrain=1200, M=4, constType="pam")
QAM_DFE = dict(nTapsFF=7, nTapsFB=3, SpS=1, mu=2e-3, nTrain=800, M=4, constType="qam",
               trainingMode="fulltime")
PSK_DFE = dict(nTapsFF=7, nTapsFB=3, SpS=1, mu=2e-3, nTrain=800, M=8, constType="psk")
PAM_FFE = dict(nTaps=9, SpS=1, mu=2e-3, nTrain=1000, M=4, constType="pam")


def _cases():
    x, s = _pam_isi()
    xq, sq = _cplx_isi(_qam4())
    xp, sp = _cplx_isi(PSK8, seed=3)
    return {"pam": (x, s, PAM_DFE), "qam-fulltime": (xq, sq, QAM_DFE),
            "psk-argmin": (xp, sp, PSK_DFE)}


@pytest.mark.parametrize("case", ["pam", "qam-fulltime", "psk-argmin"])
def test_dfe_matches_jax_scan(case):
    x, s, kw = _cases()[case]
    yj, fj, bj, mj = jeq.dfe(jnp.asarray(x), jnp.asarray(s), jeq.DFEConfig(**kw))
    yt, ft, bt, mt = teq.dfe(torch.as_tensor(x), torch.as_tensor(s), teq.DFEConfig(**kw))
    assert yt.shape == yj.shape and yt.dtype == (torch.float32 if case == "pam"
                                                 else torch.complex64)
    for a, b in ((yt, yj), (ft, fj), (bt, bj), (mt, mj)):
        assert rel_err(a, b) < REL


def test_ffe_matches_jax_scan():
    x, s = _pam_isi(seed=2, n=2500, h=(0.2, 1.0, 0.25))
    yj, fj, mj = jeq.ffe(jnp.asarray(x), jnp.asarray(s), jeq.FFEConfig(**PAM_FFE))
    yt, ft, mt = teq.ffe(torch.as_tensor(x), torch.as_tensor(s), teq.FFEConfig(**PAM_FFE))
    assert yt.dtype == torch.float32 and ft.dtype == torch.complex64
    for a, b in ((yt, yj), (ft, fj), (mt, mj)):
        assert rel_err(a, b) < REL


def test_ffe_equalizes_isi_channel():
    """tests/test_equalization.py:121-131 on the port (8,000 symbols)."""
    rng = np.random.default_rng(7)
    const = np.array([-3.0, -1.0, 1.0, 3.0]) / np.sqrt(5)
    symb = const[rng.integers(0, 4, size=8000)]
    rx = np.convolve(symb, np.array([0.15, 1.0, 0.25]), "same") + 0.01 * rng.normal(size=8000)
    cfg = teq.FFEConfig(nTaps=11, mu=1e-3, nTrain=4000, M=4, constType="pam")
    _, _, mse = teq.ffe(torch.as_tensor(rx), torch.as_tensor(symb), cfg)
    assert float(mse[-2000:].mean()) < 0.02


def test_dfe_beats_ffe_on_deep_isi():
    """tests/test_equalization.py:134-148 on the port (8,000 symbols)."""
    rng = np.random.default_rng(9)
    symb = np.array([-1.0, 1.0])[rng.integers(0, 2, size=8000)]
    rx = np.convolve(symb, np.array([1.0, 0.6]))[:8000] + 0.02 * rng.normal(size=8000)
    x, s = torch.as_tensor(rx), torch.as_tensor(symb)
    _, _, _, mse_dfe = teq.dfe(x, s, teq.DFEConfig(nTapsFF=9, nTapsFB=4, mu=2e-3, nTrain=3000,
                                                   M=2, constType="pam",
                                                   trainingMode="fulltime"))
    _, _, mse_ffe = teq.ffe(x, s, teq.FFEConfig(nTaps=9, mu=2e-3, nTrain=3000, M=2,
                                                constType="pam", trainingMode="fulltime"))
    assert float(mse_dfe[-2000:].mean()) < float(mse_ffe[-2000:].mean())


@pytest.mark.parametrize("case", ["pam", "qam-fulltime", "psk-argmin"])
def test_dfe_kernel_plain_matches_pallas(case):
    x, s, kw = _cases()[case]
    jcfg = jeq.DFEConfig(**kw)
    yj, fj, bj, mj = dfe_pallas(jnp.asarray(x), jnp.asarray(s), jcfg, interpret=True)
    with mock.patch.object(k13, "dfe_pass_plain", wraps=k13.dfe_pass_plain) as plain:
        yt, ft, bt, mt = k13.dfe_kernel(torch.as_tensor(x), torch.as_tensor(s),
                                        config_from_jax(jcfg))
    assert plain.call_count == 1
    assert yt.dtype == torch.complex64 and yt.shape == yj.shape
    assert rel_err(yt, yj) < REL and rel_err(mt, mj) < REL
    if kw.get("trainingMode") == "fulltime":
        # the JAX kernel's padded tail moves its final taps (module docstring;
        # ROADMAP.md queue 3): without a padded tail they agree
        assert rel_err(bt, bj) > 1e-3
        _, fj, bj, _ = dfe_pallas(jnp.asarray(x), jnp.asarray(s), jcfg, interpret=True,
                                  block=len(s) // 2)
    assert rel_err(ft, fj) < REL and rel_err(bt, bj) < REL


def test_ffe_kernel_plain_matches_pallas():
    x, s = _pam_isi(seed=2, n=2500, h=(0.2, 1.0, 0.25))
    jcfg = jeq.FFEConfig(**PAM_FFE)
    yj, fj, mj = ffe_pallas(jnp.asarray(x), jnp.asarray(s), jcfg, interpret=True)
    yt, ft, mt = k13.ffe_kernel(torch.as_tensor(x), torch.as_tensor(s), config_from_jax(jcfg))
    assert yt.dtype == torch.float32 and ft.dtype == torch.complex64
    for a, b in ((yt, yj), (ft, fj), (mt, mj)):
        assert rel_err(a, b) < REL


@pytest.mark.parametrize("eq", ["dfe", "ffe"])
def test_batch_equals_single_bit_for_bit(eq):
    x1, s1 = _pam_isi(seed=4, n=1500)
    x2, s2 = _pam_isi(seed=5, n=1500, h=(0.3, 1.0, -0.2))
    run = k13.dfe_kernel if eq == "dfe" else k13.ffe_kernel
    cfg = (teq.DFEConfig(**PAM_DFE, trainingMode="fulltime") if eq == "dfe"
           else teq.FFEConfig(**PAM_FFE, trainingMode="fulltime"))
    batch = run(torch.as_tensor(np.stack([x1, x2])), torch.as_tensor(np.stack([s1, s2])), cfg)
    single = run(torch.as_tensor(x2), torch.as_tensor(s2), cfg)
    for b, s in zip(batch, single):
        assert torch.equal(b[1], s)
    assert not torch.equal(batch[0][0], batch[0][1])


def test_real_instance_equals_complex_instance():
    """At PAM the complex recurrence keeps every imaginary plane at zero, so
    the real instance gives its real parts exactly."""
    x, s = _pam_isi(seed=6, n=1200)
    const = k13.norm_const(4, "pam")
    sig_pad, ref, n_out, _ = k13.prepare(torch.as_tensor(x), torch.as_tensor(s), 15, 1, const)
    f0 = torch.zeros((1, 15))
    f0[0, 7] = 1.0
    b0 = torch.zeros((1, 5))
    args = (const, n_out, 1, 2e-3, 600, True)
    real = k13.dfe_pass_plain(sig_pad, ref, const, f0, b0, *args[1:])
    cplx = k13.dfe_pass_plain(*(t.to(torch.complex64) for t in (sig_pad, ref)), const,
                              f0.to(torch.complex64), b0.to(torch.complex64), *args[1:])
    for r, c in zip(real, cplx):
        assert torch.equal(r, c.real if c.is_complex() else c)
        if c.is_complex():
            assert not c.imag.any()


def test_dfe_run_routes_cuda_to_the_kernel_without_fallback():
    """A CUDA tensor reaches the kernel entry, and a failing kernel raises
    rather than falling back to the plain version; a CPU tensor takes the
    plain version."""
    fake = mock.MagicMock()
    fake.device.type = "cuda"
    args = (None, None, None, None, 4, 1, 1e-3, 2, True)
    with mock.patch.object(k13, "_dfe_cuda", return_value="k13") as kern, \
            mock.patch.object(k13, "dfe_pass_plain") as plain:
        assert k13.dfe_run(fake, *args) == "k13"
    assert kern.call_count == 1 and plain.call_count == 0
    with mock.patch.object(k13, "_dfe_cuda", side_effect=RuntimeError("nvcc failed")), \
            mock.patch.object(k13, "dfe_pass_plain") as plain:
        with pytest.raises(RuntimeError, match="nvcc"):
            k13.dfe_run(fake, *args)
    assert plain.call_count == 0
    x, s = _pam_isi(seed=7, n=300)
    with mock.patch.object(k13, "_dfe_cuda") as kern:
        k13.dfe_kernel(torch.as_tensor(x), torch.as_tensor(s), teq.DFEConfig(nTrain=100))
    assert kern.call_count == 0


def test_dfe_plain_rejects_bad_shapes():
    const = k13.norm_const(4, "pam")
    sig = torch.zeros((2, 100))
    f0, b0 = torch.zeros((2, 5)), torch.zeros((2, 3))
    with pytest.raises(ValueError, match="ref"):
        k13.dfe_pass_plain(sig, torch.zeros((2, 10)), const, f0, b0, 20, 1, 1e-3, 5, False)
    with pytest.raises(ValueError, match="too short"):
        k13.dfe_pass_plain(sig, torch.zeros((2, 99)), const, f0, b0, 99, 1, 1e-3, 5, False)
    with pytest.raises(ValueError, match="real constellation"):
        k13.dfe_pass_plain(sig, torch.zeros((2, 20)), k13.norm_const(16, "qam"), f0, b0, 20,
                           1, 1e-3, 5, False)


def test_dfe_wrapper_takes_the_cached_device_constellation():
    """K13's wrapper takes its constellation from the device-resident cache
    (``_build.device_tables``, one upload per constellation and device):
    two calls with one constellation hand the kernel the same tensors,
    another constellation other ones. Driven on CPU tensors with the
    library, the stream and the device context stubbed."""
    seen = []

    class _Lib:
        @staticmethod
        def dfe_launch(*args):
            seen.append((args[7].value, args[8].value))  # c_re, c_im pointers
            return 0

    x, s = _pam_isi(seed=8, n=64)
    sig_pad, ref, n_out, _ = k13.prepare(torch.as_tensor(x), torch.as_tensor(s), 15, 1,
                                         k13.norm_const(4, "pam"))
    f0, b0 = torch.zeros((1, 15)), torch.zeros((1, 5))
    consts = (k13.norm_const(4, "pam"), k13.norm_const(4, "pam").copy(), k13.norm_const(8, "pam"))
    with mock.patch.object(k13._build, "load_library", return_value=_Lib()), \
            mock.patch.object(k13._build, "stream_ptr", return_value=None), \
            mock.patch.object(torch.cuda, "device", return_value=contextlib.nullcontext()):
        for const in consts:
            k13._dfe_cuda(sig_pad, ref, const, f0, b0, n_out, 1, 1e-3, 10, False, True)
    assert seen[0] == seen[1] and seen[2][0] != seen[0][0]
    c_re, c_im, _ = k13._build.device_tables(consts[0], None, "cpu")
    assert seen[0] == (c_re.data_ptr(), c_im.data_ptr())
    np.testing.assert_array_equal(c_re.numpy(), consts[0].real)


def test_dfe_wrapper_slicer_codes():
    """The wrapper hands ``dfe_launch`` slicer code 1 (PAM levels, real
    instance) for PAM4, 2 (square grid, complex instance) for 16-QAM and 0
    (argmin) for 8-PSK, with the grid's lo, step and top; every grid's
    quotient is the kernel's true division. Driven on CPU tensors with the
    library, the stream and the device context stubbed."""
    seen = []

    class _Lib:
        @staticmethod
        def dfe_launch(*args):
            seen.append((args[1], args[10], args[11], args[12], args[13]))
            return 0

    x, s = _pam_isi(seed=9, n=64)
    consts = (k13.norm_const(4, "pam"), k13.norm_const(16, "qam"), PSK8)
    with mock.patch.object(k13._build, "load_library", return_value=_Lib()), \
            mock.patch.object(k13._build, "stream_ptr", return_value=None), \
            mock.patch.object(torch.cuda, "device", return_value=contextlib.nullcontext()):
        for const in consts:
            sig_pad, ref, n_out, _ = k13.prepare(torch.as_tensor(x), torch.as_tensor(s), 15, 1,
                                                 const)
            f0 = sig_pad.new_zeros((1, 15))
            b0 = sig_pad.new_zeros((1, 5))
            k13._dfe_cuda(sig_pad, ref, const, f0, b0, n_out, 1, 1e-3, 10, False, True)
    assert [(cplx, code) for cplx, code, *_ in seen] == [(0, 1), (1, 2), (1, 0)]
    for (_, _, lo, step, top), const in zip(seen[:2], consts):
        _, (lo_c, step_c, levels) = k13.slicer_of(const)
        assert (lo, step, top) == (lo_c, step_c, levels - 1)


# -- the kernel on the card --------------------------------------------------

def _gpu_case(dev, const, cplx, n_b=4, n=3000, n_ff=15, n_fb=5, sps=1, seed=0, extra=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_b, (n - 1) * sps + n_ff + extra))
    r = const[rng.integers(0, len(const), size=(n_b, n))]
    if cplx:
        x = x + 1j * rng.normal(size=x.shape)
    dt = torch.complex64 if cplx else torch.float32
    x = torch.as_tensor(x, device=dev).to(dt).contiguous()
    r = torch.as_tensor(r if cplx else r.real, device=dev).to(dt).contiguous()
    f0 = torch.zeros((n_b, n_ff), dtype=dt, device=dev)
    f0[:, n_ff // 2] = 1.0
    b0 = torch.zeros((n_b, max(n_fb, 1)), dtype=dt, device=dev)
    return x, r, f0, b0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pam-dfe", "pam-ffe", "qam-fulltime", "psk-argmin",
                                  "pam-complex"])
def test_kernel_matches_plain_on_gpu(case):
    dev = require_cuda()
    const = {"qam-fulltime": k13.norm_const(16, "qam"), "psk-argmin": PSK8}.get(
        case, k13.norm_const(4, "pam"))
    cplx = case in ("qam-fulltime", "psk-argmin", "pam-complex")
    use_fb = case != "pam-ffe"
    x, r, f0, b0 = _gpu_case(dev, const, cplx, n_ff=7 if case == "psk-argmin" else 15,
                             sps=2 if case == "pam-ffe" else 1)
    args = (const, f0, b0, r.shape[1], 2 if case == "pam-ffe" else 1, 2e-3, 1000,
            case != "psk-argmin", use_fb)
    before = k13.launches
    out_k = k13.dfe_run(x, r, *args)
    assert k13.launches == before + 1
    out_p = k13.dfe_pass_plain(x, r, *args)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_batch_equals_single_on_gpu():
    dev = require_cuda()
    const = k13.norm_const(4, "pam")
    x, r, f0, b0 = _gpu_case(dev, const, False, n_b=40, n=2000)
    args = (const, f0, b0, r.shape[1], 1, 2e-3, 800, True, True)
    out_b = k13.dfe_run(x, r, *args)
    out_s = k13.dfe_run(x[33:34].contiguous(), r[33:34].contiguous(), const, f0[33:34],
                        b0[33:34], r.shape[1], 1, 2e-3, 800, True, True)
    torch.cuda.synchronize()
    for a, b in zip(out_b, out_s):
        assert torch.equal(a[33:34], b)
    assert to_np(out_b[0]).std() > 0


# csrc/dfe.cu stages up to 1024 symbols at a time (kChunkMax; fewer when
# half a chunk holds them all); the edges below are those of 1024 and 2048
DFE_CHUNK = 1024


def _kernel_equals_plain(x, r, const, f0, b0, sps=1, n_train=600, fulltime=True, use_fb=True):
    """K13 against its plain version on the same CUDA tensors, bit for bit;
    returns the kernel's outputs."""
    args = (const, f0, b0, r.shape[1], sps, 2e-3, n_train, fulltime, use_fb)
    before = k13.launches
    out_k = k13.dfe_run(x, r, *args)
    assert k13.launches == before + 1
    out_p = k13.dfe_pass_plain(x, r, *args)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    return out_k


@pytest.mark.gpu
@pytest.mark.parametrize("n_sym", [0, 1, DFE_CHUNK - 1, DFE_CHUNK, DFE_CHUNK + 1,
                                   2 * DFE_CHUNK - 1, 2 * DFE_CHUNK + 1])
def test_kernel_chunk_edges_on_gpu(n_sym):
    dev = require_cuda()
    const = k13.norm_const(4, "pam")
    # at n_sym = 0 the plain version still cuts one window: give it n_ff samples
    x, r, f0, b0 = _gpu_case(dev, const, False, n_b=2, n=n_sym, seed=20, extra=int(n_sym == 0))
    out = _kernel_equals_plain(x, r, const, f0, b0)
    assert out[0].shape == (2, n_sym)


@pytest.mark.gpu
@pytest.mark.parametrize("n_train", [700, DFE_CHUNK, 2 * DFE_CHUNK])
def test_kernel_training_ends_in_or_on_a_chunk_on_gpu(n_train):
    """The reference is staged only for chunks that train; training ends
    inside a chunk or on its boundary (decision-directed after it)."""
    dev = require_cuda()
    const = k13.norm_const(4, "pam")
    x, r, f0, b0 = _gpu_case(dev, const, False, n_b=3, n=2500, seed=21)
    _kernel_equals_plain(x, r, const, f0, b0, n_train=n_train, fulltime=False)


@pytest.mark.gpu
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("extra", [1, 2, 3])
def test_kernel_unaligned_rows_on_gpu(extra, cplx):
    """Rows of odd lengths: a float32 row starts 0, 4, 8 or 12 bytes past a
    16-byte boundary, a complex64 row 0 or 8."""
    dev = require_cuda()
    const = k13.norm_const(16, "qam") if cplx else k13.norm_const(4, "pam")
    x, r, f0, b0 = _gpu_case(dev, const, cplx, n_b=4, n=1500, seed=22, extra=extra)
    _kernel_equals_plain(x, r, const, f0, b0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_b", [1, 8, 33, 132])
def test_kernel_batch_equals_each_signal_alone_on_gpu(n_b):
    dev = require_cuda()
    const = k13.norm_const(4, "pam")
    x, r, f0, b0 = _gpu_case(dev, const, False, n_b=n_b, n=1200, seed=23, extra=1)
    out_b = _kernel_equals_plain(x, r, const, f0, b0)
    for i in range(n_b):
        one = k13.dfe_run(x[i:i + 1].contiguous(), r[i:i + 1].contiguous(), const,
                          f0[i:i + 1], b0[i:i + 1], r.shape[1], 1, 2e-3, 600, True, True)
        for a, b in zip(out_b, one):
            assert torch.equal(a[i:i + 1], b)


@pytest.mark.gpu
@pytest.mark.parametrize("cplx, sps", [(True, 2), (False, 3)])
def test_kernel_window_from_shared_memory_at_sps_above_one_on_gpu(cplx, sps):
    dev = require_cuda()
    const = k13.norm_const(16, "qam") if cplx else k13.norm_const(4, "pam")
    x, r, f0, b0 = _gpu_case(dev, const, cplx, n_b=3, n=2100, n_ff=7, n_fb=3, sps=sps,
                             seed=24, extra=1)
    _kernel_equals_plain(x, r, const, f0, b0, sps=sps)


@pytest.mark.gpu
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n_ff, n_fb", [(1, 0), (1, 16), (32, 0), (32, 16)])
def test_kernel_tap_count_extremes_on_gpu(n_ff, n_fb, cplx):
    dev = require_cuda()
    const = k13.norm_const(16, "qam") if cplx else k13.norm_const(4, "pam")
    x, r, f0, b0 = _gpu_case(dev, const, cplx, n_b=2, n=1500, n_ff=n_ff, n_fb=n_fb, seed=25)
    _kernel_equals_plain(x, r, const, f0, b0, use_fb=n_fb > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["real-levels", "psk8"])
def test_kernel_argmin_slicer_on_gpu(case):
    """The argmin slicer on the real instance (uneven real levels) and on
    the complex one (8-PSK), across chunks."""
    dev = require_cuda()
    const = (np.array([-1.1, -0.3, 0.4, 1.2], np.complex64) if case == "real-levels" else PSK8)
    assert k13.slicer_of(const)[0] == "argmin"
    x, r, f0, b0 = _gpu_case(dev, const, case == "psk8", n_b=3, n=2100, n_ff=7, n_fb=3,
                             seed=26)
    _kernel_equals_plain(x, r, const, f0, b0, n_train=500, fulltime=False)
