"""K16, the adaptive Manakov step's elementwise work (``kernels/ssfm_pass.py``,
``csrc/ssfm_pass.cu``), and its routing in ``models/channels``.

On the CPU: the wrappers refuse what the kernels do not take before
anything is built; a CUDA graph's capture is taken off K16's counts and its
replays put on; the CPU route is the PyTorch ops the solver ran before K16
(an adaptive span written out below gives the same bits) and counts no
fused pass. On the card: each launch against its plain twin (the CPU
route's PyTorch ops, on the card) on random fields and on the benchmark
link's 2^20-sample Tx field, the rotated field, the pass's field and the
convergence number within 1e-6 relative in complex64 (``sincosf`` and
``expf`` against ``torch.exp``, double sums against float ones; the step
size the ops' bits) and 1e-12 in complex128; the step rule as its own
launch (after an all-reduce) the bits of the fused one; two runs
bit-identical; whole links on K16 against the card's PyTorch ops and the
CPU route: the same steps, passes within one a span, fields within 1e-6
relative of the card's PyTorch ops and 1e-4 of the CPU's in complex64
(cuFFT against the CPU's FFTs), 1e-10 of both in complex128; the launches
counted, CUDA graph replays included, the solver's steps and passes times
the launches of each, and ``ssfm.fused_passes`` equal to
``ssfm.trap_iters``.
"""

import importlib.util
import math
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from opticommpy_torch.dsp.equalization import manakov_dbp  # noqa: E402
from opticommpy_torch.kernels import _build  # noqa: E402
from opticommpy_torch.kernels import ssfm_pass  # noqa: E402
from opticommpy_torch.models import SSFMConfig, manakov_ssf  # noqa: E402
from opticommpy_torch.models import channels as tch  # noqa: E402
from opticommpy_torch.utils import profiling  # noqa: E402

from _torch_parity import rel_err, require_cuda  # noqa: E402

GAMMA = 1.3
FS = 512e9
FIBER = dict(Ltotal=250, Lspan=50, alpha=0.2, D=16, gamma=GAMMA, Fc=193.1e12, amp="ideal",
             NF=4.5, maxNlinPhaseRot=0.02, tol=1e-5, maxIter=10)
SOLVERS = {"adaptive": dict(nlprMethod=True, trapIters=0),
           "adaptive, two passes": dict(nlprMethod=True, trapIters=2),
           "fixed, iterated": dict(nlprMethod=False, hz=2.0, trapIters=0)}
REF = (pathlib.Path(__file__).resolve().parents[1] / "portbench" / "reference"
       / "wdm11_16qam_5x50km_nlpr.py")


def _c64(shape, seed, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g)) * scale


def _f32(shape, seed=0):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


E = (2, 1, 8)
BAD_ARGS = {
    "power: CPU tensor": (lambda: ssfm_pass.power_kernel(_c64(E, 1), GAMMA), "CUDA device"),
    "power: complex128": (lambda: ssfm_pass.power_kernel(
        _c64(E, 1).to(torch.complex128), GAMMA, (torch.zeros(()), torch.ones(()), 0.02,
                                                 torch.zeros(2))), "float64"),
    "power: a real field": (lambda: ssfm_pass.power_kernel(_f32(E), GAMMA),
                            "complex64 or complex128"),
    "power: not contiguous": (lambda: ssfm_pass.power_kernel(
        _c64((2, 8, 2), 1).transpose(1, 2), GAMMA), "contiguous"),
    "power: not a (2, B, N) field": (lambda: ssfm_pass.power_kernel(_c64((3, 1, 8), 1), GAMMA),
                                     r"\(2, B, N\)"),
    "power: z of another dtype": (lambda: ssfm_pass.power_kernel(
        _c64(E, 1), GAMMA, (torch.zeros((), dtype=torch.float64), torch.ones(()), 0.02,
                            torch.zeros(2))), "float32"),
    "lin: CPU tensor": (lambda: ssfm_pass.lin_kernel(_c64(E, 1), _c64((8,), 2)), "CUDA device"),
    "lin: operator of another length": (lambda: ssfm_pass.lin_kernel(_c64(E, 1), _c64((9,), 2)),
                                        "shape"),
    "lin: operator and exponent both": (lambda: ssfm_pass.lin_kernel(
        _c64(E, 1), _c64((8,), 2), _c64((8,), 3), torch.ones(())), "give lin_op"),
    "lin: exponent without a step": (lambda: ssfm_pass.lin_kernel(
        _c64(E, 1), lin_arg=_c64((8,), 3)), "tensor"),
    "rotate: CPU tensors": (lambda: ssfm_pass.rotate_kernel(
        _c64(E, 1), _c64(E, 2), _f32((1, 8)), 0.1, GAMMA), "CUDA device"),
    "rotate: e_hd of another shape": (lambda: ssfm_pass.rotate_kernel(
        _c64(E, 1), _c64((2, 1, 9), 2), _f32((1, 8)), 0.1, GAMMA), "shape"),
    "rotate: pch complex": (lambda: ssfm_pass.rotate_kernel(
        _c64(E, 1), _c64(E, 2), _c64((1, 8), 3), 0.1, GAMMA), "float32"),
    "rotate: complex128 with a float32 pch": (lambda: ssfm_pass.rotate_kernel(
        _c64(E, 1).to(torch.complex128), _c64(E, 2).to(torch.complex128), _f32((1, 8)), 0.1,
        GAMMA), "float64"),
    "rotate: pch not contiguous": (lambda: ssfm_pass.rotate_kernel(
        _c64((2, 2, 8), 1), _c64((2, 2, 8), 2), _f32((8, 2)).t(), 0.1, GAMMA), "contiguous"),
    "rotate: sign 2": (lambda: ssfm_pass.rotate_kernel(
        _c64(E, 1), _c64(E, 2), _f32((1, 8)), 0.1, GAMMA, 2.0), "nl_sign"),
    "converge: CPU tensors": (lambda: ssfm_pass.converge_kernel(_c64(E, 1), _c64(E, 2)),
                              "CUDA device"),
    "converge: fields of two shapes": (lambda: ssfm_pass.converge_kernel(
        _c64(E, 1), _c64((2, 2, 8), 2)), "shape"),
    "converge: complex128": (lambda: ssfm_pass.converge_kernel(
        _c64(E, 1).to(torch.complex128), _c64(E, 2)), "complex128"),
    "converge: status of 3": (lambda: ssfm_pass.converge_kernel(
        _c64(E, 1), _c64(E, 2), torch.zeros(3)), "shape"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch, case):
    """A clear error for input K16 does not take, before anything is built
    or launched."""
    def no_build():
        raise AssertionError("built the kernel library")

    monkeypatch.setattr(_build, "load_library", no_build)
    call, match = BAD_ARGS[case]
    before = ssfm_pass.launches
    with pytest.raises(ValueError, match=match):
        call()
    assert ssfm_pass.launches == before


def test_graph_counts_take_the_capture_off_and_each_replay_on():
    """A CUDA graph's capture records K16's launches without running them:
    ``uncounted`` hands them back and leaves the counts as they were, and
    ``replayed`` adds them once a replay."""
    before = ssfm_pass.launches, ssfm_pass.passes

    def capture():  # what a pass's capture records: rotate (a pass), lin, converge
        ssfm_pass._launched(0, "ssfm_rotate_launch", pass_=True)
        ssfm_pass._launched(0, "ssfm_lin_launch")
        ssfm_pass._launched(0, "ssfm_converge_launch")
        return "captured"

    out, made = ssfm_pass.uncounted(capture)
    assert out == "captured" and made == (3, 1)
    assert (ssfm_pass.launches, ssfm_pass.passes) == before
    ssfm_pass.replayed(made, 7)
    assert (ssfm_pass.launches, ssfm_pass.passes) == (before[0] + 21, before[1] + 7)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ssfm_pass._launched(700, "ssfm_rotate_launch", pass_=True)
    assert (ssfm_pass.launches, ssfm_pass.passes) == (before[0] + 21, before[1] + 7)


def _plain_span(e, lin_arg, span_len, cfg, nl_sign):
    """The adaptive span in the PyTorch ops the solver ran before K16,
    written out: (field, steps, passes)."""
    fft = lambda x: torch.fft.fft(x, dim=-1)  # noqa: E731
    ifft = lambda x: torch.fft.ifft(x, dim=-1)  # noqa: E731

    def rot(ex, ey, pch):
        return (8 / 9) * cfg.gamma * (pch + torch.abs(ex) ** 2 + torch.abs(ey) ** 2) / 2

    z = torch.zeros((), dtype=e.real.dtype)
    span_end = torch.tensor(span_len, dtype=e.real.dtype)
    steps = passes = 0
    while bool(z < span_end):
        pch = torch.sum(torch.abs(e) ** 2, dim=0)
        hz_ = torch.minimum(cfg.maxNlinPhaseRot / torch.max(rot(e[0], e[1], pch)), span_end - z)
        lin_op = torch.exp(lin_arg * (hz_ / 2))
        e_hd = ifft(fft(e) * lin_op)
        e_conv, n, lim = e, 0, math.inf
        while n < cfg.maxIter and lim >= cfg.tol:
            phi = rot(e_conv[0], e_conv[1], pch)
            e_fd = ifft(fft(e_hd * torch.exp((nl_sign * 1j) * (phi * hz_))) * lin_op)
            lim = float(torch.sqrt(torch.sum(torch.abs(e_fd - e_conv) ** 2))
                        / torch.sqrt(torch.sum(torch.abs(e_conv) ** 2)))
            e_conv = e_fd
            n += 1
        e = e_conv
        z = z + hz_
        steps, passes = steps + 1, passes + n
    return e, steps, passes


@pytest.mark.parametrize("nl_sign", (1.0, -1.0))
@pytest.mark.parametrize("prec", ("c64", "c128"))
def test_cpu_route_is_the_pytorch_ops(prec, nl_sign):
    """On the CPU the adaptive span runs the PyTorch ops it ran before K16:
    the same bits, steps and passes, and no launch."""
    cfg = SSFMConfig(Fs=FS, prec=prec, **{**FIBER, "Ltotal": 50}, **SOLVERS["adaptive"])
    x = _c64((2**12, 2), 7, 0.2)
    e = tch._to_pol_stacked(x, cfg)
    lin_arg = tch._lin_arg(e.shape[-1], cfg, e.dtype, e.device)
    before = ssfm_pass.launches
    want, steps, passes = _plain_span(e, lin_arg, cfg.Lspan, cfg, nl_sign)
    got, s, p, syncs = tch._span_steps(e, lin_arg, cfg.Lspan, cfg, nl_sign, None)
    assert steps > 3 and torch.equal(got, want) and (s, p) == (steps, passes) and syncs == p
    assert ssfm_pass.launches == before


def _counted(fn, prefix):
    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    c = profiling.counts()
    return out, {k: c.get(f"{prefix}.{k}", 0.0)
                 for k in ("steps", "trap_iters", "host_syncs", "fused_passes")}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_cpu_route_counts_no_fused_pass(solver):
    cfg = SSFMConfig(Fs=FS, **{**FIBER, "Ltotal": 100}, **SOLVERS[solver])
    x = _c64((2**10, 2), 8)
    _, c = _counted(lambda: manakov_ssf(x, cfg), "ssfm")
    assert c["trap_iters"] > 0 and c["fused_passes"] == 0
    _, c = _counted(lambda: manakov_dbp(x, cfg), "dbp")
    assert c["trap_iters"] > 0 and c["fused_passes"] == 0


def test_cpu_convergence_condition_is_the_plain_sums():
    a, b = _c64((2, 3, 100), 1), _c64((2, 3, 100), 2)
    want = (torch.sqrt(torch.sum(torch.abs(a - b) ** 2))
            / torch.sqrt(torch.sum(torch.abs(b) ** 2)))
    assert torch.equal(tch.convergence_condition(a, b), want)


# ---------------------------------------------------------------- on the card

_CACHE = {}


def _wdm(n_ch, n_sym, dev, seed, taps=1024):
    """A 16-QAM polmux WDM Tx field (N, 2) at -2 dBm a channel, 32 GBd,
    SpS 16, 37.5 GHz grid: the benchmark link's Tx
    (``portbench/reference``'s, loaded from its file)."""
    if "ref" not in _CACHE:
        spec = importlib.util.spec_from_file_location("portbench_reference_nlpr_k16", REF)
        _CACHE["ref"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_CACHE["ref"])
    ref = _CACHE["ref"]
    g = torch.Generator().manual_seed(seed)
    symbols = torch.as_tensor(ref.qam16_gray())[torch.randint(0, 16, (n_ch, 2, n_sym),
                                                              generator=g)]
    txc = dict(Rs=32e9, SpS=16, nFilterTaps=taps, pulseRollOff=0.01, powerPerChannel_dBm=-2.0,
               wdmGridSpacing=37.5e9)
    return ref.tx(symbols.to(dev), torch.zeros((n_ch, n_sym * 16), device=dev), txc)


def _link_field(dev):
    """The benchmark link's 11-channel Tx field (2^20 samples) as a (2, 1, N)
    field."""
    if "link" not in _CACHE:
        x = _wdm(11, 2**16, dev, 11)
        _CACHE["link"] = torch.stack([x[:, 0], x[:, 1]])[:, None].contiguous()
    return _CACHE["link"]


FIELDS = ("random (2, 3, 4099)", "random (2, 2, 2^16)", "link (2, 1, 2^20)")


def _field(name, dev):
    if name.startswith("link"):
        return _link_field(dev)
    shape = (2, 3, 4099) if "4099" in name else (2, 2, 2**16)
    return _c64(shape, len(name), 0.3).to(dev)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _k16_step_and_pass(e, cfg, nl_sign):
    """K16's step start and first pass on ``e``, the launches as the solver
    makes them, and the step's start with the step rule as a launch of its
    own (after an all-reduce, here none): every tensor they produce."""
    real = e.real.dtype
    z, z_apart = torch.zeros((), dtype=real, device=e.device), torch.zeros((), dtype=real,
                                                                            device=e.device)
    span_end = torch.full((), 50.0, dtype=real, device=e.device)
    status, status_apart = torch.zeros(2, dtype=real, device=e.device), torch.zeros(
        2, dtype=real, device=e.device)
    lin_arg = tch._lin_arg(e.shape[-1], cfg, e.dtype, e.device)
    pch, hz, lin_op, e_hd = tch._step_start(e, z, span_end, lin_arg, cfg, status)
    _, _, hz_apart = ssfm_pass.power_kernel(
        e, cfg.gamma, (z_apart, span_end, cfg.maxNlinPhaseRot, status_apart), lambda t: None)
    rot = ssfm_pass.rotate_kernel(e, e_hd, pch, hz, cfg.gamma, nl_sign)
    e_fd = tch._trap_pass(e, e_hd, pch, lin_op, hz, cfg.gamma, nl_sign)
    sums = ssfm_pass.converge_kernel(e_fd, e)
    conv = e.clone()
    ssfm_pass.converge_kernel(e_fd, conv, status, write=True)
    return dict(pch=pch, hz=hz, z=z, lin_op=lin_op, e_hd=e_hd, rot=rot, e_fd=e_fd, sums=sums,
                status=status, conv=conv, hz_apart=hz_apart, z_apart=z_apart,
                status_apart=status_apart)


def _check_launches(e, nl_sign, tol, exact_step):
    """K16's step start and pass on ``e`` against their plain twins within
    ``tol`` relative; ``exact_step``: the step size the ops' bits."""
    cfg = SSFMConfig(Fs=FS, prec="c128" if e.dtype == torch.complex128 else "c64", **FIBER,
                     **SOLVERS["adaptive"])
    before = ssfm_pass.launches
    k = _k16_step_and_pass(e, cfg, nl_sign)
    # power, lin (the step's start); power, step (the rule apart); rotate;
    # rotate, lin (a pass); converge twice
    assert ssfm_pass.launches == before + 9
    pch, phi_max = tch._power_plain(e, cfg.gamma)
    hz = torch.minimum(cfg.maxNlinPhaseRot / phi_max, torch.full_like(phi_max, 50.0))
    assert _rel(k["pch"], pch) <= tol and _rel(k["hz"], hz) <= tol
    assert torch.equal(k["hz"], hz) or not exact_step
    assert float(k["z"]) == float(k["hz"]) and k["status"][1].item() == 1.0
    assert torch.equal(k["hz_apart"], k["hz"]) and torch.equal(k["z_apart"], k["z"])
    assert k["status_apart"][1].item() == 1.0
    lin_arg = tch._lin_arg(e.shape[-1], cfg, e.dtype, e.device)
    lin_op = torch.exp(lin_arg * (k["hz"] / 2))
    assert _rel(k["lin_op"], lin_op) <= tol
    e_hd = tch._ifft(tch._fft(e) * lin_op)
    assert _rel(k["e_hd"], e_hd) <= tol
    args = (e, k["e_hd"], k["pch"], k["hz"], cfg.gamma, nl_sign)
    rot = tch._rotate_plain(*args)
    assert _rel(k["rot"], rot) <= tol
    e_fd = tch._ifft(tch._fft(rot) * k["lin_op"])
    assert _rel(k["e_fd"], e_fd) <= tol
    num, den = tch._converge_sums_plain(k["e_fd"], e)
    assert _rel(k["sums"], torch.stack([num, den])) <= tol
    lim = torch.sqrt(num) / torch.sqrt(den)
    assert abs(k["status"][0].item() - lim.item()) <= tol * lim.item()
    assert torch.equal(k["conv"], k["e_fd"])
    # the same pass again: the same bits
    again = _k16_step_and_pass(e, cfg, nl_sign)
    assert all(torch.equal(k[name], again[name]) for name in k)


@pytest.mark.gpu
@pytest.mark.parametrize("nl_sign", (1.0, -1.0))
@pytest.mark.parametrize("field", FIELDS)
def test_each_launch_matches_its_plain_twin_on_gpu(field, nl_sign):
    dev = require_cuda()
    _check_launches(_field(field, dev), nl_sign, 1e-6, exact_step=True)


@pytest.mark.gpu
@pytest.mark.parametrize("field", FIELDS)
def test_each_launch_matches_its_plain_twin_in_complex128_on_gpu(field):
    """The complex128 instance: a complex128 field on the card runs K16
    too, within 1e-12 of the card's complex128 PyTorch ops."""
    dev = require_cuda()
    _check_launches(_field(field, dev).to(torch.complex128), -1.0, 1e-12, exact_step=False)


@pytest.mark.gpu
def test_fixed_step_size_and_unaligned_fields_on_gpu():
    """A step size given as a number (the fixed-step route) and fields whose
    rows do not pair into 16-byte loads take the one-value instance."""
    dev = require_cuda()
    for shape in ((2, 1, 1001), (2, 3, 7)):
        e = _c64(shape, 3, 0.5).to(dev)
        e_hd = _c64(shape, 4, 0.5).to(dev)
        pch = torch.sum(torch.abs(e) ** 2, dim=0)
        got = ssfm_pass.rotate_kernel(e, e_hd, pch, 0.25, GAMMA, -1.0)
        assert _rel(got, tch._rotate_plain(e, e_hd, pch, 0.25, GAMMA, -1.0)) <= 1e-6
        lin_op = torch.exp(1j * _f32(shape[-1:], 5).to(dev) * 40.0)
        spec = _c64(shape, 6).to(dev)
        want = spec * lin_op / shape[-1]
        assert ssfm_pass.lin_kernel(spec, lin_op) is lin_op and _rel(spec, want) <= 1e-6
    # an odd view offset: not 16-byte aligned
    base = _c64((2 * 4096 + 1,), 7).to(dev)
    e, conv = base[1:].reshape(2, 1, 4096), _c64((2, 1, 4096), 8).to(dev)
    num, den = tch._converge_sums_plain(e, conv)
    assert _rel(ssfm_pass.converge_kernel(e, conv), torch.stack([num, den])) <= 1e-6


LINK_CASES = {"adaptive": ("adaptive", "ssfm"), "adaptive, two passes":
              ("adaptive, two passes", "ssfm"), "fixed, iterated": ("fixed, iterated", "ssfm"),
              "backpropagation": ("adaptive", "dbp")}


# K16's launches a step's start and a pass: (power, lin), (rotate, lin,
# converge); with two fixed passes no converge; the fixed step's start
# forms its power with the PyTorch ops
LAUNCHES = {"adaptive": (2, 3), "adaptive, two passes": (2, 2), "fixed, iterated": (1, 3),
            "backpropagation": (2, 3)}


def _link_run(case, x, route=None, prec="c64"):
    """``case`` of LINK_CASES on ``x``: five spans of 50 km with ideal gain
    (no noise, so every route sees the same field), or one span of
    backpropagation; ``route="ops"`` runs the card's PyTorch ops in the
    eager loop, as the solver did before K16. (output, counts)."""
    solver, prefix = LINK_CASES[case]
    n_spans = 1 if prefix == "dbp" else 5
    cfg = SSFMConfig(Fs=FS, prec=prec, **{**FIBER, "Ltotal": 50 * n_spans}, **SOLVERS[solver])
    fn = manakov_dbp if prefix == "dbp" else manakov_ssf
    if route != "ops":
        return _counted(lambda: fn(x, cfg), prefix)
    k16, graphs = tch._k16, tch._use_graphs
    tch._k16, tch._use_graphs = (lambda e: False), (lambda *args: False)
    try:
        return _counted(lambda: fn(x, cfg), prefix)
    finally:
        tch._k16, tch._use_graphs = k16, graphs


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(LINK_CASES))
def test_links_on_k16_match_the_cpu_route_on_gpu(case):
    """Three WDM channels of the benchmark link's Tx (2^14 samples, -2 dBm
    a channel) on K16, on the card's PyTorch ops and on the CPU: the same
    steps, passes within one a span, K16's field within 1e-6 relative of
    the card's PyTorch ops and within 1e-4 of the CPU's (the port's bound
    for the solver on the card against the CPU on this three-channel
    field: cuFFT against the CPU's FFTs reads 2e-5 to 4e-5 over five spans,
    on either route). The bound holds for this field alone: eleven
    channels of 4,096 symbols read 1.4e-2 on the adaptive solver, on K16
    and on the card's PyTorch ops alike, because that link is
    ill-conditioned in float32 (on the CPU alone an input changed by one
    ulp moves its output by 1.2e-2). Every pass on the card a K16 pass,
    and K16's launches, CUDA graph replays counted, the steps' and passes'
    launches."""
    dev = require_cuda()
    n_spans = 1 if LINK_CASES[case][1] == "dbp" else 5
    x = _wdm(3, 2**10, torch.device("cpu"), 5, taps=256)
    before = ssfm_pass.launches
    got, c_gpu = _link_run(case, x.to(dev))
    per_step, per_pass = LAUNCHES[case]
    assert ssfm_pass.launches - before == per_step * c_gpu["steps"] + per_pass * c_gpu[
        "trap_iters"]
    ops, c_ops = _link_run(case, x.to(dev), "ops")
    want, c_cpu = _link_run(case, x)
    for c in (c_ops, c_cpu):
        assert c_gpu["steps"] == c["steps"] and c_gpu["steps"] > 5 * n_spans
        assert abs(c_gpu["trap_iters"] - c["trap_iters"]) <= n_spans
    assert c_gpu["fused_passes"] == c_gpu["trap_iters"]
    assert c_ops["fused_passes"] == c_cpu["fused_passes"] == 0
    assert rel_err(got, ops) <= 1e-6, rel_err(got, ops)
    assert rel_err(got, want) <= 1e-4, (rel_err(got, want), rel_err(ops, want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("adaptive", "fixed, iterated"))
def test_complex128_links_on_k16_match_the_cpu_route_on_gpu(case):
    """The link test's three channels in complex128: K16's complex128
    instance on the card (CUDA graphs for the adaptive span, the eager
    loop for the fixed step), the card's complex128 PyTorch ops and the
    CPU's: the same steps, passes within one a span, the fields within
    1e-10 relative; every pass a K16 pass. (Backpropagation runs in
    complex64 whatever the configuration's precision.)"""
    dev = require_cuda()
    n_spans = 1 if LINK_CASES[case][1] == "dbp" else 5
    x = _wdm(3, 2**10, torch.device("cpu"), 5, taps=256).to(torch.complex128)
    before = ssfm_pass.launches
    got, c_gpu = _link_run(case, x.to(dev), prec="c128")
    per_step, per_pass = LAUNCHES[case]
    assert ssfm_pass.launches - before == per_step * c_gpu["steps"] + per_pass * c_gpu[
        "trap_iters"]
    assert got.dtype == torch.complex128 and got.is_cuda
    ops, c_ops = _link_run(case, x.to(dev), "ops", prec="c128")
    want, c_cpu = _link_run(case, x, prec="c128")
    for c in (c_ops, c_cpu):
        assert c_gpu["steps"] == c["steps"] and c_gpu["steps"] > 5 * n_spans
        assert abs(c_gpu["trap_iters"] - c["trap_iters"]) <= n_spans
    assert c_gpu["fused_passes"] == c_gpu["trap_iters"] and c_cpu["fused_passes"] == 0
    assert rel_err(got, ops) <= 1e-10, rel_err(got, ops)
    assert rel_err(got, want) <= 1e-10, (rel_err(got, want), rel_err(ops, want))
