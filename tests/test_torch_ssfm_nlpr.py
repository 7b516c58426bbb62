"""The port's adaptive-step Manakov solver (``manakov_ssf`` with
``nlprMethod=True``, trapezoid iterated to ``tol``) against the benchmark's
plain reference of OptiCommPy's ``manakovSSF``
(``portbench/reference/wdm11_16qam_5x50km_nlpr.py``, loaded from its file).

A 3-channel 16-QAM polmux WDM field (the reference's Tx, 0 dBm a channel,
2^14 samples at 512 GHz) through 2 spans of 50 km with ideal amplifiers,
so neither side draws noise. The port's steps and trapezoidal passes
(its ``ssfm.*`` counters) equal the reference's exactly, and its field is
within ``TOL`` of the reference's. ``TOL``: the two round in float32
differently (the reference forms its linear operators in float64), over
~170 FFT pairs; 5.4e-6 is read. The fixed 0.5 km step (one trapezoidal
pass, merged linear half-steps) misses it by 150x, the reference computed
in bfloat16 by 250x. The loop reads the device once a trapezoidal pass
(the convergence number with whether another step follows); the loop
that read ``z < span`` on its own each step gives the same bits, and so
does, on the card, the loop that replays CUDA graphs of the same work.
"""

import importlib.util
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from opticommpy_torch.models import SSFMConfig, manakov_ssf  # noqa: E402
from opticommpy_torch.models import channels as tch  # noqa: E402
from opticommpy_torch.utils import profiling  # noqa: E402

from _torch_parity import rel_err  # noqa: E402

REF = (pathlib.Path(__file__).resolve().parents[1] / "portbench" / "reference"
       / "wdm11_16qam_5x50km_nlpr.py")
TOL = 1e-4
FS = 512e9
FIBER = dict(Ltotal=100, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fc=193.1e12, amp="ideal", NF=4.5,
             maxNlinPhaseRot=0.02, tol=1e-5, maxIter=10)
SOLVERS = {"adaptive": dict(nlprMethod=True, trapIters=0),
           "fixed step": dict(nlprMethod=False, hz=0.5, trapIters=1, fusedLinear=True)}


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("portbench_reference_wdm11_16qam_5x50km_nlpr",
                                                  REF)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    g = torch.Generator().manual_seed(5)
    n_sym = 2**14 // 16
    symbols = torch.as_tensor(ref.qam16_gray())[torch.randint(0, 16, (3, 2, n_sym), generator=g)]
    txc = dict(Rs=32e9, SpS=16, nFilterTaps=256, pulseRollOff=0.01, powerPerChannel_dBm=0.0,
               wdmGridSpacing=37.5e9)
    x = ref.tx(symbols, torch.zeros((3, n_sym * 16)), txc)
    out, steps, passes = ref.manakov(x, FIBER, FS, None)
    return ref, x, out, steps, passes


def _port(x, solver):
    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        out = manakov_ssf(x, SSFMConfig(Fs=FS, **FIBER, **SOLVERS[solver]))
    return out, profiling.counts()


@pytest.mark.parametrize("case", ("adaptive", "fixed step", "bf16 reference"))
def test_adaptive_solver_matches_the_plain_reference(reference, case):
    ref, x, want, steps, passes = reference
    assert steps > 2 and passes >= steps
    if case == "bf16 reference":
        got, _, _ = ref.manakov(x, FIBER, FS, None, ref.bf16)
        assert rel_err(got, want) > TOL
        return
    got, c = _port(x, case)
    if case == "fixed step":
        assert rel_err(got, want) > TOL
        return
    assert rel_err(got, want) <= TOL, rel_err(got, want)
    assert c["ssfm.calls"] == 1
    assert (c["ssfm.steps"], c["ssfm.trap_iters"]) == (steps, passes)


def _span_reading_z_each_step(e, lin_arg, span_len, cfg):
    """The adaptive span as it read ``z < span`` on its own before each
    step and each convergence number on its own: (field, steps, passes)."""
    z = torch.zeros((), dtype=e.real.dtype)
    span_end = torch.tensor(span_len, dtype=e.real.dtype)
    steps = passes = 0
    while bool(z < span_end):
        pch = torch.sum(torch.abs(e) ** 2, dim=0)
        hz_ = torch.minimum(cfg.maxNlinPhaseRot
                            / torch.max(tch.nlin_phase_rot(e[0], e[1], pch, cfg.gamma)),
                            span_end - z)
        e, n_it, _ = tch._manakov_step(e, pch, torch.exp(lin_arg * (hz_ / 2)), hz_, cfg)
        z = z + hz_
        steps, passes = steps + 1, passes + n_it
    return e, steps, passes


@pytest.mark.parametrize("prec", ("c64", "c128"))
def test_one_read_a_pass_gives_the_same_bits(reference, prec):
    _, x, _, _, _ = reference
    one_span = {**FIBER, "Ltotal": 50, "amp": "none"}
    cfg = SSFMConfig(Fs=FS, prec=prec, **one_span, **SOLVERS["adaptive"])
    e = tch._to_pol_stacked(x, cfg)
    lin_arg = tch._lin_arg(e.shape[-1], cfg, e.dtype, e.device)
    want, steps, passes = _span_reading_z_each_step(e, lin_arg, cfg.Lspan, cfg)
    got, s, p, syncs = tch._span_steps(e, lin_arg, cfg.Lspan, cfg, 1.0, None)
    assert torch.equal(got, want) and (s, p) == (steps, passes) and syncs == passes


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("span", "backpropagation", "link with EDFAs"))
def test_cuda_graphs_give_the_eager_loops_bits(reference, monkeypatch, case):
    """On the card the adaptive loop replays CUDA graphs (``_StepGraphs``);
    the field, the steps and the passes are the eager loop's bits, on the
    call that captures the graphs and on the next, which replays them on
    other values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, x, _, _, _ = reference
    x = x.cuda()
    if case == "link with EDFAs":
        cfg = SSFMConfig(Fs=FS, **{**FIBER, "amp": "edfa"}, **SOLVERS["adaptive"])

        def run(xi):
            profiling.reset_counts()
            with profile(activities=[ProfilerActivity.CPU]):
                out = manakov_ssf(xi, cfg, torch.Generator("cuda").manual_seed(7))
            c = profiling.counts()
            return out, c["ssfm.steps"], c["ssfm.trap_iters"], c["ssfm.host_syncs"]
    else:
        cfg = SSFMConfig(Fs=FS, **{**FIBER, "Ltotal": 50, "amp": "none"}, **SOLVERS["adaptive"])
        nl_sign = 1.0 if case == "span" else -1.0

        def run(xi):
            e = tch._to_pol_stacked(xi, cfg)
            lin_arg = tch._lin_arg(e.shape[-1], cfg, e.dtype, e.device)
            return tch._span_steps(e, lin_arg, cfg.Lspan, cfg, nl_sign, None)

    inputs = (x, x * 1.25)
    got = [run(xi) for xi in inputs]
    assert tch._use_graphs(tch._to_pol_stacked(x, cfg), cfg, None)
    monkeypatch.setattr(tch, "_use_graphs", lambda *args: False)
    for xi, g in zip(inputs, got):
        want = run(xi)
        assert torch.equal(g[0], want[0]) and g[1:] == want[1:], (g[1:], want[1:])
