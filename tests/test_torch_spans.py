"""The port's own spans and counters (opticommpy_torch.utils.profiling):
nothing is recorded without a profiler; under ``torch.profiler`` the
receiver chain opens its ``pb.<name>`` ranges, nested as documented, the
LDPC decoder counts its codewords and the iterations they ran, and the
Manakov solver counts its calls, steps, trapezoidal passes and
synchronizing reads and labels its spans for the host only."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from opticommpy_torch.comm.fec import LDPCConfig, decode_ldpc, standard_ldpc  # noqa: E402
from opticommpy_torch.comm.fec_qc import make_qc_decoder  # noqa: E402
from opticommpy_torch.models import SSFMConfig, manakov_ssf  # noqa: E402
from opticommpy_torch.pipelines import CoherentDSPConfig, coherent_dsp_chain_batch  # noqa: E402
from opticommpy_torch.utils import profiling  # noqa: E402

from _torch_parity import zero_codeword_llrs  # noqa: E402

RX_STAGES = ("rx.front_end", "rx.equalizer", "rx.bps", "rx.unwrap")
FRONT_CHILDREN = ("rx.front_end.filter", "rx.front_end.edc", "rx.front_end.foe")
B = 2


def _chain_inputs(n_sym=1024, sps=4, seed=3):
    rng = np.random.default_rng(seed)
    shape = (B, n_sym * sps, 2)
    sig = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ref = np.exp(0.5j * np.pi * rng.integers(0, 4, (B, n_sym, 2))).astype(np.complex64)
    cfg = CoherentDSPConfig(SpS_in=sps, nFilterTaps=64, L=50, nTrain=300, mu=(2e-3,))
    return torch.from_numpy(sig), torch.from_numpy(ref), cfg


def _ranges(prof):
    """{name: [(start, end, annotates the device), ...]} of the profiled
    ``pb.`` ranges."""
    out = {}
    for e in prof.events():
        if e.name.startswith(profiling.SPAN_PREFIX):
            out.setdefault(e.name[len(profiling.SPAN_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end, e.is_user_annotation))
    return out


def _inside(inner, outer):
    return all(any(s0 <= s and e <= e0 for s0, e0, _ in outer) for s, e, _ in inner)


def _device(ranges):
    """Whether every call of a span annotates the device (a user range)."""
    return {bool(d) for _, _, d in ranges}


def _llrs_and_graph():
    graph, _ = standard_ldpc("DVBS2", 64800, "4/5")
    return torch.as_tensor(zero_codeword_llrs(11, (7.0, 5.0, 3.0))), graph


@pytest.fixture(scope="module")
def chain():
    return _chain_inputs()


def test_off_without_a_profiler_records_nothing(chain):
    before = profiling.counts()
    with profiling.span("rx.test"):
        profiling.count("test.off", 5)
        profiling.count("test.off", torch.ones(3))
    coherent_dsp_chain_batch(*chain)
    assert profiling.counts() == before
    assert profiling.span("a") is profiling.span("b")  # one shared no-op


def test_count_sums_numbers_and_tensors_under_a_profiler():
    before = profiling.counts().get("test.on", 0.0)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("test.on", 2)
        profiling.count("test.on", torch.tensor([1, 2, 3], dtype=torch.int32))
    assert profiling.counts()["test.on"] == before + 8.0


def test_trace_starts_the_counters_from_zero(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("test.reset", 7)
    with profiling.trace(str(tmp_path)):
        profiling.count("test.reset", 2)
    assert profiling.counts()["test.reset"] == 2.0
    profiling.reset_counts()
    assert profiling.counts() == {}


def test_chain_spans_are_nested_and_counted(chain):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        coherent_dsp_chain_batch(*chain)
    r = _ranges(prof)
    for name in RX_STAGES:
        assert len(r.get(name, [])) == 1, (name, r.keys())
        assert _device(r[name]) == {True}
    for name in FRONT_CHILDREN:
        assert len(r.get(name, [])) == B, (name, r.keys())
        assert _inside(r[name], r["rx.front_end"])
        assert _device(r[name]) == {False}  # the front end's device time stays whole
    top = [r[n][0] for n in RX_STAGES]
    assert all(e0 <= s1 for (_, e0, _), (s1, _, _) in zip(top, top[1:]))  # in turn


def test_decode_spans_and_counters_match_the_decoders_iterations():
    llrs, graph = _llrs_and_graph()
    cfg = LDPCConfig(maxIter=6, alg="NMSA", msgDtype="bf16", earlyExit=True)
    _, n_iters, _ = make_qc_decoder(64800, "4/5", 6, "NMSA", "bf16", True)(llrs)
    before = profiling.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decode_ldpc(llrs, config=cfg, graph=graph)
    after = profiling.counts()
    # the decoder opens no range of its own, so a caller's range stays the
    # innermost one of every decode kernel
    assert _ranges(prof) == {}
    assert after["fec.codewords"] - before.get("fec.codewords", 0.0) == llrs.shape[1]
    got = after["fec.codeword_iters"] - before.get("fec.codeword_iters", 0.0)
    assert got == float(n_iters.sum()) and 0 < got < 6 * llrs.shape[1]


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path, chain):
    with profiling.trace(str(tmp_path)):
        coherent_dsp_chain_batch(*chain)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    for name in RX_STAGES + FRONT_CHILDREN:
        assert profiling.SPAN_PREFIX + name in names


SSFM_COUNTERS = ("ssfm.calls", "ssfm.steps", "ssfm.trap_iters", "ssfm.host_syncs")
SOLVERS = {  # 2 spans of 50 km; the fixed paths take 25 steps a span
    "adaptive": dict(nlprMethod=True, trapIters=0),
    "adaptive, two passes": dict(nlprMethod=True, trapIters=2),
    "fixed, fused": dict(nlprMethod=False, hz=2.0, trapIters=1, fusedLinear=True),
    "fixed, iterated": dict(nlprMethod=False, hz=2.0, trapIters=0),
    "fixed, two passes": dict(nlprMethod=False, hz=2.0, trapIters=2),
}


def _ssfm(**kw):
    rng = np.random.default_rng(4)
    x = 0.05 * (rng.standard_normal((2**10, 2)) + 1j * rng.standard_normal((2**10, 2)))
    cfg = SSFMConfig(Ltotal=100, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fs=256e9, amp="ideal",
                     **kw)
    return torch.from_numpy(x.astype(np.complex64)), cfg


def _ssfm_counts(before, after):
    return {k: after.get(k, 0.0) - before.get(k, 0.0) for k in SSFM_COUNTERS}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_manakov_ssf_counts_steps_passes_and_syncs(solver):
    x, cfg = _ssfm(**SOLVERS[solver])
    before = profiling.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        manakov_ssf(x, cfg)
    c = _ssfm_counts(before, profiling.counts())
    spans = 2
    assert c["ssfm.calls"] == 1
    if cfg.nlprMethod and not cfg.trapIters:
        assert c["ssfm.steps"] > spans and c["ssfm.trap_iters"] >= c["ssfm.steps"]
        # one read a pass: its convergence number and whether a step follows
        assert c["ssfm.host_syncs"] == c["ssfm.trap_iters"]
    elif cfg.nlprMethod:
        assert c["ssfm.trap_iters"] == cfg.trapIters * c["ssfm.steps"]
        assert c["ssfm.host_syncs"] == c["ssfm.steps"]  # whether a step follows, a step
    else:
        assert c["ssfm.steps"] == spans * 25
        if cfg.trapIters:
            assert c["ssfm.trap_iters"] == cfg.trapIters * c["ssfm.steps"]
            assert c["ssfm.host_syncs"] == 0
        else:
            assert c["ssfm.trap_iters"] >= c["ssfm.steps"]
            assert c["ssfm.host_syncs"] == c["ssfm.trap_iters"]
    # host-only labels: a caller's device range keeps every kernel of the call
    r = _ranges(prof)
    assert {k for k in r if k.startswith("ssfm")} == {"ssfm.span", "ssfm.amplifier"}
    for name in ("ssfm.span", "ssfm.amplifier"):
        assert len(r[name]) == spans and _device(r[name]) == {False}


def test_manakov_ssf_without_a_profiler_counts_nothing():
    x, cfg = _ssfm(**SOLVERS["adaptive"])
    before = profiling.counts()
    out = manakov_ssf(x, cfg)
    assert profiling.counts() == before
    with profile(activities=[ProfilerActivity.CPU]):
        traced = manakov_ssf(x, cfg)
    assert torch.equal(out, traced)  # counting leaves the arithmetic alone
