"""The port's own spans and counters (opticommpy_torch.utils.profiling):
nothing is recorded without a profiler; under ``torch.profiler`` the
receiver chain opens its ``pb.<name>`` ranges, nested as documented, and
the LDPC decoder counts its codewords and the iterations they ran."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from opticommpy_torch.comm.fec import LDPCConfig, decode_ldpc, standard_ldpc  # noqa: E402
from opticommpy_torch.comm.fec_qc import make_qc_decoder  # noqa: E402
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
