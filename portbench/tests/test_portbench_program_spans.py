"""The readers of the program's own spans and counters (``gap_ms``,
``range_less_kernel_ms``, ``count_ratio``) on hand-built trace summaries,
and the counter read in a traced decode run on the CPU."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from harness import core

RX_CALLS = {"dsp": 2, "rx.front_end": 2, "rx.front_end.filter": 22, "rx.front_end.edc": 22,
            "rx.equalizer": 2, "rx.bps": 2, "rx.unwrap": 2}


def _rx_trace(gaps, calls=RX_CALLS):
    # 2 units: 0.06 s busy a unit under the profiler, 0.1 s a unit without
    # it (0.04 s true idle a unit); the profiled window holds 0.1 s of idle
    return {"busy_s": 0.12, "units": 2, "unit_wall_s": 0.1, "window_s": 0.22,
            "idle_gaps": gaps, "range_calls": dict(calls), "range_dev_s": {}}


def gap_ms(tr, *names):
    mod = core._load(f"{core.HERE}/readers/gap_ms.py", "portbench_reader_gap_ms")
    return mod.read(None, None, tr, *names)


def test_gap_ms_sums_a_range_and_its_children_rescaled():
    gaps = [["pb.rx.front_end.edc", 0.03], ["pb.rx.front_end", 0.01],
            ["pb.rx.front_end.filter", 0.01], ["pb.rx.unwrap", 0.02], ["pb.dsp", 0.02],
            ["pb.rx.front_endless", 0.005], ["outside any layer", 0.005]]
    tr = _rx_trace(gaps)
    # the front end's 0.05 s of the 0.1 s profiled idle: half of 40 ms a unit
    assert gap_ms(tr, "rx.front_end") == pytest.approx(20.0)
    assert gap_ms(tr, "rx.bps", "rx.unwrap") == pytest.approx(8.0)
    # through the metric's own file and arguments
    assert core.reader("front_idle_ms.rx")(None, None, tr) == pytest.approx(20.0)
    assert core.reader("carrier_idle_ms.rx")(None, None, tr) == pytest.approx(8.0)
    total = sum(gap_ms(tr, n) for n in ("rx.front_end", "rx.equalizer", "rx.bps", "rx.unwrap",
                                        "dsp"))
    assert total <= 40.0


def test_gap_ms_true_idle_is_clamped_at_zero():
    tr = _rx_trace([["pb.rx.unwrap", 0.02]])
    tr["unit_wall_s"] = 0.05  # faster than the profiled busy time: no idle to share
    assert gap_ms(tr, "rx.unwrap") == 0.0


def test_gap_ms_zero_for_a_range_without_gaps_in_a_short_list():
    tr = _rx_trace([["pb.rx.unwrap", 0.02], ["pb.dsp", 0.01]])
    assert gap_ms(tr, "rx.equalizer") == 0.0


def test_gap_ms_none_for_a_full_list():
    gaps = [[f"pb.rx.stage{i}", 0.001] for i in range(9)] + [["pb.rx.unwrap", 0.02]]
    assert gap_ms(_rx_trace(gaps), "rx.unwrap") is None


def test_gap_ms_none_where_the_program_has_no_such_range():
    # a program without the spans: only the mix's own range
    tr = _rx_trace([["pb.dsp", 0.1]], calls={"dsp": 2})
    for metric in ("front_idle_ms.rx", "eq_idle_ms.rx", "carrier_idle_ms.rx"):
        assert core.reader(metric)(None, None, tr) is None, metric
    tr = _rx_trace([])
    tr["busy_s"] = 0.0  # no device trace
    assert gap_ms(tr, "rx.front_end") is None


def test_range_less_kernel_ms_takes_off_the_kernel_by_name():
    tr = {"range_calls": {"decode": 4},
          "range_dev_s": {"decode": 0.036, "decodex": 1.0},
          "kernel_s": {"void qc_mega_flood_kernel<bf16, 18>(MegaArgs)": 0.032,
                       "elementwise_kernel": 0.003}}
    assert core.reader("fec_glue_ms.decode")(None, None, tr) == pytest.approx(1.0)
    read = core._load(f"{core.HERE}/readers/range_less_kernel_ms.py",
                      "portbench_reader_range_less_kernel_ms").read
    assert read(None, None, tr, "decode", "elementwise") == pytest.approx(8.25)
    # no such kernel, or no device trace (the CPU)
    assert read(None, None, tr, "decode", "qc_mega_layered") is None
    tr["range_dev_s"] = {}
    assert core.reader("fec_glue_ms.decode")(None, None, tr) is None


def test_count_ratio_of_the_programs_counters():
    from opticommpy_torch.utils.profiling import count

    read = core._load(f"{core.HERE}/readers/count_ratio.py", "portbench_reader_count_ratio").read
    with profile(activities=[ProfilerActivity.CPU]):
        count("pbtest.iters", torch.tensor([3, 4, 5, 8], dtype=torch.int32))
        count("pbtest.cw", 4)
        count("pbtest.zero", 0)
    assert read(None, None, {}, "pbtest.iters", "pbtest.cw") == pytest.approx(5.0)
    assert read(None, None, {}, "pbtest.iters", "pbtest.zero") is None
    assert read(None, None, {}, "pbtest.iters", "pbtest.never") is None
    assert read(None, None, {}, "pbtest.never", "pbtest.cw") is None


def test_traced_decode_run_counts_iterations_per_codeword(cpu_run, monkeypatch):
    from opticommpy_torch.utils.profiling import reset_counts

    seen, reader = {}, core.reader

    def keep_state(metric):
        read = reader(metric)

        def go(ctx, state, tr):
            seen["state"], seen["units"] = state, tr["units"]
            return read(ctx, state, tr)
        return go

    monkeypatch.setattr(core, "reader", keep_state)
    reset_counts()  # what earlier profiles in this process counted
    res = cpu_run("dvbs2.decode", trace=1)
    assert res["correct"], res["checks"]
    iters = res["metrics"]["cw_iters.decode"]
    assert iters["unit"] == "iterations"
    # the reference decoder's iterations on the profiled units' own batches
    st = seen["state"]
    per = [int(i) for p in st.order[-seen["units"]:] for i in st.ref_iters[p].tolist()]
    assert iters["value"] == pytest.approx(sum(per) / len(per), rel=1e-2)
    # device times come from a device trace: nothing on the CPU
    assert "fec_glue_ms.decode" not in res["metrics"]
