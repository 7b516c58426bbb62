"""The adaptive-solver link cell ``wdm11nlpr.link`` (mix ``link_rx``) at a
small size on the CPU: a sound run reads correct and, traced, the solver's
counters; the control (the reference computed in bfloat16) and a fault
(the fibre left out: the state unchanged) read not correct; its files are
found by name, and the new readers read nothing where the program counts
nothing (the parent of the counters)."""

import time

import pytest
import torch

from harness import core

CELL = "wdm11nlpr.link"
# the small size's limits: 3 channels, 4096 symbols, 2 spans (conftest's
# LINK_LIMITS, with the BER and the receiver's whole-output gap held too)
SMALL_LIMITS = {"ber_gap": 1e-4, "gmi_gap": 2e-05, "train_gap": 1e-3, "y_gap_med": 0.02,
                "snr_gap_med": 0.5, "snr_gap_max": 0.6}
NEW_READERS = ("ssfm_steps.link", "trap_iters.link", "ssfm_syncs.link", "ssfm_nlpr_roofline.link")


def _run(trace=0, control=False):
    import run
    from conftest import small_wdm

    torch.set_num_threads(4)
    cfg = small_wdm(core.cell(core.benchmark(), CELL)["config"])
    trf = core.traffic("link_rx")
    trf["trace_units"] = 1
    return run.execute(CELL, 2**32 + 11, 0.5, trace, torch.device("cpu"), time.perf_counter(),
                       control=control, cfg=cfg, trf=trf, limits=SMALL_LIMITS)


def test_sound_traced_run_is_correct_and_reads_the_solver():
    from opticommpy_torch.utils.profiling import reset_counts

    reset_counts()
    res = _run(trace=1)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(SMALL_LIMITS)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert {"tx_ms.link", "ssfm_ms.link", "rx_front_ms.link", "dsp_ms.link",
            "score_ms.link"} <= set(m)
    # one read a pass: its convergence number and whether a step follows
    assert m["ssfm_steps.link"] > 2 and m["trap_iters.link"] >= 1
    assert m["ssfm_syncs.link"] == pytest.approx(m["ssfm_steps.link"] * m["trap_iters.link"])
    # device metrics come from a device trace: nothing on the CPU
    assert not any(k.startswith(("device_idle", "ssfm_dev")) or "roofline" in k for k in m)


def test_untraced_run_reports_the_received_symbols():
    res = _run()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"rx_msym_s", "setup_s"}


def test_control_is_not_correct():
    res = _run(control=True)
    assert not res["correct"], res["checks"]


def test_fibre_left_out_is_not_correct(monkeypatch):
    import opticommpy_torch.models as models

    monkeypatch.setattr(models, "manakov_ssf", lambda e, cfg, gen=None: e)
    res = _run()
    assert not res["correct"], res["checks"]


def test_the_cells_files_are_found_by_name():
    bench = core.benchmark()
    w = core.cell(bench, CELL)
    cfg = core.config(w["config"])
    assert cfg["name"] == w["config"] and cfg["fiber"]["nlprMethod"]
    assert core.traffic(w["traffic"])["kind"] == "link_rx"
    assert callable(core.mix("link_rx").compare)
    assert set(core.limits(CELL)) == set(SMALL_LIMITS)
    assert callable(core.reference(cfg["name"]).manakov)
    assert [m["name"] for m in core.e2e_metrics(bench, CELL)] == ["rx_msym_s", "setup_s"]
    names = {m["name"] for m in core.layer_metrics(bench, CELL)}
    assert set(NEW_READERS) | {"ssfm_dev_ms.link", "device_idle.link"} <= names
    assert "ssfm_roofline.link" not in names  # its fixed-step count does not hold here


def test_new_readers_read_nothing_without_the_programs_counters():
    from opticommpy_torch.utils.profiling import reset_counts

    ctx = core.Ctx(CELL, core.config("wdm11_16qam_5x50km_nlpr"), {}, 0, torch.device("cpu"))
    tr = {"range_calls": {"ssfm": 2}, "range_dev_s": {"ssfm": 2.0}}
    reset_counts()
    for name in NEW_READERS:
        assert core.reader(name)(ctx, None, tr) is None, name


def test_roofline_counts_the_fft_pairs_of_steps_and_passes():
    from torch.profiler import ProfilerActivity, profile

    from opticommpy_torch.utils.profiling import count, reset_counts

    ctx = core.Ctx(CELL, core.config("wdm11_16qam_5x50km_nlpr"), {}, 0, torch.device("cpu"))
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            count("ssfm.calls", 1)
            count("ssfm.steps", 400)
            count("ssfm.trap_iters", 1200)
    # 1600 FFT pairs of 2 polarizations, 2^20 samples: 4 x 1600 x 5 x 2^20 x 20 flops
    flops = 4 * 1600 * 5 * 2**20 * 20
    tr = {"range_calls": {"ssfm": 2}, "range_dev_s": {"ssfm": 2 * flops / 67e12 * 50}}
    assert core.reader("ssfm_nlpr_roofline.link")(ctx, None, tr) == pytest.approx(2.0)
    reset_counts()
