"""Shared fixtures of the benchmark's own tests (run with ``pytest
portbench/tests`` from the root of the checkout). CPU tests run the
program's plain kernel versions at small sizes; tests marked ``gpu``
decide inside the test whether a CUDA device exists."""

import copy
import os
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
for p in (ROOT, PB):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_wdm(name="wdm11_16qam_5x50km", n_sym=4096):
    """A coherent link deployment at a size the CPU runs in seconds: at most
    3 channels, ``n_sym`` symbols, 2 spans of 10 steps."""
    from harness import core

    c = copy.deepcopy(core.config(name))
    c["tx"].update(nSymbols=n_sym, nChannels=min(3, c["tx"]["nChannels"]))
    c["fiber"].update(Ltotal=100, Lspan=50, hz=5.0)
    c["rx"].update(nTrain=max(1200, n_sym // 4), L=100)
    return c


# The link mix (kind ``link``) waits for its cell, ``wdm11.link`` (PERF.md,
# Open questions); the tests run it as a cell of their own, at 3 channels
# and 2^16 samples, where the program's carrier phase ramps are exact
# enough, with the limits that its single-channel readings gave.
LINK_CELL = {"name": "wdm11.link", "config": "wdm11_16qam_5x50km", "traffic": "link",
             "chips": 1, "why": "the link mix at a CPU test's size"}
LINK_METRICS = ("tx_ms.link", "ssfm_ms.link", "ssfm_roofline.link", "rx_front_ms.link",
                "dsp_ms.link", "score_ms.link", "device_idle.link")
LINK_LIMITS = {"gmi_gap": 2e-05, "train_gap": 1e-3, "snr_gap_med": 0.5, "snr_gap_max": 0.6}


def bench_with_link():
    """BENCHMARK.json with the link mix's cell and metrics added."""
    from harness import core

    bench = core.benchmark()
    bench["workloads"].append(LINK_CELL)
    bench["end_to_end"].append({"name": "link_msym_s", "unit": "Msym/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": [LINK_CELL["name"]]})
    for m in LINK_METRICS:
        bench["per_layer"].append({"name": m, "unit": "ms", "better": "lower",
                                   "source": "host_clock", "layer": "link",
                                   "moves": "link_msym_s", "workloads": [LINK_CELL["name"]]})
    return bench


def small_case(cell, n_sym=4096):
    """(configuration, traffic) of a cell at a CPU test's size."""
    from harness import core

    w = core.cell(bench_with_link(), cell)
    trf = core.traffic(w["traffic"])
    trf["trace_units"] = 1
    if cell.startswith("dvbs2"):
        trf.update(batch=4, pool=2)
        return core.config(w["config"]), trf
    return small_wdm(w["config"], n_sym), trf


@pytest.fixture
def cpu_run():
    """Run a cell on the CPU at its small size: the result dict."""
    import time

    import torch

    import run

    torch.set_num_threads(4)

    def go(cell, seed=2 ** 32 + 7, seconds=0.5, trace=0, control=False, n_sym=4096):
        cfg, trf = small_case(cell, n_sym)
        return run.execute(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                           control=control, cfg=cfg, trf=trf, bench=bench_with_link(),
                           limits=LINK_LIMITS if cell == LINK_CELL["name"] else None)

    return go
