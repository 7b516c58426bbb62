"""Each traffic mix's set-up, window and comparison at a small size on the
CPU, with the kernels' plain versions: sound runs read correct, traced
runs read their per-layer metrics."""

import pytest

CELLS = ("wdm11.link", "wdm11.rx_sweep", "dvbs2.decode")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cpu_run, cell):
    res = cpu_run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_host_spans(cpu_run, cell):
    res = cpu_run(cell, trace=1)
    assert res["correct"], res["checks"]
    assert "busy_s" in res["device"] and "breakdown" in res
    if cell == "wdm11.link":
        assert {"tx_ms.link", "ssfm_ms.link", "rx_front_ms.link", "dsp_ms.link",
                "score_ms.link"} <= set(res["metrics"])
    # device metrics come from a device trace: nothing on the CPU
    assert not any(k.startswith(("device_idle", "eq_kernel", "decode_"))
                   or "roofline" in k for k in res["metrics"])


def test_same_seed_same_inputs():
    import torch

    from harness import core

    link = core.mix("link")
    from conftest import small_wdm

    cfg = small_wdm()
    a = link.draw(cfg, 2 ** 33 + 1, torch.device("cpu"))
    b = link.draw(cfg, 2 ** 33 + 1, torch.device("cpu"))
    c = link.draw(cfg, 2 ** 33 + 2, torch.device("cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and not torch.equal(a[0], c[0])
