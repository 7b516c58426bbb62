"""On the card: each cell runs briefly and reads correct. Skips without a
CUDA device (run on the card with ``python3 -m pytest -m gpu portbench/tests``)."""

import time

import pytest


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ("wdm11.rx_sweep", "dvbs2.decode"))
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import run

    device = run.ready_device(1)
    res = run.execute(cell, 2 ** 31 + 11, 1.0, 0, device, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
