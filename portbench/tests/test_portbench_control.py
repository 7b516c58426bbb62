"""The control of each cell, the reference computed in the next precision
below the configuration's (bfloat16 for the float32 link and receiver, fp8
for the decoder's bf16 messages) in the program's place, reads not
correct. On the card, ``study.py --control`` reads it at the cells' own
sizes. The receiver's bf16 control is run on 16,384 symbols: at 4,096 the
decision-directed stretch is too short for its gap to pass the limit."""

import pytest


@pytest.mark.parametrize("cell", ("wdm11.link", "wdm11.rx_sweep", "dvbs2.decode"))
def test_control_is_not_correct(cpu_run, cell):
    res = cpu_run(cell, control=True, n_sym=16384 if cell == "wdm11.rx_sweep" else 4096)
    assert not res["correct"], res["checks"]
