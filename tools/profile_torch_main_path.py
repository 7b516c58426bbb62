"""Where the time goes on the PyTorch port's main path, on one GPU.

Runs chip_smoke.run_main_path once to warm up, then profiles a second
manakov_ssf call and a second coherent_dsp_chain call with torch.profiler
and prints, for each, the device time by kernel name and the device's busy
share of the wall time. Then it receives all 11 channels of the field
(chip_smoke.receive_wdm) and profiles a warm coherent_dsp_chain_batch call
for each training schedule, ("da-rde", "dd-lms") and ("rls", "dd-rls").

Usage: python3 tools/profile_torch_main_path.py
"""

import os
import sys
import time
from dataclasses import replace

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from opticommpy_torch.models import manakov_ssf  # noqa: E402
from opticommpy_torch.pipelines import coherent_dsp_chain, coherent_dsp_chain_batch  # noqa: E402


def _profile(name, fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    print(f"== {name}: wall {wall * 1e3:.3f} ms, device busy {device_us / 1e3:.3f} ms "
          f"({100 * device_us / 1e6 / wall:.1f}% of wall)")
    print(events.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60))


def main():
    dev = chip_smoke.phase_device()
    chip_smoke.phase_build()
    res, _ = chip_smoke.run_main_path(dev)
    _profile("manakov_ssf (2**20 samples, 5 x 50 km, 500 steps)",
             lambda: manakov_ssf(res["sig_tx"], res["cfg_ch"], res["gen"]))
    _profile("coherent_dsp_chain (65536 symbols, kernel backends)",
             lambda: coherent_dsp_chain(res["sig_rx"], res["d_ref"], res["cfg"]))
    sig_b, ref_b = chip_smoke.receive_wdm(res)
    for algs in (("da-rde", "dd-lms"), ("rls", "dd-rls")):
        cfg = replace(res["cfg"], alg=algs)
        coherent_dsp_chain_batch(sig_b, ref_b, cfg)  # warm-up
        _profile(f"coherent_dsp_chain_batch {algs} (11 x 65536 symbols)",
                 lambda: coherent_dsp_chain_batch(sig_b, ref_b, cfg))


if __name__ == "__main__":
    main()
