"""Where the time goes in the IM-DD serving chain, on one GPU.

Builds the links of chip_smoke.py's path H on the card (8 PAM4 links of
2**19 samples, 10 km, photodiode), then, for B = 8 links and B = 132 (the
links repeated: one per SM of an H100), times warm imdd_dsp_chain_batch
calls with CUDA events and profiles one more with torch.profiler: the
device time by kernel name and the device's busy share of the wall time.
What the device does not cover is host work, most of it before the one
K13 launch.

Usage: python3 tools/profile_imdd_chain.py [--reps N]
"""

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from opticommpy_torch.pipelines import IMDDConfig, imdd_dsp_chain_batch  # noqa: E402


def _profile(name, fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = sum(e.self_device_time_total for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    print(f"== {name}: profiled wall {wall * 1e3:.3f} ms, device busy {device_us / 1e3:.3f} ms "
          f"({100 * device_us / 1e6 / wall:.1f}% of wall)")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8,
                                    max_name_column_width=50))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5, help="timed calls per batch size")
    args = ap.parse_args()
    dev = chip_smoke.phase_device()
    chip_smoke.phase_build()
    i_b, ref_b = chip_smoke.imdd_links(dev)
    n_links, n_sym = ref_b.shape
    cfg = IMDDConfig(SpS_in=8, nTapsFF=15, nTapsFB=5, mu=2e-3, nTrain=8000)
    for n_b in (8, 132):
        reps = -(-n_b // n_links)
        x = i_b.repeat(reps, 1)[:n_b].contiguous()
        r = ref_b.repeat(reps, 1)[:n_b].contiguous()
        ms = chip_smoke._cuda_ms(lambda: imdd_dsp_chain_batch(x, r, cfg), args.reps)
        print(f"imdd_dsp_chain_batch dfe, B = {n_b}: warm {ms:.3f} ms "
              f"({n_b * n_sym / ms / 1e3:.4f} Msym/s aggregate)")
        _profile(f"imdd_dsp_chain_batch dfe, B = {n_b} x {n_sym} symbols",
                 lambda: imdd_dsp_chain_batch(x, r, cfg))


if __name__ == "__main__":
    main()
