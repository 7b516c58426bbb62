"""Where the time goes on the PyTorch port's main path, on one GPU.

Runs chip_smoke.run_main_path once to warm up, then profiles a second
manakov_ssf call and a second coherent_dsp_chain call with torch.profiler
and prints, for each, the device time by kernel name and the device's busy
share of the wall time. Then it receives all 11 channels of the field
(chip_smoke.receive_wdm) and profiles a warm coherent_dsp_chain_batch call
for each training schedule, ("da-rde", "dd-lms") and ("rls", "dd-rls").
Last, the clock-recovery and serving paths of chip_smoke.py, each warm:
A, coherent_dsp_chain with Gardner clock recovery on the centre channel at
a 200-ppm receiver clock; B, coherent_dsp_chain_batch with feedforward
clock recovery on 11 channels at their own offsets; C, coherent_dsp_serve
of 11 channels with trained taps, and the DD-PLL over their 22 columns.

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
from opticommpy_torch.dsp import (CPRConfig, MIMOEqualizerConfig, cpr,  # noqa: E402
                                  mimo_adapt_equalizer_batch)
from opticommpy_torch.dsp.equalization import mimo_apply_fused  # noqa: E402
from opticommpy_torch.models import manakov_ssf  # noqa: E402
from opticommpy_torch.pipelines import (CoherentDSPConfig, coherent_dsp_chain,  # noqa: E402
                                        coherent_dsp_chain_batch, coherent_dsp_serve)


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

    sig_a, ref_a, cfg_a = chip_smoke.path_a_inputs(res)
    coherent_dsp_chain(sig_a, ref_a, cfg_a)  # warm-up
    _profile(f"path A: coherent_dsp_chain, Gardner on K6 ({ref_a.shape[0]} symbols)",
             lambda: coherent_dsp_chain(sig_a, ref_a, cfg_a))
    del sig_a
    sig_o, ref_o, cfg_b = chip_smoke.path_b_inputs(res, sig_b, ref_b)
    del sig_b
    coherent_dsp_chain_batch(sig_o, ref_o, cfg_b)  # warm-up
    _profile(f"path B: coherent_dsp_chain_batch, ffw (11 x {ref_o.shape[1]} symbols)",
             lambda: coherent_dsp_chain_batch(sig_o, ref_o, cfg_b))
    del sig_o
    x_b, front_b, ref_c, scale_b, pulse2, edc_cfg = chip_smoke.serve_inputs(res)
    n_sym = ref_c.shape[1]
    eq_cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
                                 L=(12000, n_sym - 12000), M=16, numIter=2, backend="pallas")
    _, H_b, _ = mimo_adapt_equalizer_batch(front_b, eq_cfg, symb_ref=ref_c,
                                           return_results=True)
    cfg_c = CoherentDSPConfig(SpS_in=16, L=250, nTrain=12000, mu=(5e-3, 2e-3))
    coherent_dsp_serve(x_b, H_b, cfg_c, scale_b)  # warm-up
    _profile(f"path C: coherent_dsp_serve (11 x {n_sym} symbols)",
             lambda: coherent_dsp_serve(x_b, H_b, cfg_c, scale_b))
    y_cols = torch.stack([mimo_apply_fused(H_b[k], x_b[k], 2, pre=pulse2, edc_config=edc_cfg,
                                           scale=scale_b[k]) for k in range(11)],
                         dim=1).reshape(n_sym, 22)
    r_cols = ref_c.transpose(0, 1).reshape(n_sym, 22)
    pll_cfg = CPRConfig(alg="ddpll-pallas", M=16, Ts=1 / 32e9, runFOE=False)
    pilots = torch.arange(0, n_sym, chip_smoke.PILOT_EVERY).numpy()
    cpr(y_cols, pll_cfg, symb_tx=r_cols, pilot_ind=pilots)  # warm-up
    _profile(f"path C: cpr ddpll-pallas (22 x {n_sym} symbols)",
             lambda: cpr(y_cols, pll_cfg, symb_tx=r_cols, pilot_ind=pilots))


if __name__ == "__main__":
    main()
