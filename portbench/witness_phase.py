"""A witness for the carrier phase ramps of the program's WDM link.

    python3 portbench/witness_phase.py --seeds 1,2 [--device cuda]

For each seed, one realization of ``wdm11_16qam_5x50km`` (the symbols and
Tx phase noise that ``wdm11.link`` draws): the data-aided SNR of every
polarization of the program's received signals, of the reference link's
with float64 phase ramps (as OptiCommPy computes them), and of the
reference link's with the ramps computed in float32 as the program
computes them (``t = k / Fs`` and ``2 pi f t`` in float32). Where the
program agrees with the float32 ramps and not with the float64 ones, the
ramps are the cause of the difference. Prints one JSON line per seed.
"""

import argparse
import json
import sys
import time

import run


def main(argv=None):
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run.cache_dirs(run.ROOT)
    dev = run.ready_device(1) if args.device == "cuda" else torch.device(args.device)
    core = run.core
    cfg = core.config("wdm11_16qam_5x50km")
    ref = core.reference(cfg["name"])
    link = core.mix("link")
    ctx = core.Ctx("wdm11.link", cfg, core.traffic("link"), 0, dev)
    st = link.setup(ctx)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx.seed = seed
        st.gen = torch.Generator(device=dev).manual_seed(ctx.seed_for("program noise"))
        symbols, pn = link.draw(cfg, ctx.seed_for("realization", 0), dev)
        _, _, (sig_p, _, _) = link.realization(ctx, st, symbols, pn)
        out = {"seed": seed, "program": link._snr(ref, cfg, sig_p, symbols)}
        for name, dt in (("float64 ramps", torch.float64), ("float32 ramps", torch.float32)):
            ref.PHASE_DTYPE = dt
            gen = torch.Generator(device=dev).manual_seed(ctx.seed_for("reference noise"))
            sig_r, _ = ref.link(symbols, pn, cfg, gen)
            out[name] = link._snr(ref, cfg, sig_r, symbols)
        ref.PHASE_DTYPE = torch.float64
        res = {k: (v.numpy().round(3).tolist() if hasattr(v, "numpy") else v)
               for k, v in out.items()}
        for name in ("float64 ramps", "float32 ramps"):
            d = (out["program"] - out[name]).abs()
            res["gap to " + name] = [round(float(d.median()), 4), round(float(d.max()), 4)]
        res["seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(res), flush=True)
    run.guard()


if __name__ == "__main__":
    sys.exit(main())
