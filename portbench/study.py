"""Readings for the limits of a cell's comparison, on the CUDA device.

    python3 portbench/study.py --workload <cell> --seeds 1,2,3 --seconds 10 [--control]

runs the cell once per seed in one process, each run as ``run.py`` runs
it; with ``--control`` the reference computed in the next precision below
the configuration's (bfloat16 for float32, fp8 for bf16) takes the
program's place before the comparison. Prints one JSON line per seed with
every compared number.
"""

import argparse
import json
import sys
import time

import run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    run.cache_dirs(run.ROOT)
    device = run.ready_device(run.core.cell(run.core.benchmark(), args.workload)["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = run.execute(args.workload, seed, args.seconds, 0, device, t0, control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": res["correct"], "checks": res["checks"],
                          "metrics": res["metrics"],
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    run.guard()


if __name__ == "__main__":
    sys.exit(main())
