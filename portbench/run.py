"""Run one cell of the benchmark of ``opticommpy_torch`` on the CUDA device.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run loads the program's kernel library
(``build/torch_kernels/``, built on the first run in a checkout), makes the
cell's inputs on the device from ``--seed``, warms up the cell's own
shapes, works in a closed loop for ``--seconds``, then checks what the
timed path produced against the plain reference and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared
number beside its limit. It fails without a result when there is no CUDA
device, too few of them, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, HERE]
# one process with few threads: the host's share of the time is steadier
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

from harness import core  # noqa: E402


def cache_dirs(root):
    """Fixed cache directories inside the checkout, for every compiler the
    program might use (its own nvcc build goes to ``build/torch_kernels``)."""
    base = os.path.join(root, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        path = os.path.join(base, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ["USE_FLAX"] = "0"


def card_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not readable"


def fail(msg, code=3):
    print(msg, file=sys.stderr)
    sys.exit(code)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_window(ctx, mx, state, seconds, sync):
    """Closed loop: units until ``seconds`` have passed; (units, elapsed)."""
    sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        mx.step(ctx, state)
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return n, elapsed


def execute(workload, seed, seconds, trace, device, t_start, root=ROOT, control=False,
            cfg=None, trf=None, bench=None, limits=None):
    """Everything a run does once the device is ready; the result dict.

    ``control`` puts the lower-precision reference in the program's place
    before the comparison (``study.py``); ``cfg``, ``trf``, ``bench`` and
    ``limits`` replace the cell's configuration, traffic, benchmark and
    limits (the CPU tests' small sizes and cells). The benchmark's runs use
    none of them.
    """
    import torch

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    bench = bench or core.benchmark(root)
    w = core.cell(bench, workload)
    trf = trf or core.traffic(w["traffic"])
    ctx = core.Ctx(workload, cfg or core.config(w["config"]), trf, seed, device)
    ctx.spans.sync = sync
    mx = core.mix(trf["kind"])
    state = mx.setup(ctx)
    mx.warmup(ctx, state)
    sync()
    setup_s = time.perf_counter() - t_start

    if trace:
        ctx.spans.mode = "sync"
    n_units, elapsed = run_window(ctx, mx, state, seconds, sync)
    ctx.spans.mode = "off"
    e2e = mx.results(ctx, state, n_units, elapsed)
    e2e["setup_s"] = setup_s
    tr = None
    if trace:
        from harness.trace import profile_units

        tr = profile_units(lambda: mx.step(ctx, state), int(trf["trace_units"]), ctx.spans, sync)
        tr["spans"] = ctx.spans.times
        tr["unit_wall_s"] = elapsed / n_units
        print(f"trace: device s by range {tr['range_dev_s']}, calls {tr['range_calls']}",
              flush=True)
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    attempted, failed = mx.work(ctx, state)
    mx.release(ctx, state)
    if cuda:
        torch.cuda.empty_cache()
    if control:
        mx.control(ctx, state)
    held = core.limits(workload) if limits is None else limits
    correct, table, unheld = core.checks_table(mx.compare(ctx, state), held)
    if unheld:
        ctx.notes["compared, not held"] = unheld

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": int(w["chips"]), "memory_peak_bytes": memory_peak}
    metrics = {}
    if trace:
        for m in core.layer_metrics(bench, workload):
            value = core.reader(m["name"])(ctx, state, tr)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
    else:
        for m in core.e2e_metrics(bench, workload):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    print(f"window: {n_units} units in {elapsed:.3f} s; "
          + "; ".join(f"{k} {v:.6g}" for k, v in e2e.items())
          + (f"; notes {json.dumps(ctx.notes)}" if ctx.notes else ""), flush=True)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = table
    return result


def guard():
    """Fail without a result where JAX, the JAX package or, in the
    reference, the program was imported."""
    bad = core.forbidden_modules()
    if bad:
        fail(f"portbench: modules of JAX or the JAX package loaded in this process: {bad}")
    bad_ref = core.reference_imports()
    if bad_ref:
        fail(f"portbench: the reference imports the program or JAX: {bad_ref}")


def ready_device(chips):
    """The CUDA device, TF32 off and the program's kernel library loaded;
    exits without a result when there are fewer than ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        fail("portbench: no CUDA device; this benchmark measures the card only")
    if torch.cuda.device_count() < int(chips):
        fail(f"portbench: {chips} devices needed, {torch.cuda.device_count()} found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    print(f"card: {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    from opticommpy_torch.kernels import _build

    t_lib = time.perf_counter()
    _build.load_library()
    print(f"kernel library: {time.perf_counter() - t_lib:.3f} s "
          f"(nvcc {_build.build_info.get('seconds', 0.0):.2f} s)", flush=True)
    return torch.device("cuda:0")


def main(argv=None):
    args = parse(argv)
    cache_dirs(ROOT)
    device = ready_device(core.cell(core.benchmark(ROOT), args.workload)["chips"])
    result = execute(args.workload, args.seed, args.seconds, args.trace, device, T_START)
    guard()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
