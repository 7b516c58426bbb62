"""K13 (``csrc/dfe.cu``) and K6 (``csrc/gardner.cu``) against the parent
commit's kernels, other layouts and probe edits, on one GPU, in one process.

Builds, besides the package's library, one library per design to compare:
the parent commit's ``dfe.cu`` and ``gardner.cu`` (from a checkout given by
``--parent``, entry points renamed ``*_parent``) and variants: copies of
a source with one edit. A layout variant computes the same function
another way (K13 on 2 or 4 lanes per signal, K6's loop unrolled, the
slicer's quotient through a reciprocal) and is compared with the current
kernel; a probe takes one part of the step out (its outputs are not the
function's and are not compared). A design is swapped in for the wrappers of ``kernels/dfe.py``
and ``kernels/gardner.py`` by standing in for the library that
``_build.load_library`` returns, so every design runs through the same
wrappers on the same inputs.

Inputs are the paths' own: K13 gets the arguments ``imdd_dsp_chain_batch``
gives it on ``chip_smoke.py``'s path H (8 PAM4 links x 65,536 symbols, the
DFE and the FFE, and the DFE on the links repeated to B = 132), plus a
16-QAM complex case; K6 the arguments ``coherent_dsp_chain`` gives it on
path A (~131,100 x 2 samples). In turns (parent, current, current, parent)
each case is timed with CUDA events, the SM clock read after each window,
and cycles per step printed (per symbol for K13, per input sample for K6);
then each layout and probe beside the design it edits. Prints one JSON
object per measurement and writes them all, with the ptxas registers,
spills and stack frame of every K13 / K6 instance, to ``--out``.

Usage: git archive <parent> opticommpy_torch/csrc | tar -x -C build/parent
       python3 tools/bench_recurrence_redesign.py --parent build/parent
"""

import argparse
import ctypes
import json
import re
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from bench_eq_redesign import _compile  # noqa: E402
from opticommpy_torch.kernels import _build, dfe, gardner  # noqa: E402

ENTRIES = ("dfe_launch", "gardner_launch")
K13_CASES = ("K13 dfe path H 8x65536", "K13 ffe path H 8x65536", "K13 dfe path H 132x65536",
             "K13 dfe 16-QAM 8x16384")
K6_CASES = ("K6 path A",)
_K13_LANES = "constexpr int kLanes = 8;  // lanes per signal"
_K6_LOOP = "#pragma unroll 1\n      for (; it < max_iters"
_K13_DIVISION = "  float k = rintf(__fdiv_rn(__fsub_rn(x, lo), step));"
# the quotient by one reciprocal and an FMA correction (q0 kept where it is
# zero or infinite, where the correction would turn -0 into +0 or an
# infinity into NaN)
_K13_RECIPROCAL = """  const float u = __fsub_rn(x, lo), rcp = __frcp_rn(step), q0 = __fmul_rn(u, rcp);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, step, u), rcp, q0);
  float k = rintf((q0 == 0.0f || isinf(q0)) ? q0 : q1);"""
# layouts: the same function, edited in the current sources:
# (tag, "current", source, [(before, after)], cases timed)
LAYOUTS = tuple(
    [(f"lanes{g}", "current", "dfe.cu", [(_K13_LANES, _K13_LANES.replace("8", str(g)))],
      K13_CASES[:3]) for g in (2, 4)]
    + [(f"unroll{u}", "current", "gardner.cu", [(_K6_LOOP, _K6_LOOP.replace("1", str(u), 1))],
        K6_CASES) for u in (2, 4, 8)]
    + [("k13_reciprocal", "current", "dfe.cu", [(_K13_DIVISION, _K13_RECIPROCAL)],
        K13_CASES[:1])])
# probes: (tag, "parent" or "current", source, [(before, after)], cases)
PROBES = (
    ("p13_no_loads", "parent", "dfe.cu", [
        ("      wn[i] = (more && i < n_ff) ? load<CPLX>(sig, next + i) : Num{0.0f, 0.0f};",
         "      wn[i] = w[(i + 1) % PFF];"),
        ("    const Num rn = more ? load<CPLX>(ref, rrow + k + 1) : Num{0.0f, 0.0f};",
         "    const Num rn = r;")], K13_CASES[:1]),
    ("p13_no_stores", "parent", "dfe.cu", [
        ("    store<CPLX>(a.y, rrow + k, y);", ""),
        ("    a.mse[rrow + k] = m2;", "")], K13_CASES[:1]),
    ("p13_mul_step", "parent", "dfe.cu", [
        ("rintf(__fdiv_rn(__fsub_rn(x, lo), step))",
         "rintf(__fmul_rn(__fsub_rn(x, lo), __frcp_rn(step)))")], K13_CASES[:1]),
    ("p6_no_q3_load", "parent", "gardner.cu", [
        ("      q3 = load_x(col, m + 5, n_in, modes);", "      q3 = w0;")], K6_CASES),
    ("p6_no_stores", "parent", "gardner.cu", [
        ("    if (n >= 0) eo[(size_t)n * modes] = val;", ""),
        ("    tv[(size_t)min(max(n, 0), n_out - 1) * modes] = t;", "")], K6_CASES),
    ("p6_no_readback", "parent", "gardner.cu", [
        ("  return eo[(size_t)k * modes];", "  return make_float2(0.0f, 0.0f);")], K6_CASES),
    ("p6_no_ted", "parent", "gardner.cu", [
        ("    if ((n & 1) == 0) {", "    if (false) {")], K6_CASES),
    ("p13n_no_shuffles", "current", "dfe.cu", [
        ("__fadd_rn(v, __shfl_xor_sync(mask, v, H))", "__fadd_rn(v, v)")], K13_CASES[:1]),
    ("p13n_no_stores", "current", "dfe.cu", [
        ("    put(ys + kk, y);", ""), ("    ms[kk] = m2;", "")], K13_CASES[:1]),
    ("p6n_no_log", "current", "gardner.cu", [
        ("        rec[len++] = make_float4(val.x, val.y, t, __int_as_float(n));",
         "        ++len;")], K6_CASES),
    ("p6n_no_ted", "current", "gardner.cu", [
        ("        ip = even ? ip_ted : ip;", ""), ("        t = even ? t_ted : t;", "")], K6_CASES),
)


class _Design:
    """Stands in for the package's library with one design's K13 / K6 entry
    points (suffix ``tag``); every other entry is the package's."""

    def __init__(self, base, lib, tag):
        self._base = base
        self._fns = {}
        for entry in ENTRIES:
            fn = getattr(lib, f"{entry}_{tag}", None)
            if fn is not None:
                fn.argtypes = _build._SIGNATURES[entry]
                fn.restype = ctypes.c_int
                self._fns[entry] = fn

    def __getattr__(self, name):
        return self._fns.get(name) or getattr(self._base, name)


def _ptxas(log):
    """[(instance, registers, spill stores, spill loads, stack frame bytes)]
    of the K13 and K6 kernels in an nvcc -Xptxas -v log."""
    rows, name, frame, spills = [], None, 0, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame, spills = int(m.group(1)), (int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and ("dfe_kernel" in name or "gardner_kernel" in name):
            rows.append((name, int(m.group(1)), *spills, frame))
    return rows


def _k13_inputs(dev):
    """{case: (n_sym, args of dfe.dfe_run)} on path H's links and a 16-QAM
    complex case."""
    from opticommpy_torch.pipelines import IMDDConfig, imdd_dsp_chain_batch

    i_b, ref_b = chip_smoke.imdd_links(dev, 8, 2**17)
    n_wide = 132
    wide = i_b.repeat(-(-n_wide // 8), 1)[:n_wide].contiguous()
    wide_ref = ref_b.repeat(-(-n_wide // 8), 1)[:n_wide].contiguous()
    cases = {}
    for label, eq, x, r in ((K13_CASES[0], "dfe", i_b, ref_b), (K13_CASES[1], "ffe", i_b, ref_b),
                            (K13_CASES[2], "dfe", wide, wide_ref)):
        cfg = IMDDConfig(SpS_in=8, nTapsFF=15, nTapsFB=5, mu=2e-3, nTrain=8000, eq=eq)
        with mock.patch.object(dfe, "dfe_run", wraps=dfe.dfe_run) as spy:
            imdd_dsp_chain_batch(x, r, cfg)
        args = spy.call_args.args
        cases[label] = (args[5], args)
    qam = dfe.norm_const(16, "qam")
    xq, sq = chip_smoke._cplx_isi(8, 16384, qam, 80)
    sig_pad, ref, n_out, _ = dfe.prepare(torch.as_tensor(xq, device=dev),
                                         torch.as_tensor(sq, device=dev), 7, 1, qam)
    f0 = torch.zeros((8, 7), dtype=torch.complex64, device=dev)
    f0[:, 3] = 1.0
    b0 = torch.zeros((8, 3), dtype=torch.complex64, device=dev)
    cases[K13_CASES[3]] = (n_out, (sig_pad, ref, qam, f0, b0, n_out, 1, 2e-3, 1500, True, True))
    return cases


def _k6_inputs(dev):
    """{case: (n_in, args of gardner.gardner_records)} on path A's input."""
    from opticommpy_torch.pipelines import coherent_dsp_chain

    res, _ = chip_smoke.run_main_path(dev)
    sig_off, d_cr, cfg = chip_smoke.path_a_inputs(res)
    with mock.patch.object(gardner, "gardner_records", wraps=gardner.gardner_records) as spy:
        coherent_dsp_chain(sig_off, d_cr, cfg)
    args = spy.call_args.args
    return {K6_CASES[0]: (args[0].shape[0], args)}


LATENCY_CASES = ("fadd", "fmul", "fdiv_rn", "rintf + fadd", "quantize + fadd", "shfl_xor",
                 "lds (pointer chase)", "compare + select", "branch + fadd")


def _latencies(lib, dev, emit, n=4096):
    """SM cycles per dependent repetition of each case of
    tools/latency_probe.cu, on one warp."""
    lib.lat_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.lat_launch.restype = ctypes.c_int
    if lib.lat_cases() != len(LATENCY_CASES):
        raise RuntimeError("tools/latency_probe.cu and LATENCY_CASES disagree")
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.zeros(32, dtype=torch.float32, device=dev)
    for which, name in enumerate(LATENCY_CASES):
        per = []
        for _ in range(3):
            _build.check(lib.lat_launch(which, n, 1.0000001, _build.ptr(cycles),
                                        _build.ptr(out), _build.stream_ptr(dev)), "lat_launch")
            torch.cuda.synchronize()
            per.append(int(cycles.item()) / n)
        emit(dict(what="latency", case=name, cycles_per_rep=min(per), reps=n))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="checkout of the parent commit")
    ap.add_argument("--out", default="build/recurrence_redesign.json")
    ap.add_argument("--skip", default="",
                    help="comma-separated: turns, layouts, probes, latency")
    args = ap.parse_args()
    skip = set(filter(None, args.skip.split(",")))

    dev = chip_smoke.phase_device()
    smi = chip_smoke.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True).stdout.strip()
    t0 = time.perf_counter()
    base = _build.load_library()
    csrc = ROOT / "opticommpy_torch" / "csrc"
    old = Path(args.parent) / "opticommpy_torch" / "csrc"
    jobs = [("parent", [old / "dfe.cu", old / "gardner.cu"],
             [f"-I{old}", *(f"-D{e}={e}_parent" for e in ENTRIES)])]
    layouts = [] if "layouts" in skip else LAYOUTS
    probes = [] if "probes" in skip else PROBES
    out_dir = ROOT / "build" / "recurrence_designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    for tag, which, src, edits, _ in (*layouts, *probes):
        folder = old if which == "parent" else csrc
        text = (folder / src).read_text()
        for before, after in edits:
            if before not in text:
                raise RuntimeError(f"{tag}: {before!r} not in {which} {src}")
            text = text.replace(before, after)
        (out_dir / f"{tag}.cu").write_text(text)
        jobs.append((tag, [out_dir / f"{tag}.cu"],
                     [f"-I{folder}", f"-D{src[:-3]}_launch={src[:-3]}_launch_{tag}"]))
    if "latency" not in skip:
        jobs.append(("latency", [ROOT / "tools" / "latency_probe.cu"], []))
    libs, logs = _compile(jobs, out_dir)
    logs["current"] = _build.build_info.get("log", "")  # empty if built by another process
    lat_lib = libs.pop("latency", None)
    designs = {name: _Design(base, lib, name) for name, lib in libs.items()}
    records = [dict(what="device", smi=smi, build_s=time.perf_counter() - t0,
                    package_nvcc_s=_build.build_info.get("seconds"))]

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    for tag in logs:
        for name, regs, st, ld, frame in _ptxas(logs[tag]):
            emit(dict(what="ptxas", design=tag, instance=name, registers=regs,
                      spill_stores=st, spill_loads=ld, stack_frame=frame))

    if lat_lib is not None:
        _latencies(lat_lib, dev, emit)

    def use(design):
        _build._lib = base if design == "current" else designs[design]

    inputs = {}
    inputs.update(_k13_inputs(dev))
    inputs.update(_k6_inputs(dev))

    def call(label):
        n_step, a = inputs[label]
        run = gardner.gardner_records if label in K6_CASES else dfe.dfe_run
        return n_step, (lambda: run(*a))

    def timed(label, design, reps=3):
        use(design)
        n_step, fn = call(label)
        ms = chip_smoke._cuda_ms(fn, reps)
        mhz = chip_smoke._sm_clock_mhz()
        out = [t.cpu() for t in fn()]
        emit(dict(what="kernel", case=label, design=design, ms=ms, sm_clock_mhz=mhz,
                  cycles_per_step=ms * 1e-3 / n_step * mhz * 1e6,
                  finite=all(bool(torch.isfinite(t).all()) for t in out
                             if t.is_floating_point() or t.is_complex()),
                  checksum=[float(t.abs().double().sum()) for t in out]))
        return out

    if "turns" not in skip:
        for label in (*K13_CASES, *K6_CASES):
            outs = {}
            for design in ("parent", "current", "current", "parent"):
                outs[design] = timed(label, design)
            emit(dict(what="parent_vs_current", case=label,
                      equal=all(bool(torch.equal(a, b))
                                for a, b in zip(outs["parent"], outs["current"]))))

    # each layout and probe beside the parent and the current design
    layout_tags = {tag for tag, *_ in layouts}
    by_case = {}
    for tag, *_, labels in (*layouts, *probes):
        for label in labels:
            by_case.setdefault(label, []).append(tag)
    for label, tags in by_case.items():
        timed(label, "parent")
        cur = timed(label, "current")
        for tag in tags:
            out = timed(label, tag)
            if tag in layout_tags:  # the same function
                emit(dict(what="layout_vs_current", case=label, design=tag,
                          equal=all(bool(torch.equal(a, b)) for a, b in zip(out, cur))))
        timed(label, "current")
        timed(label, "parent")
    use("current")

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))
    print(f"wrote {args.out} ({len(records)} records)")


if __name__ == "__main__":
    sys.exit(main())
