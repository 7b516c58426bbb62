"""K1 (``csrc/bps.cu``) against the parent commit's design, on one GPU, in
one process.

Builds the parent commit's ``bps.cu`` (from a checkout given by
``--parent``, entry point renamed ``bps_launch_parent``) and the current
one (``bps_launch_current``), each from its source alone, all nvcc
processes at once. The parent's kernel runs through the parent's own
wrapper (``kernels/bps.py`` of the checkout, loaded beside the package's,
its library swapped for the parent build); the current one through the
package's wrapper.

Inputs are the paths' own calls of ``bps_kernel``: the chain's (65,536
symbols x 2 modes, the 16-QAM grid from a NumPy constellation, window 75,
64 test phases), path C's serve (the same x 22 modes) and path I's
``cpr(alg="bps-pallas")`` (60,436 x 2, 16-QAM as a CPU tensor: the M-point
route, window 51). In turns (parent, current, current, parent) each is
timed with CUDA events over 20 calls, the SM clock read after each window;
each record has cycles per symbol and mode, the bound of
``chip_smoke._bps_cost`` and its share. Outputs (``bps_indices``): each
design's turns bit for bit, the current one bit for bit against
``bps_indices_plain``, and against the parent within the near-tie rule (<
1% of the indices; the two sum their windows in different orders). Then,
for the current design only: the chain's call at other run lengths
(output blocks per CTA: 1-16 against the automatic choice, all bit for
bit); each kernel's own device time per call from torch.profiler (parent
and current at the three calls, current at each run length); variants
(copies of the current source with one edit, in turns with it, each bit
for bit): without the shared-memory carveout, eight symbols a step of the
forward pass in place of four, the argmin's loads unrolled by four, up to
16 points in shared memory in place of registers; and probes that take
the argmin, the reverse pass or the distance out (timed only); the CTAs per SM of each
call (the occupancy API); the fixed cost of a call (75 symbols x 1 mode);
and the ``-Xptxas -v`` registers, spills and stack frames of every instance
of both builds. Prints one JSON object per measurement and writes them all to
``--out``.

Usage: git archive <parent> opticommpy_torch | tar -x -C build/parent
       python3 tools/bench_bps_redesign.py --parent build/parent
"""

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from bench_eq_redesign import _compile  # noqa: E402
from opticommpy_torch.kernels import _build, bps  # noqa: E402

CASES = (("chain", "qam16", 65536, 2, 37), ("path C", "qam16", 65536, 22, 37),
         ("path I", "qam16 tensor", 60436, 2, 25))
N_PHASES = 64
NEAR_TIE = 0.01  # the JAX package's rule between two summation orders
RUN_BLOCKS = (1, 2, 3, 4, 8, 16)
# copies of the current source with one edit: (tag, edits, same bits as the
# current design). Probes take a part of the work out; their outputs are
# not the function's and are only timed.
_CHUNK8 = [("  for (; i + 4 < w; i += 4, cp += 4 * ld, np += 4 * ld) {\n    float d[4], c[4];",
            "  for (; i + 8 < w; i += 8, cp += 8 * ld, np += 8 * ld) {\n    float d[8], c[8];"),
           ("    for (int j = 0; j < 4; ++j) {", "    for (int j = 0; j < 8; ++j) {")]
VARIANTS = (
    ("no_carveout", [("cudaSharedmemCarveoutMaxShared", "cudaSharedmemCarveoutDefault")], True),
    ("forward_chunk8", _CHUNK8, True),
    ("argmin_unroll4", [("    for (int k = 1; k < nq; ++k) {",
                         "#pragma unroll 4\n    for (int k = 1; k < nq; ++k) {")], True),
    ("points_in_shared", [("  else if (n_tab <= kRegPoints)", "  else if (false)")], True),
    ("probe_no_argmin", [("      argmin_rows(a, cur, X, mode);", "")], False),
    ("probe_no_reverse", [("      if (X < b1) reverse(nxt, w, ld, p);", "")], False),
    ("probe_no_distance", [("    return dist.dist(zr, zi);", "    return __fadd_rn(zr, zi);")],
     False),
)
# appended to a copy of the current source: CTAs per SM of each instance
_OCCUPANCY = """
extern "C" int bps_occupancy(int route, int n_tab, int threads, int smem) {
  const DeviceInfo* info = nullptr;
  if (device_info(&info) != cudaSuccess) return -1;
  int n = -1;
  if (route == kGrid4)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bps_kernel<Grid4>, threads, smem);
  else if (route == kGridSearch)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bps_kernel<GridSearch>, threads, smem);
  else if (n_tab <= kRegPoints)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bps_kernel<Points16>, threads, smem);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bps_kernel<Points>, threads, smem);
  return n;
}
"""


class _Lib:
    """The package's library with ``bps_launch`` (and its helpers) taken from
    one build (suffix ``tag``, argument types from ``sigs``)."""

    def __init__(self, base, lib, tag, sigs):
        self._base = base
        self._fns = {}
        for entry in ("bps_launch", "bps_smem_bytes", "bps_exact_check"):
            fn = getattr(lib, f"{entry}_{tag}", None)
            if fn is None:
                continue
            fn.argtypes = sigs[entry]
            fn.restype = ctypes.c_int
            self._fns[entry] = fn

    def __getattr__(self, name):
        return self._fns.get(name) or getattr(self._base, name)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas(log):
    """[(instance, registers, spill stores, spill loads, stack frame bytes)]
    of the BPS kernels in an nvcc -Xptxas -v log."""
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
        if m and name and ("bps" in name or "exact_check" in name):
            rows.append((name, int(m.group(1)), *spills, frame))
    return rows


def _apply(text, edits, tag):
    for before, after in edits:
        if before not in text:
            raise RuntimeError(f"{tag}: {before!r} not found")
        text = text.replace(before, after)
    return text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="checkout of the parent commit")
    ap.add_argument("--out", default="build/bps_redesign.json")
    ap.add_argument("--skip", default="",
                    help="comma-separated: turns, runs, fixed, profile, variants, sass")
    args = ap.parse_args()
    skip = set(filter(None, args.skip.split(",")))

    dev = chip_smoke.phase_device()
    smi = chip_smoke._smi()
    t0 = time.perf_counter()
    csrc = ROOT / "opticommpy_torch" / "csrc"
    old = Path(args.parent) / "opticommpy_torch"
    entries = ("bps_launch", "bps_smem_bytes", "bps_exact_check")
    jobs = [(tag, [src / "csrc" / "bps.cu"],
             [f"-I{src / 'csrc'}", *(f"-D{e}={e}_{tag}" for e in entries)])
            for tag, src in (("parent", old), ("current", ROOT / "opticommpy_torch"))]
    build_dir = ROOT / "build" / "bps_designs"
    build_dir.mkdir(parents=True, exist_ok=True)
    current_src = (csrc / "bps.cu").read_text()
    variants = [] if "variants" in skip else VARIANTS
    for tag, edits, _ in variants:
        (build_dir / f"{tag}.cu").write_text(_apply(current_src, edits, tag))
    (build_dir / "occupancy.cu").write_text(current_src + _OCCUPANCY)
    for tag in [v[0] for v in variants] + ["occupancy"]:
        jobs.append((tag, [build_dir / f"{tag}.cu"],
                     [f"-I{csrc}", *(f"-D{e}={e}_{tag}" for e in entries)]))
    libs, logs = _compile(jobs, build_dir)
    occupancy = libs.pop("occupancy").bps_occupancy
    occupancy.argtypes = [ctypes.c_int] * 4
    occupancy.restype = ctypes.c_int
    base = types.SimpleNamespace()  # no other kernel runs here
    parent_sigs = _load(old / "kernels" / "_build.py", "parent_build")._SIGNATURES
    designs = {tag: _Lib(base, lib, tag, parent_sigs if tag == "parent" else _build._SIGNATURES)
               for tag, lib in libs.items()}
    _build._lib = designs["current"]
    shim = types.SimpleNamespace(load_library=lambda: designs["parent"],
                                 **{n: getattr(_build, n) for n in
                                    ("check", "ptr", "stream_ptr", "device_tables",
                                     "device_arrays")})
    parent = _load(old / "kernels" / "bps.py", "parent_bps")
    parent._build = shim
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    emit(dict(what="device", smi=smi, build_s=time.perf_counter() - t0))
    for tag in logs:
        for name, regs, st, ld, frame in _ptxas(logs[tag]):
            emit(dict(what="ptxas", design=tag, instance=name, registers=regs,
                      spill_stores=st, spill_loads=ld, stack_frame=frame))

    for label, kind, n, modes, n_half in CASES:  # CTAs a SM holds, by the occupancy API
        route = bps.POINTS if kind.endswith("tensor") else bps.GRID4
        n_tab = 16 if route == bps.POINTS else 4
        smem = designs["current"].bps_smem_bytes(n_half, N_PHASES, route, n_tab)
        emit(dict(what="occupancy", case=label, route=route, threads=N_PHASES, smem=smem,
                  ctas_per_sm=occupancy(route, n_tab, N_PHASES, smem)))

    if "sass" not in skip:  # the current kernel's machine code, for reading
        nvcc = _build._nvcc()
        cubin = build_dir / "bps.cubin"
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        f"-I{csrc}", "-cubin", "-o", str(cubin), str(csrc / "bps.cu")],
                       check=True)
        text = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
                              capture_output=True, text=True, check=True).stdout
        dest = Path(args.out).parent / "bps.sass"
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(text)
        emit(dict(what="sass", source="bps.cu", file=str(dest), lines=text.count("\n")))

    rng = np.random.default_rng(14)
    inputs = {}
    for label, kind, n, modes, n_half in CASES:
        c = chip_smoke._bps_const(kind)
        sig = torch.as_tensor(chip_smoke._noisy(rng, n, modes, np.asarray(c)), device=dev)
        m_points = None if isinstance(c, np.ndarray) else len(c)
        inputs[label] = (sig, n_half, c, chip_smoke._bound(
            *chip_smoke._bps_cost(n, modes, N_PHASES, m_points)))

    def timed(label, design, reps=20, **kw):
        sig, n_half, c, (bound_ms, bound_by) = inputs[label]
        mod = parent if design == "parent" else bps
        if kw:
            def fn():
                return bps._launch(sig, n_half, c, N_PHASES, bps._OUT_PHASE, **kw)
        else:
            def fn():
                return mod.bps_kernel(sig, n_half, c, N_PHASES)
        ms = chip_smoke._cuda_ms(fn, reps)
        mhz = chip_smoke._sm_clock_mhz()
        idx = mod.bps_indices(sig, n_half, c, N_PHASES) if not kw else None
        torch.cuda.synchronize()
        emit(dict(what="kernel", case=label, design=design, ms=ms, sm_clock_mhz=mhz,
                  cycles_per_symbol=ms * 1e-3 * mhz * 1e6 / sig.numel(), bound_ms=bound_ms,
                  bound_by=bound_by, bound_share=bound_ms / ms, **kw))
        return idx

    ok = True
    if "turns" not in skip:
        for label in inputs:
            outs = [timed(label, d) for d in ("parent", "current", "current", "parent")]
            sig, n_half, c, _ = inputs[label]
            plain = bps.bps_indices_plain(sig, n_half, c, N_PHASES)
            plain_ms = chip_smoke._cuda_ms(lambda: bps.bps_indices_plain(sig, n_half, c, N_PHASES),
                                           3)
            same_p = bool(torch.equal(outs[0], outs[3]))
            same_c = bool(torch.equal(outs[1], outs[2]))
            vs_plain = int((outs[1] != plain).sum())
            vs_parent = float((outs[0] != outs[1]).float().mean())
            good = same_p and same_c and vs_plain == 0 and vs_parent < NEAR_TIE
            ok &= good
            emit(dict(what="parent_vs_current", case=label, plain_ms=plain_ms,
                      parent_turns_equal=same_p, current_turns_equal=same_c,
                      current_vs_plain_mismatches=vs_plain, parent_vs_current_share=vs_parent,
                      ok=good))
    if "runs" not in skip:  # output blocks per CTA: the same bits at any run length
        ref = bps.bps_kernel(*inputs["chain"][:3], N_PHASES)
        for rb in RUN_BLOCKS:
            timed("chain", "current", run_blocks=rb)
            out = bps._launch(*inputs["chain"][:3], N_PHASES, bps._OUT_PHASE, run_blocks=rb)
            same = bool(torch.equal(out, ref))
            ok &= same
            emit(dict(what="run_blocks", case="chain", run_blocks=rb, equal_bits=same, ok=same))
    if "profile" not in skip:  # the kernel's own device time, without the host's gaps
        for label in inputs:
            sig, n_half, c, (bound_ms, _) = inputs[label]
            for design, mod in (("parent", parent), ("current", bps)):
                ms, per_call = chip_smoke._device_ms(
                    lambda: mod.bps_kernel(sig, n_half, c, N_PHASES), "bps_kernel", 20)
                emit(dict(what="device_time", case=label, design=design, kernel_us=ms * 1e3,
                          device_kernels_per_call=per_call, bound_share=bound_ms / ms))
        sig, n_half, c, (bound_ms, _) = inputs["chain"]
        for rb in (0, *RUN_BLOCKS):
            ms, _ = chip_smoke._device_ms(
                lambda: bps._launch(sig, n_half, c, N_PHASES, bps._OUT_PHASE, run_blocks=rb),
                "bps_kernel", 20)
            emit(dict(what="device_time", case="chain", design="current", run_blocks=rb,
                      kernel_us=ms * 1e3, bound_share=bound_ms / ms))
    for tag, _, exact in variants:  # the same calls on a variant build, in turns with current
        for label in inputs:
            sig, n_half, c, (bound_ms, _) = inputs[label]
            outs = {}
            for design in ("current", tag, "current"):
                _build._lib = designs[design]
                ms, _ = chip_smoke._device_ms(
                    lambda: bps.bps_kernel(sig, n_half, c, N_PHASES), "bps_kernel", 20)
                outs[design] = bps.bps_kernel(sig, n_half, c, N_PHASES)
                emit(dict(what="device_time", case=label, design=design, kernel_us=ms * 1e3,
                          bound_share=bound_ms / ms))
            _build._lib = designs["current"]
            if exact:
                same = bool(torch.equal(outs[tag], outs["current"]))
                ok &= same
                emit(dict(what="variant_vs_current", case=label, design=tag, equal_bits=same,
                          ok=same))
    if "fixed" not in skip:  # one block of one mode: the launch and host cost of a call
        sig = inputs["chain"][0][:75, :1].contiguous()
        c = inputs["chain"][2]
        for design, mod in (("parent", parent), ("current", bps)):
            ms = chip_smoke._cuda_ms(lambda: mod.bps_kernel(sig, 37, c, N_PHASES), 200)
            t1 = time.perf_counter()
            for _ in range(200):
                mod.bps_kernel(sig, 37, c, N_PHASES)
            host_us = (time.perf_counter() - t1) / 200 * 1e6
            torch.cuda.synchronize()
            emit(dict(what="fixed_cost", design=design, n=75, modes=1, ms=ms,
                      host_us_per_call=host_us))

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))
    print(f"wrote {args.out} ({len(records)} records; {'ok' if ok else 'NOT ok'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
