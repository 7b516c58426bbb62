"""K14 (``csrc/volterra.cu``) and K11 (``csrc/qc_mega.cu``) against the
parent commit's kernels and design variants, on one GPU, in one process.

Builds, besides the package's library, the parent commit's ``volterra.cu``
and ``qc_mega.cu`` (from a checkout given by ``--parent``, entry points
renamed ``*_parent``) and variants: copies of a current source with one
edit. The parent's kernels run through the parent's own wrappers
(``kernels/volterra.py``, ``kernels/qc_mega.py`` of the checkout, loaded
beside the package's, their library swapped for the parent build); the
current design and each variant through the package's wrappers, the
library that ``_build.load_library`` returns standing in for the design.

Inputs are the paths' own: K14 gets the arguments ``volterra_kernel`` gives
it on ``chip_smoke.py``'s path H (8 links x 65,536 PAM4 symbols at SpS 2,
order 3, 13 / 7 / 5 taps; also with every symbol and with no symbol in
the training range, which time the adapting loop and the fixed-tap range
alone) and the K14 phase's 8 x 16,384 signals (order 3 and 2, and order 3
fulltime); K11 path E's 512 DVB-S2 R4/5 codewords at 2.3 dB, NMSA-20: bf16
flooding with early exit (the serving configuration of ``decode_ldpc``),
bf16 fixed, bf16 layered with early exit, f32 flooding with early exit. In
turns (parent, current, current, parent) each case is timed with CUDA
events and the SM clock read after each window; K14 prints cycles per
symbol, K11 its share of ``chip_smoke._k11_cost``'s bound. K11's outputs
must equal the parent's bit for bit in every turn (the same arithmetic);
K14 sums its taps in another order than the parent (its plain version
follows it), so its outputs are held to the parent's within 1e-5 and to
the same decisions, and each design's turns to each other bit for bit.

Variants (the same function, held to the current design bit for bit): K14
with the slicer's true division in place of the thresholds, with
``__fdiv_rn(g, 7)`` in place of the corrected reciprocal, with the
run-time layout's loop in place of a symbol per lane at a compiled
configuration, with one or eight warps a CTA in place of four, with the
adapting ranges on warp 0 alone in place of every warp; K11 with three
CTAs per SM in place of two. Also the ``-Xptxas -v`` registers, spills
and stack frames of every K14 / K11 instance of the parent and current
builds, and ``cuobjdump -sass`` of the current sources beside ``--out``.
Prints one JSON object per measurement and writes them all to ``--out``.

Usage: git archive <parent> opticommpy_torch | tar -x -C build/parent
       python3 tools/bench_volterra_mega_redesign.py --parent build/parent
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
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from bench_eq_redesign import _compile  # noqa: E402
from opticommpy_torch.kernels import _build, qc_mega, volterra  # noqa: E402

ENTRIES = ("volterra_launch", "qc_mega_launch")
K14_CASES = ("K14 path H 8x65536 order 3", "K14 8x16384 order 3", "K14 8x16384 order 2",
             "K14 8x16384 order 3 fulltime", "K14 path H input, every symbol trains",
             "K14 path H input, no symbol trains")
K11_CASES = ("K11 R4/5 bf16 flooding early exit", "K11 R4/5 bf16 flooding fixed",
             "K11 R4/5 bf16 layered early exit", "K11 R4/5 f32 flooding early exit")
K14_ATOL = 1e-5  # tests/test_torch_volterra.py's pin against JAX

_K14_PICK = "  if (DECIDE == kPick4) return pick<4>(y, c.thr, c.lev);"
_K14_DIVIDE = "  if (DECIDE == kPick4) return decide<kDivide>(y, r, c);"
_K14_DIV7 = "    const float gq = select(gsel == 0.0f, div7(g), g12);"
_K14_WARPS = "constexpr int kWarps = 4;"
_K14_COMPILED = "if constexpr (CFG > 0)"
_K11_BUDGET = "constexpr int kBudget = 110 * 1024;"
# variants: (tag, source, edits, cases, same bits as the current design)
VARIANTS = (
    ("k14_divide_slicer", "volterra.cu", [(_K14_PICK, _K14_DIVIDE)], K14_CASES[::3], True),
    ("k14_fdiv7", "volterra.cu",
     [(_K14_DIV7, "    const float gq = select(gsel == 0.0f, __fdiv_rn(g, 7.0f), g12);")],
     K14_CASES[3:], True),
    ("k14_run_time_layout", "volterra.cu", [(_K14_COMPILED, "if constexpr (false)")],
     K14_CASES[:3], True),
    ("k14_adapt_warp0", "volterra.cu",
     [("    {  // every warp adapts, warp 0's thread 0 writing the outputs",
       "    if (tid < kWarp) {  // warp 0 adapts")], K14_CASES[::3], True),
    ("k14_one_warp", "volterra.cu", [(_K14_WARPS, _K14_WARPS.replace("4", "1"))],
     K14_CASES[::5], True),
    ("k14_eight_warps", "volterra.cu", [(_K14_WARPS, _K14_WARPS.replace("4", "8"))],
     K14_CASES[::5], True),
    ("k11_three_ctas", "qc_mega.cu", [(_K11_BUDGET, _K11_BUDGET.replace("110", "72"))],
     K11_CASES[:3], True),
)


def _apply(text, edits, tag):
    for before, after in edits:
        if before not in text:
            raise RuntimeError(f"{tag}: {before!r} not found")
        text = text.replace(before, after)
    return text


class _Lib:
    """Stands in for the package's library with one build's entry points
    (suffix ``tag``, argument types from ``sigs``); every other entry is
    the package's."""

    def __init__(self, base, lib, tag, sigs):
        self._base = base
        self._fns = {}
        for entry in ENTRIES:
            fn = getattr(lib, f"{entry}_{tag}", None)
            if fn is None:
                continue
            fn.argtypes = sigs.get(entry, [])
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
    of the K14 and K11 kernels in an nvcc -Xptxas -v log."""
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
        if m and name and ("volterra" in name or "qc_mega" in name):
            rows.append((name, int(m.group(1)), *spills, frame))
    return rows


def _k14_inputs(dev):
    """{case: (n_sym, args of volterra_run)}: path H's (the links built as
    chip_smoke.run_imdd_path_h builds them) and the K14 phase's."""
    from opticommpy_torch.dsp.equalization import VolterraConfig
    from opticommpy_torch.ops.signal import row_mean

    cases = {}
    i_b, ref_b = chip_smoke.imdd_links(dev)
    x2 = (i_b - row_mean(i_b)[:, None])[:, ::4].contiguous()
    vcfg = VolterraConfig(n1Taps=13, n2Taps=7, n3Taps=5, SpS=2, mu=1e-3, nTrain=4000, order=3,
                          M=4, constType="pam")
    with mock.patch.object(volterra, "volterra_run", wraps=volterra.volterra_run) as spy:
        volterra.volterra_kernel(x2, ref_b, vcfg)
    args = spy.call_args.args
    cases[K14_CASES[0]] = (args[3], args)
    # path H's input with the training range over every symbol (the adapting
    # loop alone) and over none (the fixed-tap range alone)
    cases[K14_CASES[4]] = (args[3], args[:11] + (args[3],) + args[12:])
    cases[K14_CASES[5]] = (args[3], args[:11] + (0,) + args[12:])
    del i_b, x2
    xv, sv = chip_smoke._nl_pam(8, 16384)
    for label, order, fulltime in ((K14_CASES[1], 3, False), (K14_CASES[2], 2, False),
                                   (K14_CASES[3], 3, True)):
        cfg = VolterraConfig(n1Taps=13, n2Taps=7, n3Taps=5, SpS=2, mu=1e-3, nTrain=4000,
                             order=order, M=4, constType="pam")
        sig_pad, ref, h0, n_out, _ = volterra.prepare(torch.as_tensor(xv, device=dev),
                                                      torch.as_tensor(sv, device=dev), cfg)
        cases[label] = (n_out, (sig_pad, ref, h0, n_out, 2, 13, 7, 5, order,
                                volterra._levels(4, "pam"), 1e-3, 4000, fulltime))
    return cases


def _k11_inputs(dev):
    """{case: (tables, args of qc_decode_mega)} on path E's LLRs."""
    from opticommpy_torch.comm import fec_qc
    from opticommpy_torch.kernels import qc

    _, _, llr = chip_smoke._path_e_llrs(dev)
    tb = fec_qc.qc_tables("4/5", 64800)
    lay = qc.QCLayout(tb, dev)
    li, lp = fec_qc._split_llrs(tb, llr)
    cases = {}
    for label, mdt, ee, sched in zip(K11_CASES, ("bf16", "bf16", "bf16", "f32"),
                                     (True, False, True, True),
                                     ("flooding", "flooding", "layered", "flooding")):
        cases[label] = (tb, (li, lp, lay, 21, 0.75, mdt, ee, sched))
    return cases


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="checkout of the parent commit")
    ap.add_argument("--out", default="build/volterra_mega_redesign.json")
    ap.add_argument("--skip", default="",
                    help="comma-separated: turns, variants, sass, k14, k11")
    args = ap.parse_args()
    skip = set(filter(None, args.skip.split(",")))

    dev = chip_smoke.phase_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    base = _build.load_library()
    csrc = ROOT / "opticommpy_torch" / "csrc"
    old = Path(args.parent) / "opticommpy_torch"
    jobs = [("parent", [old / "csrc" / "volterra.cu", old / "csrc" / "qc_mega.cu"],
             [f"-I{old / 'csrc'}", *(f"-D{e}={e}_parent" for e in ENTRIES)]),
            ("current", [csrc / "volterra.cu", csrc / "qc_mega.cu"],  # for its ptxas lines
             [f"-I{csrc}", *(f"-D{e}={e}_current" for e in ENTRIES)])]
    variants = [] if "variants" in skip else VARIANTS
    build_dir = ROOT / "build" / "volterra_mega_designs"
    build_dir.mkdir(parents=True, exist_ok=True)
    for tag, src, edits, _, _ in variants:
        (build_dir / f"{tag}.cu").write_text(_apply((csrc / src).read_text(), edits, tag))
        jobs.append((tag, [build_dir / f"{tag}.cu"],
                     [f"-I{csrc}", *(f"-D{e}={e}_{tag}" for e in ENTRIES)]))
    libs, logs = _compile(jobs, build_dir)
    del libs["current"]
    parent_sigs = _load(old / "kernels" / "_build.py", "parent_build")._SIGNATURES
    designs = {tag: _Lib(base, lib, tag, parent_sigs if tag == "parent" else _build._SIGNATURES)
               for tag, lib in libs.items()}
    # the parent's wrappers, on the parent build
    shim = types.SimpleNamespace(load_library=lambda: designs["parent"],
                                 **{n: getattr(_build, n) for n in
                                    ("check", "ptr", "stream_ptr", "device_tables")})
    parent_vol = _load(old / "kernels" / "volterra.py", "parent_volterra")
    parent_mega = _load(old / "kernels" / "qc_mega.py", "parent_qc_mega")
    parent_vol._build = parent_mega._build = shim
    records = [dict(what="device", smi=smi, build_s=time.perf_counter() - t0,
                    package_nvcc_s=_build.build_info.get("seconds"))]

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    for tag in logs:
        for name, regs, st, ld, frame in _ptxas(logs[tag]):
            emit(dict(what="ptxas", design=tag, instance=name, registers=regs,
                      spill_stores=st, spill_loads=ld, stack_frame=frame))

    if "sass" not in skip:  # the current kernels' machine code, for reading
        nvcc = _build._nvcc()
        cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
        for src in ("volterra.cu", "qc_mega.cu"):
            cubin = build_dir / f"{src}.cubin"
            subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                            "-O3", f"-I{csrc}", "-cubin", "-o", str(cubin), str(csrc / src)],
                           check=True)
            text = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True,
                                  text=True, check=True).stdout
            dest = Path(args.out).parent / f"{src}.sass"
            dest.parent.mkdir(parents=True, exist_ok=True)
            dest.write_text(text)
            emit(dict(what="sass", source=src, file=str(dest), lines=text.count("\n")))

    inputs = {}
    if "k14" not in skip:
        inputs.update(_k14_inputs(dev))
    if "k11" not in skip:
        inputs.update(_k11_inputs(dev))
    torch.cuda.empty_cache()

    def call(label, design):
        if design == "parent":
            mod = parent_vol if label in K14_CASES else parent_mega
        else:
            _build._lib = base if design == "current" else designs[design]
            mod = volterra if label in K14_CASES else qc_mega
        if label in K14_CASES:
            return lambda: mod.volterra_run(*inputs[label][1])
        return lambda: mod.qc_decode_mega(*inputs[label][1])

    def timed(label, design, reps=3):
        fn = call(label, design)
        ms = chip_smoke._cuda_ms(fn, reps)
        mhz = chip_smoke._sm_clock_mhz()
        out = [t.cpu() for t in fn()]
        _build._lib = base
        rec = dict(what="kernel", case=label, design=design, ms=ms, sm_clock_mhz=mhz)
        if label in K14_CASES:
            rec["cycles_per_symbol"] = ms * 1e-3 / inputs[label][0] * mhz * 1e6
        else:
            tb, a = inputs[label]
            steps = chip_smoke._k11_steps(out[3], out[2], a[3], a[6], a[7])
            bound = chip_smoke._bound(*chip_smoke._k11_cost(tb, a[5], steps, a[0].shape[-1],
                                                            a[7]))
            rec.update(bound_ms=bound[0], bound_by=bound[1], bound_share=bound[0] / ms)
        emit(rec)
        return out

    def compare(label, a, b):
        """(bit for bit, max |diff|, same decisions) of two designs' outputs."""
        same = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
        diff = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
        if label in K14_CASES:
            dec = bool(torch.equal(chip_smoke._pam_decisions(a[0]), chip_smoke._pam_decisions(b[0])))
        else:
            dec = bool(torch.equal(a[0] < 0, b[0] < 0)) and bool(torch.equal(a[1] < 0, b[1] < 0))
        return same, diff, dec

    labels = [lb for lb in (*K14_CASES, *K11_CASES) if lb in inputs]
    if "turns" not in skip:
        for label in labels:
            outs = [(design, timed(label, design))
                    for design in ("parent", "current", "current", "parent")]
            same_p = compare(label, outs[0][1], outs[3][1])[0]
            same_c = compare(label, outs[1][1], outs[2][1])[0]
            same, diff, dec = compare(label, outs[0][1], outs[1][1])
            ok = same_p and same_c and (same if label in K11_CASES else
                                        (diff <= K14_ATOL and dec))
            emit(dict(what="parent_vs_current", case=label, equal_bits=same, max_abs_diff=diff,
                      same_decisions=dec, parent_turns_equal=same_p,
                      current_turns_equal=same_c, ok=ok))
    for tag, _, _, cases, exact in variants:
        for label in cases:
            if label not in inputs:
                continue
            cur = timed(label, "current")
            out = timed(label, tag)
            timed(label, "current")
            same, diff, dec = compare(label, out, cur)
            emit(dict(what="variant_vs_current", case=label, design=tag, equal_bits=same,
                      max_abs_diff=diff, same_decisions=dec,
                      ok=same if exact else (diff <= K14_ATOL and dec)))

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))
    bad = [r for r in records if r.get("ok") is False]
    print(f"wrote {args.out} ({len(records)} records; {len(bad)} not ok)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
