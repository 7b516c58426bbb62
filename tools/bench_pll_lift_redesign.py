"""K7 (``csrc/ddpll.cu``) and K12 (``csrc/lift.cu``) against the parent
commit's kernels and design variants, on one GPU, in one process.

Builds, besides the package's library, one library per design to compare:
the parent commit's ``ddpll.cu`` and ``lift.cu`` (from a checkout given by
``--parent``, entry points renamed ``*_parent``) and variants: copies of a
source with one edit. A variant computes the same function another way and
is compared with the current kernel bit for bit:
- K7: ``sinf`` + ``cosf`` in place of ``sincosf``, one lane per column in
  place of a lane pair (with a 128-row chunk, which is what fits), the step loop not unrolled or unrolled by 2 or 8
  in place of 4, a 128-row staging chunk in place of 256;
- K12: (a) the three phases in one cooperative launch with grid-wide
  barriers, (c) the parent's one-CTA-per-8-codewords layout with 128 rows
  per CTA in place of 32, and 8 edges' loads issued together in phases 2
  and 3 in place of 4.
(b), three launches per iteration, is the shipped design. A probe takes one
part of K7's step out (the sine and cosine, the division, the quantizer;
its outputs are not the function's and are not compared). A design is swapped in for the wrappers of ``kernels/ddpll.py``
and ``kernels/lift.py`` by standing in for the library that
``_build.load_library`` returns, so every design runs through the same
wrappers on the same inputs (the parent's K12 entry has no check-degree
argument; a shim drops it).

Inputs are the paths' own: K7 gets the arguments ``cpr`` gives it on
``chip_smoke.py``'s path C (22 columns of the served symbols, a pilot every
32nd) and ``phase_clock_pll_kernels``' synthetic 65,536 x 22 16-QAM case,
and an 8-PSK case (the argmin slicer); K12 the arguments ``decode_ldpc``
gives it in the third iteration of path G (AR4JA 8192 R1/2, B = 1024,
bfloat16), of the same decode at float32, and of 802.11n 1944 R1/2 (L = 81)
at bfloat16 and float32. In turns (parent, current, current, parent) each
case is timed with CUDA events and the SM clock read after each window; K7
prints cycles per symbol, K12 its share of ``chip_smoke._k12_cost``'s
bound; path G's whole decode is timed the same way. Then each variant and
probe beside the current design; the dependent-chain latencies of
``sinf``, ``cosf`` and ``sincosf`` (``tools/trig_probe.cu``), a check of
``sincosf`` against ``sinf`` / ``cosf`` and of ``torch.sin`` /
``torch.cos`` against ``sinf`` / ``cosf`` on every float32 input; the
``-Xptxas -v`` registers, spills and stack frames of every K7 / K12
instance; and ``cuobjdump -sass`` of the parent's and the current K7
(written beside ``--out``); last, a torch.profiler breakdown of each K12
case by phase and of path G's decode into K12 and the torch ops around it.
Prints one JSON object per measurement and writes them all to ``--out``.

Usage: git archive <parent> opticommpy_torch/csrc | tar -x -C build/parent
       python3 tools/bench_pll_lift_redesign.py --parent build/parent
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from bench_eq_redesign import _compile  # noqa: E402
from opticommpy_torch.kernels import _build, ddpll, lift  # noqa: E402

ENTRIES = ("ddpll_launch", "lift_iter_launch")
K7_CASES = ("K7 path C 22 cols", "K7 16-QAM 65536x22", "K7 8-PSK 16384x22")
K12_CASES = ("K12 path G AR4JA bf16", "K12 AR4JA f32", "K12 802.11n L81 bf16",
             "K12 802.11n L81 f32")
PATH_G = "path G decode AR4JA bf16"

_K7_TRIG = "      float s, c;\n      sincosf(phi, &s, &c);"
_K7_LANES = "constexpr int kLanes = 2;"
_K7_PAIR_Q = "        const float own = quantize(odd ? eo_im : eo_re, lo, step, top);"
_K7_PAIR = (_K7_PAIR_Q + "\n        const float other = __shfl_xor_sync(0xffffffffu, own, 1);"
            "\n        d_re = odd ? other : own;\n        d_im = odd ? own : other;")
_K7_LOOP = "#pragma unroll 4\n    for (int r = 0; r < len; ++r) {"
_K7_CHUNK = "constexpr int kChunk = 256;"
_K7_DIV = "  float k = rintf(__fdiv_rn(__fsub_rn(x, lo), step));"
_K12_RUN_START = "template <typename T, int VW, int DMAX>\nint run("
_K12_RUN_END = "bool aligned16("
# (a): the three phases as device functions of one cooperative kernel
_K12_COOP_RUN = """template <typename T, int VW, int DMAX>
__global__ void __launch_bounds__(kThreads)
lift_coop_kernel(const T* x, const float* llr, const int* cg_off, const int* c_e,
                 const int* c_v, const int* c_sh, const int* vg_off, const int* v_e,
                 const int* v_sh, int V, int C, int B, int nvec, int LN, int use_alpha,
                 float alpha, T* m, T* xo, float* t, int* ok) {
  auto grid = cooperative_groups::this_grid();
  lift_check_kernel<T, VW, DMAX>(x, cg_off, c_e, C, B, LN, use_alpha, alpha, m, ok);
  grid.sync();
  lift_var_kernel<T, VW>(m, llr, vg_off, v_e, v_sh, V, nvec, LN, t);
  grid.sync();
  lift_out_kernel<T, VW>(t, m, cg_off, c_e, c_v, c_sh, C, nvec, LN, xo, ok);
}

template <typename T, int VW, int DMAX>
int run(int L, int V, int C, int B, int use_alpha, float alpha, const void* x,
        const void* llr, const void* cg_off, const void* c_e, const void* c_v,
        const void* c_sh, const void* vg_off, const void* v_e,
        const void* v_sh, void* m, void* xo, void* t, void* ok,
        cudaStream_t s) {
  int nvec = B / VW, LN = L * nvec;
  const T* xp = (const T*)x;
  const float* lp = (const float*)llr;
  const int *a0 = (const int*)cg_off, *a1 = (const int*)c_e, *a2 = (const int*)c_v,
            *a3 = (const int*)c_sh, *a4 = (const int*)vg_off, *a5 = (const int*)v_e,
            *a6 = (const int*)v_sh;
  T *mp = (T*)m, *xop = (T*)xo;
  float* tp = (float*)t;
  int* okp = (int*)ok;
  void* args[] = {&xp, &lp, &a0, &a1, &a2, &a3, &a4, &a5, &a6, &V, &C, &B, &nvec, &LN,
                  &use_alpha, &alpha, &mp, &xop, &tp, &okp};
  const long long items = (long long)(C > V ? C : V) * LN;
  return (int)cudaLaunchCooperativeKernel(
      (const void*)lift_coop_kernel<T, VW, DMAX>,
      dim3(grid_for<lift_coop_kernel<T, VW, DMAX>>(items)), dim3(kThreads), args, 0, s);
}

"""
_K12_COOP = [("#include <cstdint>\n", "#include <cstdint>\n\n#include <cooperative_groups.h>\n")] + [
    (f"__global__ void __launch_bounds__(kThreads)\n{name}(",
     f"__device__ __forceinline__ void\n{name}(")
    for name in ("lift_check_kernel", "lift_var_kernel", "lift_out_kernel")] + [
    ((_K12_RUN_START, _K12_RUN_END), _K12_COOP_RUN)]
# variants, the same function: (tag, "parent" or "current", source, edits, cases)
# an edit is (before, after) or ((start, end), text replacing start .. end)
VARIANTS = (
    ("k7_sinf_cosf", "current", "ddpll.cu",
     [(_K7_TRIG, "      const float c = cosf(phi);\n      const float s = sinf(phi);")],
     K7_CASES[:2]),
    ("k7_lanes1", "current", "ddpll.cu", [  # 32 columns a warp: half the chunk fits
        (_K7_LANES, _K7_LANES.replace("2", "1")),
        (_K7_CHUNK, _K7_CHUNK.replace("256", "128")),
        (_K7_PAIR, "        d_re = quantize(eo_re, lo, step, top);\n"
                   "        d_im = quantize(eo_im, lo, step, top);")], K7_CASES),
    *((f"k7_unroll{u}", "current", "ddpll.cu", [(_K7_LOOP, _K7_LOOP.replace("4", str(u), 1))],
       K7_CASES[:2]) for u in (1, 2, 8)),
    ("k7_chunk128", "current", "ddpll.cu", [(_K7_CHUNK, _K7_CHUNK.replace("256", "128"))],
     K7_CASES[:2]),
    ("k12_a_coop", "current", "lift.cu", _K12_COOP, K12_CASES),
    ("k12_c_rows128", "parent", "lift.cu",
     [("constexpr int kRows = 32;", "constexpr int kRows = 128;")], K12_CASES),
    ("k12_batch8", "current", "lift.cu",
     [("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")], K12_CASES[:3]),
)
# probes of the current K7 step, each taking one part out: (tag, "current",
# source, edits, cases)
PROBES = (
    ("k7p_no_trig", "current", "ddpll.cu",
     [(_K7_TRIG, "      const float s = __fmul_rn(phi, 0.0f), c = __fadd_rn(s, 1.0f);")],
     K7_CASES[:1]),
    ("k7p_no_div", "current", "ddpll.cu",
     [(_K7_DIV, "  float k = rintf(__fmul_rn(__fsub_rn(x, lo), step));")], K7_CASES[:1]),
    ("k7p_no_slicer", "current", "ddpll.cu",
     [(_K7_PAIR_Q, "        const float own = odd ? eo_im : eo_re;")], K7_CASES[:1]),
)
TRIG_CASES = ("fadd", "sinf", "cosf", "sincosf + fadd", "sinf + cosf + fadd")


def _apply(text, edits, tag):
    for before, after in edits:
        if isinstance(before, tuple):
            start, end = before
            i, j = text.find(start), text.find(end)
            if i < 0 or j < i:
                raise RuntimeError(f"{tag}: {start!r} .. {end!r} not found")
            text = text[:i] + after + text[j:]
        else:
            if before not in text:
                raise RuntimeError(f"{tag}: {before!r} not found")
            text = text.replace(before, after)
    return text


class _Design:
    """Stands in for the package's library with one design's K7 / K12 entry
    points (suffix ``tag``); every other entry is the package's."""

    def __init__(self, base, lib, tag, parent_lift=False):
        self._base = base
        self._fns = {}
        for entry in ENTRIES:
            fn = getattr(lib, f"{entry}_{tag}", None)
            if fn is None:
                continue
            fn.restype = ctypes.c_int
            if entry == "lift_iter_launch" and parent_lift:
                # the parent's entry: no check-degree argument before the stream
                sig = _build._SIGNATURES[entry]
                fn.argtypes = sig[:-2] + sig[-1:]
                self._fns[entry] = (lambda f: lambda *a: f(*a[:-2], a[-1]))(fn)
            else:
                fn.argtypes = _build._SIGNATURES[entry]
                self._fns[entry] = fn

    def __getattr__(self, name):
        return self._fns.get(name) or getattr(self._base, name)


def _ptxas(log):
    """[(instance, registers, spill stores, spill loads, stack frame bytes)]
    of the K7 and K12 kernels in an nvcc -Xptxas -v log."""
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
        if m and name and ("ddpll" in name or "lift" in name):
            rows.append((name, int(m.group(1)), *spills, frame))
    return rows


def _k7_inputs(dev):
    """{case: (n_sym, args of ddpll.ddpll_phases)}."""
    from opticommpy_torch.comm.modulation import norm_const
    from opticommpy_torch.dsp import CPRConfig, cpr, mimo_adapt_equalizer_batch
    from opticommpy_torch.dsp.equalization import mimo_apply_fused
    from opticommpy_torch.dsp import MIMOEqualizerConfig

    const = norm_const(16, "qam")
    cases = {}
    # path C: taps trained as chip_smoke.run_serve_path_c trains them, the
    # served symbols of the 11 channels as 22 columns
    res, _ = chip_smoke.run_main_path(dev)
    x_b, front_b, ref_b, scale_b, pulse2, edc_cfg = chip_smoke.serve_inputs(res)
    n_ch, n_sym = ref_b.shape[0], ref_b.shape[1]
    eq_cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
                                 L=(12000, n_sym - 12000), M=16, numIter=2, backend="pallas")
    _, H_b, _ = mimo_adapt_equalizer_batch(front_b, eq_cfg, symb_ref=ref_b, return_results=True)
    y_cols = torch.stack([mimo_apply_fused(H_b[k], x_b[k], 2, pre=pulse2, edc_config=edc_cfg,
                                           scale=scale_b[k]) for k in range(n_ch)],
                         dim=1).reshape(n_sym, 2 * n_ch)
    r_cols = ref_b.transpose(0, 1).reshape(n_sym, 2 * n_ch)
    cfg = CPRConfig(alg="ddpll-pallas", M=16, Ts=1 / 32e9, runFOE=False)
    with mock.patch.object(ddpll, "ddpll_phases", wraps=ddpll.ddpll_phases) as spy:
        cpr(y_cols, cfg, symb_tx=r_cols, pilot_ind=np.arange(0, n_sym, chip_smoke.PILOT_EVERY))
    args = spy.call_args.args
    cases[K7_CASES[0]] = (args[0].shape[0], args)
    del res, x_b, front_b
    # phase 3's synthetic case and 8-PSK
    loop = (1 / 32e9, 0.1, 1 / (2 * np.pi * 10e6), 1 / (2 * np.pi * 10e6))
    psk = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    for label, c, n, seed in ((K7_CASES[1], const, 65536, 62), (K7_CASES[2], psk, 16384, 63)):
        r = np.random.default_rng(seed)
        tx = c[r.integers(0, len(c), size=(n, 22))]
        phi = np.cumsum(r.normal(scale=np.sqrt(2 * np.pi * 2e-6), size=(n, 22)), axis=0)
        noise = 0.05 * (r.normal(size=(n, 22)) + 1j * r.normal(size=(n, 22)))
        xs = torch.as_tensor((tx * np.exp(1j * phi) + noise).astype(np.complex64), device=dev)
        ref = torch.as_tensor(tx.astype(np.complex64), device=dev)
        pilot = torch.zeros(n, device=dev)
        pilot[::chip_smoke.PILOT_EVERY] = 1.0
        cases[label] = (n, (xs, ref, pilot, c, *loop))
    return cases


def _k12_inputs(dev):
    """{case: (bound_ms, args of lift.lift_iter)} from the third iteration of
    each decode, and path G's (llr, graph, config) for the whole decode."""
    from opticommpy_torch.comm.fec import LDPCConfig, decode_ldpc, standard_ldpc
    from opticommpy_torch.comm.fec_lift import lift_tables

    cases = {}
    graph, _ = standard_ldpc("AR4JA", 8192, "1/2")
    llr = chip_smoke._path_g_llrs(dev, graph["n"], 1024)
    g80211, _ = standard_ldpc("IEEE_802.11nD2", 1944, "1/2")
    llr80211 = chip_smoke._zero_codeword_llrs(dev, 1944, 1024, -1.5, 0.0, 11)
    for label, g, x, mdt, code in (
            (K12_CASES[0], graph, llr, "bf16", ("AR4JA", 8192, "1/2")),
            (K12_CASES[1], graph, llr, "f32", ("AR4JA", 8192, "1/2")),
            (K12_CASES[2], g80211, llr80211, "bf16", ("IEEE_802.11nD2", 1944, "1/2")),
            (K12_CASES[3], g80211, llr80211, "f32", ("IEEE_802.11nD2", 1944, "1/2"))):
        cfg = LDPCConfig(maxIter=20, alg="NMSA", msgDtype=mdt)
        with mock.patch.object(lift, "lift_iter", wraps=lift.lift_iter) as spy:
            decode_ldpc(x, graph=g, config=cfg)
        a = spy.call_args_list[2].args
        bound = chip_smoke._bound(*chip_smoke._k12_cost(lift_tables(*code), x.shape[1], mdt))[0]
        cases[label] = (bound, a)
    path_g = (llr, graph, LDPCConfig(maxIter=20, alg="NMSA", msgDtype="bf16"))
    return cases, path_g


def _latencies(lib, dev, emit, n=2048):
    """SM cycles per dependent repetition of each case of tools/trig_probe.cu."""
    lib.trig_latency_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.trig_latency_launch.restype = ctypes.c_int
    if lib.trig_cases() != len(TRIG_CASES):
        raise RuntimeError("tools/trig_probe.cu and TRIG_CASES disagree")
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.zeros(32, dtype=torch.float32, device=dev)
    for which, name in enumerate(TRIG_CASES):
        per = []
        for _ in range(3):
            _build.check(lib.trig_latency_launch(which, n, 1.0000001, _build.ptr(cycles),
                                                 _build.ptr(out), _build.stream_ptr(dev)),
                         "trig_latency_launch")
            torch.cuda.synchronize()
            per.append(int(cycles.item()) / n)
        emit(dict(what="latency", case=name, cycles_per_rep=min(per), reps=n))


def _trig_checks(lib, dev, emit):
    """sincosf against sinf / cosf, and torch.sin / torch.cos against sinf /
    cosf, on every float32 input (NaN against NaN counts as equal)."""
    lib.sincos_check_launch.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong,
                                        ctypes.c_void_p, ctypes.c_void_p]
    lib.sincos_check_launch.restype = ctypes.c_int
    lib.trig_eval_launch.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.trig_eval_launch.restype = ctypes.c_int
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    _build.check(lib.sincos_check_launch(0, 1 << 32, _build.ptr(counts),
                                         _build.stream_ptr(dev)), "sincos_check_launch")
    torch.cuda.synchronize()
    emit(dict(what="sincosf_vs_sinf_cosf", inputs=1 << 32, sin_differs=int(counts[0]),
              cos_differs=int(counts[1]), s=time.perf_counter() - t0))
    chunk = 1 << 28
    s_k = torch.empty(chunk, dtype=torch.float32, device=dev)
    c_k = torch.empty_like(s_k)
    differ = [0, 0]
    worst = [0.0, 0.0]
    t0 = time.perf_counter()
    for start in range(0, 1 << 32, chunk):
        bits = torch.arange(start, start + chunk, dtype=torch.int64, device=dev)
        x = (bits - (bits >= 1 << 31).long() * (1 << 32)).to(torch.int32).view(torch.float32)
        del bits
        _build.check(lib.trig_eval_launch(start, chunk, _build.ptr(s_k), _build.ptr(c_k),
                                          _build.stream_ptr(dev)), "trig_eval_launch")
        for i, (fn, k) in enumerate(((torch.sin, s_k), (torch.cos, c_k))):
            t = fn(x)
            bad = (t.view(torch.int32) != k.view(torch.int32)) & ~(torch.isnan(t)
                                                                     & torch.isnan(k))
            differ[i] += int(bad.sum())
            if bool(bad.any()):
                worst[i] = max(worst[i], float((t[bad] - k[bad]).abs().max()))
        del x, t
    emit(dict(what="torch_vs_sinf_cosf", inputs=1 << 32, sin_differs=differ[0],
              cos_differs=differ[1], sin_max_abs_diff=worst[0], cos_max_abs_diff=worst[1],
              torch=torch.__version__, s=time.perf_counter() - t0))


def _profile(label, fn, emit):
    """Device time by kernel of one call of ``fn`` (torch.profiler): K12's
    three phases and everything else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key[:90]] = (e.self_device_time_total, e.count)
    k12 = sum(us for name, (us, _) in by_name.items() if "lift_" in name)
    busy = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit(dict(what="profile", case=label, wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
              k12_ms=k12 / 1e3, other_ms=(busy - k12) / 1e3,
              top=[dict(name=n, ms=us / 1e3, count=c) for n, (us, c) in top]))


def _sass(files, out_dir, emit):
    """cuobjdump -sass of each (tag, source, include dir) K7 build, written
    to out_dir/<tag>.sass; the instruction count of each kernel."""
    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    for tag, src, inc in files:
        cubin = out_dir / f"{tag}.cubin"
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        f"-I{inc}", "-cubin", "-o", str(cubin), str(src)], check=True)
        text = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True,
                              text=True, check=True).stdout
        (out_dir / f"{tag}.sass").write_text(text)
        emit(dict(what="sass", design=tag, file=str(out_dir / f"{tag}.sass"),
                  instructions=len(re.findall(r"/\*[0-9a-f]{4}\*/", text))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="checkout of the parent commit")
    ap.add_argument("--out", default="build/pll_lift_redesign.json")
    ap.add_argument("--skip", default="",
                    help="comma-separated: turns, variants, probes, latency, checks, sass, "
                         "profile, k7, k12")
    args = ap.parse_args()
    skip = set(filter(None, args.skip.split(",")))

    dev = chip_smoke.phase_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    base = _build.load_library()
    csrc = ROOT / "opticommpy_torch" / "csrc"
    old = Path(args.parent) / "opticommpy_torch" / "csrc"
    jobs = [("parent", [old / "ddpll.cu", old / "lift.cu"],
             [f"-I{old}", *(f"-D{e}={e}_parent" for e in ENTRIES)])]
    variants = [] if "variants" in skip else VARIANTS
    probes = [] if "probes" in skip else PROBES
    out_dir = Path(args.out).parent / "pll_lift_designs"
    build_dir = ROOT / "build" / "pll_lift_designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    build_dir.mkdir(parents=True, exist_ok=True)
    for tag, which, src, edits, _ in (*variants, *probes):
        folder = old if which == "parent" else csrc
        (build_dir / f"{tag}.cu").write_text(_apply((folder / src).read_text(), edits, tag))
        entry = "ddpll_launch" if src == "ddpll.cu" else "lift_iter_launch"
        jobs.append((tag, [build_dir / f"{tag}.cu"], [f"-I{folder}", f"-D{entry}={entry}_{tag}"]))
    if "latency" not in skip or "checks" not in skip:
        jobs.append(("trig", [ROOT / "tools" / "trig_probe.cu"], []))
    libs, logs = _compile(jobs, build_dir)
    logs["current"] = _build.build_info.get("log", "")  # empty if built by another process
    trig_lib = libs.pop("trig", None)
    parent_of = {tag: which == "parent" for tag, which, *_ in (*variants, *probes)}
    designs = {name: _Design(base, lib, name, parent_lift=name == "parent" or parent_of.get(name))
               for name, lib in libs.items()}
    records = [dict(what="device", smi=smi, build_s=time.perf_counter() - t0,
                    package_nvcc_s=_build.build_info.get("seconds"))]

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    for tag in logs:
        for name, regs, st, ld, frame in _ptxas(logs[tag]):
            emit(dict(what="ptxas", design=tag, instance=name, registers=regs,
                      spill_stores=st, spill_loads=ld, stack_frame=frame))
    if "sass" not in skip:
        _sass([("parent_ddpll", old / "ddpll.cu", old), ("current_ddpll", csrc / "ddpll.cu", csrc)],
              out_dir, emit)
    if trig_lib is not None and "latency" not in skip:
        _latencies(trig_lib, dev, emit)
    if trig_lib is not None and "checks" not in skip:
        _trig_checks(trig_lib, dev, emit)

    def use(design):
        _build._lib = base if design == "current" else designs[design]

    inputs, path_g = {}, None
    if "k7" not in skip:
        inputs.update(_k7_inputs(dev))
    if "k12" not in skip:
        k12, path_g = _k12_inputs(dev)
        inputs.update(k12)
    torch.cuda.empty_cache()

    def timed(label, design, reps=None):
        use(design)
        if label == PATH_G:
            from opticommpy_torch.comm.fec import decode_ldpc

            llr, graph, cfg = path_g
            fn = lambda: decode_ldpc(llr, graph=graph, config=cfg)  # noqa: E731
            reps = reps or 3
        elif label in K7_CASES:
            fn = lambda: ddpll.ddpll_phases(*inputs[label][1])  # noqa: E731
            reps = reps or 3
        else:
            fn = lambda: lift.lift_iter(*inputs[label][1])  # noqa: E731
            reps = reps or 20
        ms = chip_smoke._cuda_ms(fn, reps)
        mhz = chip_smoke._sm_clock_mhz()
        out = fn()
        out = [t.cpu() for t in (out if isinstance(out, tuple) else (out,))]
        rec = dict(what="kernel", case=label, design=design, ms=ms, sm_clock_mhz=mhz,
                   finite=all(bool(torch.isfinite(t.float()).all()) for t in out
                              if t.is_floating_point()))
        if label in K7_CASES:
            rec["cycles_per_symbol"] = ms * 1e-3 / inputs[label][0] * mhz * 1e6
        elif label != PATH_G:
            rec["bound_ms"] = inputs[label][0]
            rec["bound_share"] = inputs[label][0] / ms
        emit(rec)
        return out

    labels = [lb for lb in (*K7_CASES, *K12_CASES) if lb in inputs]
    if path_g is not None:
        labels.append(PATH_G)
    if "turns" not in skip:
        for label in labels:
            outs = {}
            for design in ("parent", "current", "current", "parent"):
                outs[design] = timed(label, design)
            emit(dict(what="parent_vs_current", case=label,
                      equal=all(bool(torch.equal(a, b))
                                for a, b in zip(outs["parent"], outs["current"]))))

    # each variant and probe beside the current design
    variant_tags = {tag for tag, *_ in variants}
    by_case = {}
    for tag, *_, cases in (*variants, *probes):
        for label in cases:
            if label in inputs:
                by_case.setdefault(label, []).append(tag)
    for label, tags in by_case.items():
        cur = timed(label, "current")
        for tag in tags:
            out = timed(label, tag)
            if tag in variant_tags:  # the same function
                emit(dict(what="variant_vs_current", case=label, design=tag,
                          equal=all(bool(torch.equal(a, b)) for a, b in zip(out, cur))))
        timed(label, "current")
    use("current")
    if "profile" not in skip:
        for label in labels:
            if label == PATH_G:
                from opticommpy_torch.comm.fec import decode_ldpc

                llr, graph, cfg = path_g
                _profile(label, lambda: decode_ldpc(llr, graph=graph, config=cfg), emit)
            elif label in K12_CASES:
                _profile(label, lambda: lift.lift_iter(*inputs[label][1]), emit)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))
    print(f"wrote {args.out} ({len(records)} records)")


if __name__ == "__main__":
    sys.exit(main())
