"""The equalizer kernels of ``opticommpy_torch/csrc`` against earlier designs,
on one GPU, in one process.

Builds, besides the package's library, one library per design to compare:
the parent commit's ``mimo_eq.cu`` and ``rls.cu`` (from a checkout given by
``--parent``, entry points renamed ``*_parent``), and the current sources
with other lane or tile splits (``-DMIMO_EQ_G2=...``, ``-DRLS_R16=...
-DRLS_CC16=...``, entry points renamed by split). A design is swapped in
for the wrappers of ``kernels/mimo_eq.py`` and ``kernels/rls.py`` by
standing in for the library that ``_build.load_library`` returns, so every
design runs through the same wrappers on the same inputs.

Then, in turns (parent, current, current, parent), CUDA-event times of
  K2 da-rde, 12,000 symbols; K3 da-rde, B = 11 x 12,000; K5 rls and dd-rls,
  B = 11 x 12,000, lambda 0.99; K4 8-PSK dd-rls, 4,096 symbols
(chip_smoke.py's inputs) with the SM clock after each window and cycles
per symbol; the whole main-path chain, both batch chains and path A; and
each split of the current sources against the default split, and K5 with
one part of its step taken out by a probe edit. Prints one
JSON object per measurement and writes them all, with the ptxas registers
and spills of every equalizer instance (of the package's library where this
process built it), to ``--out``.

Usage: python3 tools/bench_eq_redesign.py --parent build/parent
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from opticommpy_torch.kernels import _build, mimo_eq, rls  # noqa: E402

# other splits of the current sources: (tag, source, defines, cases timed)
MAIN_EQ = ("K2 da-rde 12000", "K3 da-rde 11x12000")
MAIN_RLS = ("K5 rls 11x12000", "K5 dd-rls 11x12000")
SPLITS = (
    [(f"g2_{g}", "mimo_eq.cu", [f"-DMIMO_EQ_G2={g}"], MAIN_EQ) for g in (4, 8, 32)]
    + [(f"g4_{g}", "mimo_eq.cu", [f"-DMIMO_EQ_G4={g}"], ("K3 lms 4x15 11x4000",))
       for g in (8, 32)]
    + [("g8_16", "mimo_eq.cu", ["-DMIMO_EQ_G8=16"], ("K3 lms 8x32 11x2000",))]
    + [(f"t16_{r}x{c}", "rls.cu", [f"-DRLS_R16={r}", f"-DRLS_CC16={c}"], MAIN_RLS)
       for r, c in ((2, 2), (1, 1), (1, 2), (4, 1))]
    + [(f"t8_{r}x{c}", "rls.cu", [f"-DRLS_R8={r}", f"-DRLS_CC8={c}"],
        ("K5 rls 2x7 11x4000", "K5 rls 8x7 11x2000")) for r, c in ((2, 2), (2, 1))]
    + [(f"t32_{r}x{c}", "rls.cu", [f"-DRLS_R32={r}", f"-DRLS_CC32={c}"],
        ("K5 rls 2x32 11x2000",)) for r, c in ((4, 4), (4, 2))]
    + [(f"t32m8_{r}x{c}", "rls.cu", [f"-DRLS_R32_M8={r}", f"-DRLS_CC32_M8={c}"],
        ("K5 rls 8x32 11x1000",)) for r, c in ((2, 4), (8, 4))]
)
# probes: edits of the current rls.cu that take one part out of the
# symbol's step, timed on K5 rls beside it to see what that part costs
# (their outputs are not the function's and are not compared)
RLS_PROBES = (
    ("probe_mul_lam", [(f"__fdiv_rn(__fsub_rn({v}[r][cc], sub_{c}), a.lam)",
                        f"__fmul_rn(__fsub_rn({v}[r][cc], sub_{c}), 1.0f / a.lam)")
                       for v, c in (("sr", "re"), ("si", "im"))]),
    ("probe_rcp_den", [("__fdiv_rn(d_re, den)", "__fmul_rn(d_re, __frcp_rn(den))"),
                       ("__fdiv_rn(-d_im, den)", "__fmul_rn(-d_im, __frcp_rn(den))")]),
    ("probe_no_barrier", [("__syncthreads();  // the symbol's partials are visible", "")]),
)
ENTRIES = ("mimo_eq_launch", "rls_launch")


def _compile(jobs, out_dir):
    """Compile each (name, sources, defines) to ``out_dir/lib<name>.so``, all
    nvcc processes at once. Returns {name: ctypes library}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, sources, defines in jobs:
        lib = out_dir / f"lib{name}.so"
        cmd = [nvcc, *_build._NVCC_FLAGS, "-shared", *defines, "-o", str(lib),
               *map(str, sources)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name][-4000:]}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs, logs


class _Design:
    """Stands in for the package's library with one design's equalizer
    entry points (suffix ``tag``); every other entry is the package's."""

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
    """[(instance, registers, spill stores, spill loads)] of the equalizer
    kernels in an nvcc -Xptxas -v log."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and ("mimo_eq_kernel" in name or "rls_kernel" in name):
            rows.append((name, int(m.group(1)), *spills))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="checkout of the parent commit")
    ap.add_argument("--out", default="chiprun_out/eq_redesign.json")
    ap.add_argument("--no-chains", action="store_true")
    args = ap.parse_args()

    dev = chip_smoke.phase_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    base = _build.load_library()
    csrc = ROOT / "opticommpy_torch" / "csrc"
    old = Path(args.parent) / "opticommpy_torch" / "csrc"
    jobs = [("parent", [old / "mimo_eq.cu", old / "rls.cu"],
             [f"-D{e}={e}_parent" for e in ENTRIES])]
    jobs += [(tag, [csrc / src], [*defines, *(f"-D{e}={e}_{tag}" for e in ENTRIES),
                                  f"-Dmimo_eq_chunk=mimo_eq_chunk_{tag}",
                                  f"-Drls_chunk=rls_chunk_{tag}"])
             for tag, src, defines, _ in SPLITS]
    out_dir = ROOT / "build" / "eq_designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    for tag, edits in RLS_PROBES:
        text = (csrc / "rls.cu").read_text()
        for before, after in edits:
            if before not in text:
                raise RuntimeError(f"{tag}: {before!r} not in rls.cu")
            text = text.replace(before, after)
        (out_dir / f"{tag}.cu").write_text(text)
        jobs.append((tag, [out_dir / f"{tag}.cu"],
                     [f"-I{csrc}", f"-Drls_launch=rls_launch_{tag}", f"-Drls_chunk=rls_chunk_{tag}"]))
    libs, logs = _compile(jobs, out_dir)
    logs["current"] = _build.build_info.get("log", "")  # empty if built by another process
    designs = {name: _Design(base, lib, name) for name, lib in libs.items()}
    records = [dict(what="device", smi=smi, build_s=time.perf_counter() - t0)]
    for tag in logs:
        for name, regs, st, ld in _ptxas(logs[tag]):
            records.append(dict(what="ptxas", design=tag, instance=name, registers=regs,
                                spill_stores=st, spill_loads=ld))

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    def use(design):
        _build._lib = base if design == "current" else designs[design]

    from opticommpy_torch.comm.modulation import norm_const

    const = norm_const(16, "qam")
    psk = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    sig1, ref1 = chip_smoke._polmux(dev, const, 12000, 20)
    h1 = chip_smoke._spike(dev, 1)[0].permute(0, 2, 1).reshape(2, 30)
    sig11, ref11 = chip_smoke._polmux_batch(dev, const, 11, 12000, 200)
    h11 = chip_smoke._spike(dev, 11).permute(0, 1, 3, 2).reshape(11, 2, 30)
    sd11 = torch.eye(15, dtype=torch.complex64, device=dev).repeat(11, 2, 1, 1)
    h0_11 = chip_smoke._spike(dev, 11)
    sig_p, ref_p = chip_smoke._polmux(dev, psk, 4096, 300)
    aux = mimo_eq.stage_aux("da-rde", const)

    def modes_input(n_batch, n_sym, modes, taps, seed):
        """Padded (B, rows, modes) 16-QAM signals at 2 samples per symbol
        through a mixing near the identity, references, spike taps and Sd0 =
        0.01 I (see tests/test_torch_rls.py on the 8-mode RLS)."""
        rng = np.random.default_rng(seed)
        sym = const[rng.integers(0, 16, size=(n_batch, n_sym, modes))]
        x = np.zeros((n_batch, 2 * n_sym, modes), complex)
        x[:, ::2] = sym
        h = np.eye(modes) + 0.05 * (rng.normal(size=(modes, modes))
                                    + 1j * rng.normal(size=(modes, modes)))
        sig = x @ h.T + 0.01 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
        pad = np.zeros((n_batch, taps // 2 + 2 * n_sym + taps, modes), np.complex64)
        pad[:, taps // 2:taps // 2 + 2 * n_sym] = sig
        h0 = np.zeros((n_batch, modes, modes, taps), np.complex64)
        h0[:, np.arange(modes), np.arange(modes), taps // 2] = 1.0
        sd0 = np.broadcast_to(0.01 * np.eye(taps, dtype=np.complex64),
                              (n_batch, modes, taps, taps)).copy()
        return tuple(torch.as_tensor(a, device=dev) for a in (
            pad, sym.astype(np.complex64), h0, sd0))

    def eq_case(n_batch, n_sym, modes, taps, seed):
        sig, ref, h0, _ = modes_input(n_batch, n_sym, modes, taps, seed)
        return (n_sym, 3, lambda: mimo_eq.mimo_eq_stage_batch(
            sig, ref, mimo_eq._flat(h0), const, aux, "lms", 1e-3 / modes, n_sym // 2, 2, taps,
            0, n_sym))

    def rls_case(n_batch, n_sym, modes, taps, seed):
        sig, ref, h0, sd0 = modes_input(n_batch, n_sym, modes, taps, seed)
        return (n_sym, 3, lambda: rls.rls_stage_batch(sig, ref, h0, sd0, const, "rls", 0.99, 2,
                                                      taps, 0, n_sym))

    extra = {
        "K3 lms 4x15 11x4000": eq_case(11, 4000, 4, 15, 400),
        "K3 lms 8x32 11x2000": eq_case(11, 2000, 8, 32, 401),
        "K5 rls 2x7 11x4000": rls_case(11, 4000, 2, 7, 402),
        "K5 rls 2x32 11x2000": rls_case(11, 2000, 2, 32, 403),
        "K5 rls 8x7 11x2000": rls_case(11, 2000, 8, 7, 405),
        "K5 rls 8x32 11x1000": rls_case(11, 1000, 8, 32, 404),
    }
    cases = {
        "K2 da-rde 12000": (12000, 5, lambda: mimo_eq.mimo_eq_stage(
            sig1, ref1, h1, const, aux, "da-rde", 5e-3, 0, 2, 15, 0, 12000)),
        "K3 da-rde 11x12000": (12000, 5, lambda: mimo_eq.mimo_eq_stage_batch(
            sig11, ref11, h11, const, aux, "da-rde", 5e-3, 0, 2, 15, 0, 12000)),
        "K5 rls 11x12000": (12000, 3, lambda: rls.rls_stage_batch(
            sig11, ref11, h0_11, sd11, const, "rls", 0.99, 2, 15, 0, 12000)),
        "K5 dd-rls 11x12000": (12000, 3, lambda: rls.rls_stage_batch(
            sig11, ref11, h0_11, sd11, const, "dd-rls", 0.99, 2, 15, 0, 12000)),
        "K4 8-PSK dd-rls 4096": (4096, 5, lambda: rls.rls_stage(
            sig_p, ref_p, h0_11[0], sd11[0], psk, "dd-rls", 0.99, 2, 15, 0, 4096)),
    }

    def timed(label, design, n_sym, reps, fn):
        use(design)
        ms = chip_smoke._cuda_ms(fn, reps)
        mhz = chip_smoke._sm_clock_mhz()
        out = [t.cpu() for t in fn()]
        emit(dict(what="kernel", case=label, design=design, ms=ms, sm_clock_mhz=mhz,
                  cycles_per_symbol=ms * 1e-3 / n_sym * mhz * 1e6,
                  checksum=[float(t.abs().double().sum()) for t in out]))
        return out

    for label, (n_sym, reps, fn) in cases.items():
        outs = {}
        for design in ("parent", "current", "current", "parent"):
            outs[design] = timed(label, design, n_sym, reps, fn)
        diff = max(float((a - b).abs().max()) for a, b in zip(outs["parent"], outs["current"]))
        emit(dict(what="parent_vs_current", case=label, max_abs_diff=diff))

    # lane and tile splits of the current sources, against the default split
    by_case = {}
    for tag, _, _, labels in SPLITS:
        for label in labels:
            by_case.setdefault(label, []).append(tag)
    for label, tags in by_case.items():
        n_sym, reps, fn = cases.get(label) or extra[label]
        ref_out = timed(label, "current", n_sym, reps, fn)
        for tag in tags:
            out = timed(label, tag, n_sym, reps, fn)
            emit(dict(what="split_vs_default", case=label, design=tag,
                      max_abs_diff=max(float((a - b).abs().max())
                                       for a, b in zip(out, ref_out))))
        timed(label, "current", n_sym, reps, fn)
    n_sym, reps, fn = cases["K5 rls 11x12000"]
    for tag in ("current", *(t for t, _ in RLS_PROBES), "current"):
        timed("K5 rls 11x12000 probe", tag, n_sym, reps, fn)
    use("current")

    if not args.no_chains:
        from opticommpy_torch.pipelines import coherent_dsp_chain, coherent_dsp_chain_batch

        res, _ = chip_smoke.run_main_path(dev)
        sig_b, ref_b = chip_smoke.receive_wdm(res)
        sig_a, ref_a, cfg_a = chip_smoke.path_a_inputs(res)
        n_sym = res["d_ref"].shape[0]
        chains = {
            "main chain": (n_sym, lambda: coherent_dsp_chain(res["sig_rx"], res["d_ref"],
                                                             res["cfg"])),
            "batch chain da-rde/dd-lms": (11 * ref_b.shape[1], lambda: coherent_dsp_chain_batch(
                sig_b, ref_b, replace(res["cfg"], alg=("da-rde", "dd-lms")))),
            "batch chain rls/dd-rls": (11 * ref_b.shape[1], lambda: coherent_dsp_chain_batch(
                sig_b, ref_b, replace(res["cfg"], alg=("rls", "dd-rls")))),
            "path A": (ref_a.shape[0], lambda: coherent_dsp_chain(sig_a, ref_a, cfg_a)),
        }
        for label, (n_out, fn) in chains.items():
            for design in ("parent", "current", "current", "parent"):
                use(design)
                fn()  # warm
                _, sec = chip_smoke._wall(fn)
                emit(dict(what="chain", case=label, design=design, ms=sec * 1e3,
                          msym_per_s=n_out / sec / 1e6))
        use("current")

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))
    print(f"wrote {args.out} ({len(records)} records)")


if __name__ == "__main__":
    sys.exit(main())
