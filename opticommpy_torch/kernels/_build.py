"""Build and load the hand-written Hopper kernels in ``opticommpy_torch/csrc``.

All ``*.cu`` sources are compiled with ``nvcc`` into one shared library with
a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), which is
loaded with :mod:`ctypes`. Each source is compiled by its own ``nvcc``
process, all started together, and the objects are then linked. The library is built on first use into
``build/torch_kernels/`` at the root of the checkout, named by a hash of the
sources so that an edited source is never served by a stale build. Nothing
here runs at import time: the CPU tests import every module of the package
on a machine with no CUDA toolkit.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "check", "ptr", "stream_ptr"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "bps_launch": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _F, _F, _F, _I,
                   _I, _P, _P],
    "mimo_eq_launch": [_I, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I,
                       _I, _I, _P, _P, _P, _I, _P, _I, _I, _F, _F, _F, _I,
                       _F, _I, _P, _P, _P, _P],
    "rls_launch": [_I, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I,
                   _I, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P, _P, _P, _P, _P,
                   _P],
}

_lib = None
build_info = {}  # seconds and compiler log of the build this process made


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    lib_path = _BUILD_DIR / f"libopticomm_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [_BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        failed = [src.name for src, proc in zip(sources, procs) if proc.returncode]
        if not failed:
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode:
                failed = ["link"]
        for obj in objs:
            obj.unlink(missing_ok=True)
        build_info["seconds"] = time.perf_counter() - t0
        build_info["log"] = log
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(code, name):
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
