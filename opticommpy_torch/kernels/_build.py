"""Build and load the hand-written Hopper kernels in ``opticommpy_torch/csrc``.

All ``*.cu`` sources, with the ``*.cuh`` headers they include, are compiled
with ``nvcc`` into one shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``), which is loaded with
:mod:`ctypes`. Each source is compiled by its own ``nvcc`` process, all
started together, and the objects are then linked. The library is built on
first use into ``build/torch_kernels/`` at the root of the checkout, named
by a hash of the sources and headers so that an edited file is never served
by a stale build. Nothing here runs at import time: the CPU tests import
every module of the package on a machine with no CUDA toolkit.

The wrappers' shared launch helpers live here too: pointers, the current
stream, error checks and the device-resident constellation tables.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

__all__ = ["load_library", "check", "ptr", "stream_ptr", "device_tables", "device_arrays"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    "bps_launch": [_P, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "bps_smem_bytes": [_I, _I, _I, _I],
    "bps_exact_check": [ctypes.c_ulonglong, ctypes.c_ulonglong, _I, _P, _P, _I, _F, _F, _F,
                        _P, _P],
    "mimo_eq_launch": [_I, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I,
                       _I, _I, _P, _P, _P, _I, _P, _I, _I, _F, _F, _F, _I,
                       _F, _I, _P, _P, _P, _P],
    "mimo_eq_chunk": [_I, _I, _I],
    "rls_chunk": [_I, _I, _I],
    "rls_launch": [_I, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I,
                   _I, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P, _P, _P, _P, _P,
                   _P],
    "gardner_launch": [_P, _I, _I, _I, _F, _F, _I, _I, _P, _P, _P, _P],
    "ddpll_launch": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _F, _F, _F, _F, _F,
                     _F, _F, _P, _P],
    "ldpc_check_launch": [_I, _I, _P, ctypes.c_longlong, _I, _F, _P, _P],
    "qc_check_launch": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    "qc_var_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "qc_mega_launch": [_I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P, _I, _I, _I, _I,
                       _I, *[_P] * 7, _P],
    "lift_iter_launch": [_I, _I, _I, _I, _I, _I, _F, *[_P] * 13, _I, _P],
    "dfe_launch": [_I, _I, _P, ctypes.c_longlong, _I, _I, _P, _P, _P, _I, _I, _F, _F, _F,
                   _I, _I, _F, _I, _I, *[_P] * 6, _P],
    "volterra_launch": [_I, _P, ctypes.c_longlong, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                        _P, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P],
    "volterra_exact_check": [ctypes.c_ulonglong, ctypes.c_ulonglong, _P, _I, _F, _F, _F, _P,
                             _P],
    "unwrap_scratch_len": [_I, _I],
    "unwrap_launch": [_P, _P, _I, _I, _F, _F, _F, _F, ctypes.c_double, _P, _P, _P, _P],
    "ssfm_scratch_bytes": [],
    "ssfm_power_launch": [_I, _P, _L, _D, _P, _P, _P, _P, _P, _D, _P, _P, _P],
    "ssfm_step_launch": [_I, _P, _P, _P, _D, _P, _P, _P],
    "ssfm_lin_launch": [_I, _P, _L, _I, _P, _P, _P, _D, _P],
    "ssfm_rotate_launch": [_I, _P, _P, _P, _L, _D, _D, _P, _D, _P, _P],
    "ssfm_converge_launch": [_I, _P, _P, _L, _I, _P, _P, _P, _P],
}

_lib = None
_TABLES_MAX = 64  # cached device tables kept before the cache is emptied
_tables = {}
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
    for src in sorted(_CSRC.glob("*.cu*")):  # the sources and their headers
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


def device_tables(const, aux, device):
    """(c_re, c_im, aux) float32 tensors on ``device``, uploaded once per
    constellation, aux vector and device, for the kernels' wrappers
    (:func:`device_arrays`)."""
    const = np.ascontiguousarray(const, np.complex64)
    aux = np.zeros(0, np.float32) if aux is None else np.asarray(aux, np.float32)
    return device_arrays((const.real, const.imag, aux), device)


def device_arrays(arrays, device):
    """The NumPy ``arrays`` as tensors on ``device``, uploaded once per
    content and device: a kernel's lookup tables.

    A host-to-device copy from pageable NumPy memory waits for the stream,
    so uploading the tables on every call would keep a chain's host work
    from overlapping the kernel before it. The tensors are shared between
    calls and must not be written.
    """
    import torch

    device = torch.device(device)
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        key = (a.dtype.str, a.shape, a.tobytes(), str(device))
        hit = _tables.get(key)
        if hit is None:
            if len(_tables) >= _TABLES_MAX:
                _tables.clear()
            hit = _tables[key] = torch.as_tensor(a.copy(), device=device)
        out.append(hit)
    return tuple(out)
