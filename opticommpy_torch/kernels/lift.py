"""One flooding MSA/NMSA iteration of a lifted-circulant LDPC decoder (IEEE
802.11n, AR4JA): the Hopper kernel K12 of ``csrc/lift.cu``.

Port of ``opticommpy_tpu/kernels/lift_pallas.py`` (``lift_iter_pallas``,
``_iter_body``, ``_msa_group``): ``(X, llr) -> (X', T, ok)`` with X the
check-aligned extrinsic totals (E, L, B) in the message type, llr the
channel LLRs (V, L, B) float32 in variable-bucket order, T the new totals
float32 and ok the per-codeword parity flags. The rounding points are the
TPU kernel's: the NMSA scale before the storage rounding of each message,
``totm`` = the rolled total rounded to the message type, X' = totm - M
rounded, the parity taken from ``totm``. T starts from the channel LLR and
adds every message in the TPU kernel's order (check bucket, group, slot),
so the kernel equals :func:`lift_iter_plain` bit for bit.

The TPU kernel needed the lift L to be a multiple of 8 (its sublane tile);
this kernel takes any L, any B and check degrees up to 24 (the shipped
codes have 3 to 22), with at most 256 edge planes and 64 check or variable
planes. A wrapper runs the plain version for CPU tensors and the kernel,
or raises, for CUDA tensors. ``launches`` counts calls of the kernel's
entry point (one iteration each: three launches of its phases).
"""

import numpy as np
import torch

from opticommpy_torch.comm.fec_lift import _roll
from opticommpy_torch.kernels import _build

__all__ = ["LiftLayout", "lift_iter", "lift_iter_plain", "launches"]

launches = 0  # K12 launches made on CUDA tensors

_MAX_DEG, _MAX_E, _MAX_PLANES = 24, 256, 64  # what the kernel's tables hold


class LiftLayout:
    """The tables of one lifted-circulant code
    (:func:`opticommpy_torch.comm.fec_lift.lift_tables`): NumPy for the
    plain version, int32 tensors on ``device`` for the kernel.

    - ``cg_off`` (C+1,), ``c_e``, ``c_v``, ``c_sh`` (E,): per check group in
      bucket order, its slots' edge plane, variable plane and roll.
    - ``vg_off`` (V+1,), ``v_e``, ``v_sh`` (E,): per variable plane in bucket
      order, its edge planes and back-rolls in the order the check side
      meets them (bucket, group, slot).
    """

    def __init__(self, tb, device):
        self.L, self.V, self.E = tb["L"], tb["V"], tb["E"]
        self.chk_buckets, self.ev, self.esh = tb["chk_buckets"], tb["ev"], tb["esh"]
        L = self.L
        cg_off, c_e, c_v, c_sh = [0], [], [], []
        by_var = [[] for _ in range(self.V)]
        off = 0
        for (d, ng), ev, esh in zip(self.chk_buckets, self.ev, self.esh):
            for ig in range(ng):
                for sl in range(d):
                    e, v = off + sl * ng + ig, int(ev[sl, ig])
                    c_e.append(e)
                    c_v.append(v)
                    c_sh.append(int(esh[sl, ig]))
                    by_var[v].append((e, (L - int(esh[sl, ig])) % L))
                cg_off.append(len(c_e))
            off += d * ng
        vg_off = np.concatenate([[0], np.cumsum([len(b) for b in by_var])])
        flat = [ent for b in by_var for ent in b]

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

        self.C = len(cg_off) - 1
        self.max_deg = max(d for d, _ in self.chk_buckets)
        self.cg_off, self.c_e, self.c_v, self.c_sh = (dev(cg_off), dev(c_e), dev(c_v),
                                                      dev(c_sh))
        self.vg_off = dev(vg_off)
        self.v_e = dev([e for e, _ in flat])
        self.v_sh = dev([s for _, s in flat])


def lift_iter_plain(X, llr_bo, lay, alpha=None):
    """K12's plain version: one flooding iteration in torch ops, the TPU
    kernel's pass 1 (leave-one-out messages per check group, T := llr plus
    the rolled-back messages) and pass 2 (X' and the parity flags).
    Returns (X' like X, T (V, L, B) float32, ok (B,) bool)."""
    mdt, L, B = X.dtype, lay.L, X.shape[-1]
    T = llr_bo.clone()
    M = torch.empty_like(X)
    off = 0
    for (d, ng), ev, esh in zip(lay.chk_buckets, lay.ev, lay.esh):
        x = X[off:off + d * ng].float().reshape(d, ng, L, B)
        mag = x.abs()
        m1 = torch.full_like(mag[0], float("inf"))
        m2 = torch.full_like(mag[0], float("inf"))
        for sl in range(d):  # the two smallest |x| of each check row
            m2 = torch.minimum(m2, torch.maximum(m1, mag[sl]))
            m1 = torch.minimum(m1, mag[sl])
        neg = x < 0
        par = torch.sum(neg, dim=0, dtype=torch.int32) & 1
        om = torch.where(mag == m1, m2, m1)
        if alpha is not None:
            om = om * alpha
        ms = torch.where((par ^ neg.to(torch.int32)) == 1, -om, om).to(mdt)
        M[off:off + d * ng] = ms.reshape(d * ng, L, B)
        for ig in range(ng):
            for sl in range(d):
                v = int(ev[sl, ig])
                T[v] = T[v] + _roll(ms[sl, ig].float(), (L - int(esh[sl, ig])) % L, L)
        off += d * ng
    Xn = torch.empty_like(X)
    ok = torch.ones(B, dtype=torch.bool, device=X.device)
    off = 0
    for (d, ng), ev, esh in zip(lay.chk_buckets, lay.ev, lay.esh):
        for ig in range(ng):
            par = torch.zeros((L, B), dtype=torch.bool, device=X.device)
            for sl in range(d):
                e = off + sl * ng + ig
                totm = _roll(T[int(ev[sl, ig])], int(esh[sl, ig]), L).to(mdt).float()
                Xn[e] = (totm - M[e].float()).to(mdt)
                par ^= totm < 0
            ok &= ~par.any(dim=0)
        off += d * ng
    return Xn, T, ok


def _lift_cuda(X, llr_bo, lay, alpha):
    global launches
    L, V, E = lay.L, lay.V, lay.E
    B = X.shape[-1]
    if tuple(X.shape) != (E, L, B) or tuple(llr_bo.shape) != (V, L, B):
        raise ValueError(f"lift_iter: X {tuple(X.shape)}, llr {tuple(llr_bo.shape)} do not fit "
                         f"E={E}, L={L}, V={V}")
    if X.dtype not in (torch.float32, torch.bfloat16) or llr_bo.dtype != torch.float32:
        raise ValueError(f"lift_iter: float32 or bfloat16 X and float32 LLRs, got {X.dtype}, "
                         f"{llr_bo.dtype}")
    if lay.c_e.device != X.device:
        raise ValueError(f"lift_iter: tables on {lay.c_e.device}, tensors on {X.device}")
    if lay.max_deg > _MAX_DEG or E > _MAX_E or max(lay.C, V) > _MAX_PLANES:
        raise ValueError(f"lift_iter: check degree {lay.max_deg}, {E} edge planes, {lay.C} "
                         f"check and {V} variable planes exceed the kernel's {_MAX_DEG}, "
                         f"{_MAX_E}, {_MAX_PLANES}")
    lib = _build.load_library()
    X, llr_bo = X.contiguous(), llr_bo.contiguous()
    m = torch.empty_like(X)
    xo = torch.empty_like(X)
    T = torch.empty_like(llr_bo)
    ok = torch.empty(B, dtype=torch.int32, device=X.device)
    with torch.cuda.device(X.device):
        code = lib.lift_iter_launch(
            int(X.dtype == torch.bfloat16), L, V, lay.C, B, int(alpha is not None),
            float(alpha or 0.0), _build.ptr(X), _build.ptr(llr_bo), _build.ptr(lay.cg_off),
            _build.ptr(lay.c_e), _build.ptr(lay.c_v), _build.ptr(lay.c_sh),
            _build.ptr(lay.vg_off), _build.ptr(lay.v_e), _build.ptr(lay.v_sh), _build.ptr(m),
            _build.ptr(xo), _build.ptr(T), _build.ptr(ok), lay.max_deg,
            _build.stream_ptr(X.device))
    _build.check(code, "lift_iter_launch")
    launches += 1
    return xo, T, ok.bool()


def lift_iter(X, llr_bo, lay, alpha=None):
    """K12: one flooding iteration ``(X, llr) -> (X', T, ok)``
    (:func:`lift_iter_plain` on the CPU, the kernel on CUDA)."""
    if X.device.type == "cuda":
        return _lift_cuda(X, llr_bo, lay, alpha)
    if X.device.type == "cpu":
        return lift_iter_plain(X, llr_bo, lay, alpha)
    raise ValueError(f"lift_iter: unsupported device {X.device}")
