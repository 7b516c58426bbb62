"""The whole DVB-S2 decode in one launch: the Hopper kernel K11 of
``csrc/qc_mega.cu``.

Port of ``opticommpy_tpu/kernels/qc_mega.py`` (``qc_decode_mega``,
``_mega_body``). The TPU kernel kept a 128-codeword tile's totals resident
in ~100 MB of VMEM across the iterations; an H100 has no such memory, but
codewords decode independently, so one CTA owns one codeword for the whole
decode: its totals and messages live in device memory (L2), it needs no
grid-wide barrier and no atomics, and its early exit runs on the device.
Both schedules of the TPU kernel:

- ``'flooding'``: the fused route's steps (K9's check columns, the vote of
  the step's input totals, K10's variable totals and the parity totals),
  bit-identical to that route and to :func:`mega_decode_plain`;
- ``'layered'``: serial-C sweeps with in-place float32 totals updated by
  message deltas, bit-identical to its plain version.

A wrapper runs the plain version for CPU tensors and the kernel, or raises,
for CUDA tensors. ``launches`` counts kernel launches.
"""

import numpy as np
import torch

from opticommpy_torch.comm.fec_qc import Z, mega_decode_plain
from opticommpy_torch.kernels import _build

__all__ = ["qc_decode_mega", "mega_decode_plain", "mega_tables", "launches"]

launches = 0  # K11 launches made on CUDA tensors

ITEM_BYTES = 24 * 1024  # a flooding ring slot holds at least this many bytes of planes


def _batches(sizes, cap):
    """Greedy batch bounds [0, ..., len(sizes)]: consecutive units whose
    sizes add up to at most ``cap`` (a unit larger than cap alone)."""
    bounds, cur = [0], 0
    for i, n in enumerate(sizes):
        if cur and cur + n > cap:
            bounds.append(i)
            cur = 0
        cur += n
    bounds.append(len(sizes))
    return bounds


def mega_tables(lay, msg_dtype, schedule):
    """K11's int32 tables for the code of ``lay`` (a
    :class:`~opticommpy_torch.kernels.qc.QCLayout`): (tab, n_cb, n_vb, n_pb,
    cap), the layout ``csrc/qc_mega.cu`` reads (MegaArgs): each check slot's
    plane | roll << 16 (S, q); each group entry's slot | column << 8 |
    back-roll << 16 in group order; the groups' entry offsets; the bounds of
    the check, variable and parity batches; each column's slots in the
    order of their groups, stable (slot | 0x100 on a group's first | 0x200
    on its last, (S, q)). ``cap`` is the bytes of a ring slot: flooding
    batches consecutive check columns (each its D message planes and S + 2
    total planes), groups (each its entries' message planes and its float32
    LLR plane) and parity columns (two message planes and an LLR plane) up
    to max(ITEM_BYTES, the largest unit); layered streams one column's D
    message planes a slot."""
    S, q, G = lay.S, lay.q, lay.G
    D = S + 2
    pt, pf = Z * (2 if msg_dtype == "bf16" else 4), Z * 4
    slot = (lay.pos_np.astype(np.int64) | (lay.sh_np.astype(np.int64) << 16)).ravel()
    e = lay.ent_np
    ent = e[:, 0] | (e[:, 1] << 8) | (e[:, 2] << 16)
    degs = np.diff(lay.grp_off_np)
    check = [2 * D * pt] * q
    group = [int(d) * pt + pf for d in degs]
    parity = [2 * pt + pf] * q
    if schedule == "layered":
        cap = D * pt
        cb, vb, pb = list(range(q + 1)), [0, G], [0, q]
    else:
        cap = max(ITEM_BYTES // 16 * 16, *check, *group, *parity)
        cb, vb, pb = _batches(check, cap), _batches(group, cap), _batches(parity, cap)
    order = np.argsort(lay.pos_np, axis=0, kind="stable")  # (S, q) slots by group
    grp = np.take_along_axis(lay.pos_np, order, axis=0)
    edge = np.ones((1, q), bool)
    first = np.concatenate([edge, grp[1:] != grp[:-1]])
    last = np.concatenate([grp[1:] != grp[:-1], edge])
    ordp = (order | (first << 8) | (last << 9)).ravel()
    tab = np.concatenate([slot, ent, lay.grp_off_np, cb, vb, pb, ordp]).astype(np.int32)
    return np.ascontiguousarray(tab), len(cb) - 1, len(vb) - 1, len(pb) - 1, cap


def qc_decode_mega(llr_info, llr_p, lay, K, alpha=None, msg_dtype="f32", early_exit=False,
                   schedule="flooding"):
    """K11: the whole decode of ``K`` steps (``max_iter + 1``). llr_info
    (G, Z, B) float32 in bucket order, llr_p (q, Z, B); ``lay`` the
    :class:`~opticommpy_torch.kernels.qc.QCLayout` of the code on their
    device. Returns (fT (G, Z, B), fTp (q, Z, B) float32 frozen totals,
    done (B,) bool, n_iters (B,) int32), as :func:`mega_decode_plain`
    (which runs on the CPU)."""
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if llr_info.device.type == "cuda":
        return _mega_cuda(llr_info, llr_p, lay, K, alpha, msg_dtype, early_exit, schedule)
    if llr_info.device.type == "cpu":
        return mega_decode_plain(llr_info, llr_p, lay, K, alpha, msg_dtype, early_exit, schedule)
    raise ValueError(f"qc_decode_mega: unsupported device {llr_info.device}")


def _mega_cuda(llr_info, llr_p, lay, K, alpha, msg_dtype, early_exit, schedule):
    global launches
    S, q, G = lay.S, lay.q, lay.G
    B = llr_info.shape[-1]
    if tuple(llr_info.shape) != (G, Z, B) or tuple(llr_p.shape) != (q, Z, B):
        raise ValueError(f"qc_decode_mega: llr_info {tuple(llr_info.shape)}, llr_p "
                         f"{tuple(llr_p.shape)} do not fit q={q}, G={G}")
    if llr_info.dtype != torch.float32 or llr_p.dtype != torch.float32:
        raise ValueError("qc_decode_mega: float32 LLRs")
    if lay.pos.device != llr_info.device:
        raise ValueError(f"qc_decode_mega: tables on {lay.pos.device}, LLRs on "
                         f"{llr_info.device}")
    if K < 1:
        raise ValueError(f"qc_decode_mega: K={K} steps")
    lib = _build.load_library()
    dev = llr_info.device
    bf16 = msg_dtype == "bf16"
    layered = schedule == "layered"
    mdt = torch.bfloat16 if bf16 else torch.float32
    # codeword-major copies: each CTA reads and writes one contiguous slab
    li = llr_info.permute(2, 0, 1).contiguous()
    lp = llr_p.permute(2, 0, 1).contiguous()
    tdt = torch.float32 if layered else mdt  # the totals the check side reads
    m = torch.empty((B, q, S + 2, Z), dtype=mdt, device=dev)
    tw = torch.empty((B, G, Z), dtype=tdt, device=dev)
    tpw = torch.empty((B, q, Z), dtype=tdt, device=dev)
    fT = torch.empty((B, G, Z), dtype=torch.float32, device=dev)
    fTp = torch.empty((B, q, Z), dtype=torch.float32, device=dev)
    done = torch.empty(B, dtype=torch.int32, device=dev)
    n_iters = torch.empty(B, dtype=torch.int32, device=dev)
    # the tables on the layout's device, built once per code, type and schedule
    tables = lay.mega.get((msg_dtype, schedule))
    if tables is None:
        tab, *sizes = mega_tables(lay, msg_dtype, schedule)
        tables = lay.mega[msg_dtype, schedule] = (torch.as_tensor(tab, device=dev), *sizes)
    tab_t, n_cb, n_vb, n_pb, cap = tables
    with torch.cuda.device(dev):
        code = lib.qc_mega_launch(
            int(bf16), int(layered), S + 2, q, G, B, int(K), int(alpha is not None),
            float(alpha or 0.0), int(bool(early_exit)), _build.ptr(li), _build.ptr(lp),
            _build.ptr(tab_t), tab_t.numel(), n_cb, n_vb, n_pb, cap, _build.ptr(m),
            _build.ptr(tw), _build.ptr(tpw), _build.ptr(fT), _build.ptr(fTp),
            _build.ptr(done), _build.ptr(n_iters), _build.stream_ptr(dev))
    _build.check(code, "qc_mega_launch")
    launches += 1
    return fT.permute(1, 2, 0), fTp.permute(1, 2, 0), done.bool(), n_iters
