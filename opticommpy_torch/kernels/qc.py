"""One fused step of the quasi-cyclic DVB-S2 decoder: the Hopper kernels of
``csrc/qc.cu``.

Port of ``opticommpy_tpu/kernels/qc_pallas.py``:

- K9, :func:`check_column_update` (``check_column_update``, ``_check_body``):
  per check column, the S variable-total planes rolled into check alignment
  plus the parity self and staircase edges; ``x = tot - M``; the two-min
  leave-one-out min-sum update; the new messages M and the per-codeword
  parity vote of the totals (the AND over every check).
- K10, :func:`var_totals_update` (``var_totals_update``, ``_var_body``): per
  variable group, the channel LLR plus its check messages rolled back,
  added in float32 in ``qc_tables``' entry order; the frozen-output select;
  at bfloat16 the copy of the totals in the message type.

The TPU kernels tiled the batch into 128-lane chunks and padded it with
+200 LLR columns, one call per degree bucket; these take the whole (planes,
Z, B) layout, and K10 covers every bucket in one launch.

The plain versions, :func:`check_column_plain` and
:func:`var_totals_plain`, are the two halves of the step in torch ops
(``torch.roll`` planes, sequential adds); both kernels are bit-identical to
them. A wrapper runs the plain version for CPU tensors and the kernel, or
raises, for CUDA tensors. ``check_launches`` and ``var_launches`` count
kernel launches.
"""

import numpy as np
import torch

from opticommpy_torch.comm.fec_qc import Z, _roll, slot_tables, v2c_totals
from opticommpy_torch.kernels import _build

__all__ = ["QCLayout", "check_column_update", "check_column_plain", "var_totals_update",
           "var_totals_plain", "check_launches", "var_launches"]

check_launches = 0  # K9 launches made on CUDA tensors
var_launches = 0  # K10 launches made on CUDA tensors


class QCLayout:
    """The index tables of one DVB-S2 code for both kernels, from
    :func:`opticommpy_torch.comm.fec_qc.qc_tables`: NumPy for the plain
    versions, int32 tensors on ``device`` for the kernels.

    - ``pos``, ``sh`` (S, q): T plane (bucket order) and roll of each info
      slot of each check column (K9).
    - ``grp_off`` (G+1,), ``ent`` (E, 3): per group in bucket order, its
      entries as (slot, a0, back-roll ``(Z - shift) mod Z``) (K10); NumPy
      copies ``grp_off_np``, ``ent_np``.
    - ``mega``: K11's tables per (message type, schedule), built at a
      decode's first launch (``kernels/qc_mega.py``).
    """

    def __init__(self, tb, device):
        self.S, self.q, self.G = tb["S"], tb["q"], tb["G"]
        self.buckets, self.ent_addr = tb["buckets"], tb["ent_addr"]
        self.pos_np, self.sh_np = slot_tables(tb)
        ents = [ea.reshape(-1, 3) for ea in tb["ent_addr"]]  # (a0, slot, shift)
        degs = np.concatenate([np.full(ng, d) for d, ng in tb["buckets"]])
        grp_off = np.concatenate([[0], np.cumsum(degs)])
        ent = np.concatenate(ents)
        ent = np.stack([ent[:, 1], ent[:, 0], (Z - ent[:, 2]) % Z], axis=1)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

        self.pos, self.sh = dev(self.pos_np), dev(self.sh_np)
        self.grp_off_np, self.ent_np = grp_off.astype(np.int64), ent.astype(np.int64)
        self.grp_off, self.ent = dev(grp_off), dev(ent)
        self.mega = {}


def check_column_plain(T, Tp, M, lay, alpha=None):
    """K9's plain version. T (G, Z, B) and Tp (q, Z, B) totals in the message
    type, M (S+2, q, Z, B) messages. Returns (M_new like M, ok (B,) bool:
    every parity check of the totals T, Tp holds)."""
    S = lay.S
    mdt = M.dtype
    tot32 = v2c_totals(T, Tp, lay.pos_np, lay.sh_np, mdt).float()  # (S+2, q, Z, B)
    x = (tot32 - M.float()).to(mdt).float()  # the message type's rounding
    tneg = tot32 < 0
    x[S + 1, 0, 0] = float("inf")  # check 0 has no p_{-1}
    tneg[S + 1, 0, 0] = False
    mag = x.abs()
    m1 = torch.full_like(mag[0], float("inf"))
    m2 = torch.full_like(mag[0], float("inf"))
    for sl in range(S + 2):  # the two smallest |x|
        m2 = torch.minimum(m2, torch.maximum(m1, mag[sl]))
        m1 = torch.minimum(m1, mag[sl])
    neg = x < 0
    parx = torch.sum(neg, dim=0, dtype=torch.int32) & 1
    partot = torch.sum(tneg, dim=0, dtype=torch.int32) & 1
    ok = torch.all((partot == 0).reshape(-1, partot.shape[-1]), dim=0)
    om = torch.where(mag == m1, m2, m1)
    if alpha is not None:
        om = om * alpha
    flip = (parx ^ neg.to(torch.int32)) == 1
    return torch.where(flip, -om, om).to(mdt), ok


def var_totals_plain(M, llr, fT_old, freeze, lay, msg_copy=False):
    """K10's plain version. M (S+2, q, Z, B) messages (slots 0..S-1 read),
    llr / fT_old (G, Z, B) float32 in bucket order, freeze (B,) bool.
    Returns (T, fT = where(freeze, fT_old, T), T in M's type or None)."""
    out, off = [], 0
    for (d, ng), ea in zip(lay.buckets, lay.ent_addr):
        acc = llr[off:off + ng]
        for j in range(d):  # entry order: a0 ascending, then slot
            acc = acc + torch.stack([_roll(M[sl, a0].float(), -sh)
                                     for a0, sl, sh in ea[:, j].tolist()])
        out.append(acc)
        off += ng
    T = torch.cat(out)
    fT = torch.where(freeze, fT_old, T)
    return T, fT, (T.to(M.dtype) if msg_copy else None)


def _check_layout(lay, M, T, Tp=None):
    """M (S+2, q, Z, B), T (G, Z, B) and Tp (q, Z, B) on the tables' device."""
    S, q, G = lay.S, lay.q, lay.G
    B = M.shape[-1]
    if (tuple(M.shape) != (S + 2, q, Z, B) or tuple(T.shape) != (G, Z, B)
            or (Tp is not None and tuple(Tp.shape) != (q, Z, B))):
        raise ValueError(f"qc kernels: M {tuple(M.shape)}, T {tuple(T.shape)}, Tp "
                         f"{None if Tp is None else tuple(Tp.shape)} do not fit S={S}, "
                         f"q={q}, G={G}")
    if M.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qc kernels: float32 or bfloat16 messages, got {M.dtype}")
    if lay.pos.device != M.device:
        raise ValueError(f"qc kernels: tables on {lay.pos.device}, tensors on {M.device}")


def _check_cuda(T, Tp, M, lay, alpha):
    global check_launches
    _check_layout(lay, M, T, Tp)
    if T.dtype != M.dtype or Tp.dtype != M.dtype:
        raise ValueError("check_column_update: T and Tp must be in the message type")
    lib = _build.load_library()
    T, Tp, M = T.contiguous(), Tp.contiguous(), M.contiguous()
    B = M.shape[-1]
    m_new = torch.empty_like(M)
    vote = torch.ones(B, dtype=torch.int32, device=M.device)
    with torch.cuda.device(M.device):
        code = lib.qc_check_launch(
            int(M.dtype == torch.bfloat16), lay.S + 2, _build.ptr(T), _build.ptr(Tp),
            _build.ptr(M), _build.ptr(lay.pos), _build.ptr(lay.sh), lay.q, B,
            int(alpha is not None), float(alpha or 0.0), _build.ptr(m_new), _build.ptr(vote),
            _build.stream_ptr(M.device))
    _build.check(code, "qc_check_launch")
    check_launches += 1
    return m_new, vote.bool()


def check_column_update(T, Tp, M, lay, alpha=None):
    """K9: every check column's message update and the parity vote of the
    totals (``check_column_plain`` on the CPU, the kernel on CUDA)."""
    if M.device.type == "cuda":
        return _check_cuda(T, Tp, M, lay, alpha)
    if M.device.type == "cpu":
        return check_column_plain(T, Tp, M, lay, alpha)
    raise ValueError(f"check_column_update: unsupported device {M.device}")


def _var_cuda(M, llr, fT_old, freeze, lay, msg_copy):
    global var_launches
    _check_layout(lay, M, llr)
    if llr.dtype != torch.float32 or fT_old.dtype != torch.float32:
        raise ValueError("var_totals_update: llr and fT_old must be float32")
    if msg_copy and M.dtype != torch.bfloat16:
        raise ValueError("var_totals_update: the message-type copy is for bfloat16")
    lib = _build.load_library()
    M, llr, fT_old = M.contiguous(), llr.contiguous(), fT_old.contiguous()
    freeze = freeze.to(torch.uint8).contiguous()
    B = M.shape[-1]
    T = torch.empty_like(llr)
    fT = torch.empty_like(llr)
    Tc = torch.empty_like(llr, dtype=M.dtype) if msg_copy else None
    with torch.cuda.device(M.device):
        code = lib.qc_var_launch(
            int(M.dtype == torch.bfloat16), _build.ptr(M), _build.ptr(llr),
            _build.ptr(fT_old), _build.ptr(freeze), _build.ptr(lay.grp_off),
            _build.ptr(lay.ent), lay.q, lay.G, B, _build.ptr(T), _build.ptr(fT),
            _build.ptr(Tc) if msg_copy else None, _build.stream_ptr(M.device))
    _build.check(code, "qc_var_launch")
    var_launches += 1
    return T, fT, Tc


def var_totals_update(M, llr, fT_old, freeze, lay, msg_copy=False):
    """K10: the new totals T (float32), the frozen outputs and, with
    ``msg_copy``, T in the message type (``var_totals_plain`` on the CPU,
    the kernel on CUDA)."""
    if M.device.type == "cuda":
        return _var_cuda(M, llr, fT_old, freeze, lay, msg_copy)
    if M.device.type == "cpu":
        return var_totals_plain(M, llr, fT_old, freeze, lay, msg_copy)
    raise ValueError(f"var_totals_update: unsupported device {M.device}")
