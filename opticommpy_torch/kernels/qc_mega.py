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

import torch

from opticommpy_torch.comm.fec_qc import Z, mega_decode_plain
from opticommpy_torch.kernels import _build

__all__ = ["qc_decode_mega", "mega_decode_plain", "launches"]

launches = 0  # K11 launches made on CUDA tensors


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
    with torch.cuda.device(dev):
        code = lib.qc_mega_launch(
            int(bf16), int(layered), S + 2, q, G, B, int(K), int(alpha is not None),
            float(alpha or 0.0), int(bool(early_exit)), _build.ptr(li), _build.ptr(lp),
            _build.ptr(lay.pos), _build.ptr(lay.sh), _build.ptr(lay.grp_off),
            _build.ptr(lay.ent), _build.ptr(m), _build.ptr(tw), _build.ptr(tpw),
            _build.ptr(fT), _build.ptr(fTp), _build.ptr(done), _build.ptr(n_iters),
            _build.stream_ptr(dev))
    _build.check(code, "qc_mega_launch")
    launches += 1
    return fT.permute(1, 2, 0), fTp.permute(1, 2, 0), done.bool(), n_iters
