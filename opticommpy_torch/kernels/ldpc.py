"""LDPC check update over the slot axis: the Hopper kernel ``csrc/ldpc_check.cu``.

Port of ``opticommpy_tpu/kernels/ldpc_pallas.py`` (K8,
``check_update_msa_pallas``): the exact leave-one-out minimum along the
leading slot axis D of a (D, ...) message tensor, the sign from the parity
of the other slots, optionally scaled by ``alpha`` (0.75 for NMSA). It is
the check update of :func:`opticommpy_torch.comm.fec_qc.make_qc_decoder`
with ``backend="pallas"``.

The plain version is :func:`opticommpy_torch.comm.fec_qc._check_msa_slots`
and its NMSA wrapper (``0.75 *`` in float32, cast back): the kernel does its
math in float32 on values that are exact in the storage type, so it is
bit-identical to them for float32 and bfloat16 messages.

:func:`check_update_msa` routes by device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, which launches or raises.
``launches`` counts kernel launches.
"""

import torch

from opticommpy_torch.comm import fec_qc
from opticommpy_torch.kernels import _build

__all__ = ["check_update_msa", "check_update_msa_plain", "launches", "SLOT_COUNTS"]

launches = 0  # kernel launches made by check_update_msa on CUDA tensors

# D = S + 2 of the 11 DVB-S2 rates: the slot counts the kernel is built for
SLOT_COUNTS = (4, 5, 6, 7, 10, 11, 14, 18, 22, 27, 30)


def check_update_msa_plain(x, alpha=None):
    """The plain version: ``_check_msa_slots``, scaled by ``alpha`` in
    float32 when given."""
    out = fec_qc._check_msa_slots(x)
    if alpha is None:
        return out
    return (alpha * out.float()).to(x.dtype)


def _check_msa_cuda(x, alpha):
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"check_update_msa: float32 or bfloat16 messages, got {x.dtype}")
    D = x.shape[0]
    if D not in SLOT_COUNTS:
        raise ValueError(f"check_update_msa: the kernel takes D in {SLOT_COUNTS}, got {D}")
    lib = _build.load_library()
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel() // D
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        code = lib.ldpc_check_launch(
            int(x.dtype == torch.bfloat16), D, _build.ptr(x), n, int(alpha is not None),
            float(alpha or 0.0), _build.ptr(out), _build.stream_ptr(x.device))
    _build.check(code, "ldpc_check_launch")
    launches += 1
    return out


def check_update_msa(x, alpha=None):
    """Exclusive-min check update along axis 0 of ``x`` (D, q, Z, B): the
    kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cuda":
        return _check_msa_cuda(x, alpha)
    if x.device.type == "cpu":
        return check_update_msa_plain(x, alpha)
    raise ValueError(f"check_update_msa: unsupported device {x.device}")
