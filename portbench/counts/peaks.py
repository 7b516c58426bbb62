"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense):
float32 outside the tensor cores and HBM3 bandwidth, at the full 700 W."""

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops, nbytes):
    """(seconds, what bounds it): the larger of operations over the peak
    rate and bytes over the memory rate."""
    t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
