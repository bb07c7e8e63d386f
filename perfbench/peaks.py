"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit): HBM3 bytes per second and
operations per second by the operands' dtype (float32 on the CUDA cores,
bfloat16 on the tensor cores)."""

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def least_seconds(nbytes: float, ops: float, dtype: str) -> float:
    """The least time a call could take: bytes over the memory's peak or
    operations over the dtype's peak, whichever is larger."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS[dtype])
