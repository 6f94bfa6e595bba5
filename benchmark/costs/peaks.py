"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12


def least_seconds(nbytes: float, nops: float, ops_per_s: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    memory bandwidth and the operations at ``ops_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, nops / ops_per_s)
