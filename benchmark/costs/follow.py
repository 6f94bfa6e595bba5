"""Least time of Cellpose's flow following (``csrc/follow_flows.cu``): the
(2, Y, X) float32 field read once and the (2, Y, X) float32 positions
written once, 16 bytes a pixel of the frame; 32 float32 operations a step
of a followed pixel (fractions and weights 4, two channels of four
products of two factors and three sums 22, the step and its clamps 6), no
fused multiply-add. The data sheet's 67 TFLOP/s counts a fused
multiply-add as two operations; the kernel forbids fusing, so its
operations run at most at half that rate."""

from benchmark.costs.peaks import FP32_FLOPS, least_seconds

BYTES_A_PIXEL = 16
OPS_A_STEP = 32
UNFUSED_FP32_OPS = FP32_FLOPS / 2


def least_follow_seconds(pixels: float, followed: float, steps: int) -> float:
    """Least time of following ``followed`` of ``pixels`` frame pixels for
    ``steps`` steps."""
    return least_seconds(BYTES_A_PIXEL * pixels,
                         OPS_A_STEP * followed * steps, UNFUSED_FP32_OPS)
