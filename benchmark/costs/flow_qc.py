"""Least time of the Cellpose flow check's diffusion
(``csrc/flow_diffuse.cu``): the (Y, X) int32 labels read once and the
(Y + 2, X + 2) float64 T written once, 12 bytes a frame pixel; 9 float64
operations a mask pixel and iteration (eight sums and a division, the
division counted as one, so the time stays a lower bound), at the unfused
float64 rate. The data sheet's 34 TFLOP/s of float64 outside the tensor
cores counts a fused multiply-add as two operations; the kernel forbids
fusing, so its operations run at most at half that rate."""

from benchmark.costs.peaks import least_seconds

BYTES_A_PIXEL = 12
OPS_A_PIXEL_ITER = 9
UNFUSED_FP64_OPS = 17e12


def least_flow_qc_seconds(pixels: float, px_iters: float) -> float:
    """Least time of diffusing frames of ``pixels`` pixels in all, whose
    mask pixels times iterations sum to ``px_iters``."""
    return least_seconds(BYTES_A_PIXEL * pixels, OPS_A_PIXEL_ITER * px_iters,
                         UNFUSED_FP64_OPS)
