"""U-Net input preparation and post-processing, plain PyTorch.

Frozen copy of the port's ``models/predictor.py`` (``find_desired_shape``,
``prepare_batch``, ``unet_postprocess_batch``):

1. per-channel 1-99 percentile normalisation;
2. transpose (C, Y, X) -> (1, X, Y, C) — the segmentation runs in the
   reference's x-major space — and front-pad to the next powers of two;
3. post-process: threshold channel 0 at 0.1 -> HC mask; one binary closing
   (5x5); erosion (7x7); boundary = closed minus eroded, dilated (5x5);
   binary watershed with lines -> (labels, HC mask).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.brightness import normalize_channel
from benchmark.reference.morphology import (
    binary_closing, binary_dilation, binary_erosion)
from benchmark.reference.watershed import watershed_batch

__all__ = ["find_desired_shape", "prepare_batch", "unet_postprocess_batch"]


def find_desired_shape(shape_y: int, shape_x: int) -> Tuple[int, int]:
    """Smallest powers of two >= the given sizes."""
    def pow2(n):
        p = 1
        while p < n:
            p *= 2
        return p
    return pow2(shape_y), pow2(shape_x)


def _boundary(predictions: torch.Tensor, hc_threshold: float,
              closing_kernel: int, erosion_kernel: int):
    """(..., H, W, 2) softmax output -> (boundary map, HC mask), both bool,
    by the reference's morphology chain."""
    hc_b = predictions[..., 0] > hc_threshold
    closed = binary_closing(hc_b, closing_kernel)
    hc = binary_erosion(closed, erosion_kernel)
    boundary = binary_dilation(closed & ~hc, closing_kernel)
    return boundary, hc


def unet_postprocess_batch(predictions: torch.Tensor,
                           hc_threshold: float = 0.1, closing_kernel: int = 5,
                           erosion_kernel: int = 7):
    """(B, H, W, 2) batched :func:`unet_postprocess`: the B boundary maps
    flood as ONE row-stacked image (``watershed_batch``). Outputs equal the
    per-frame function's bit for bit."""
    boundary, hc = _boundary(predictions, hc_threshold, closing_kernel,
                             erosion_kernel)
    labels = watershed_batch(boundary.to(torch.float32), watershed_line=True,
                             minima_scan=True, binary=True)
    return labels, hc


def prepare_batch(projections: torch.Tensor):
    """(B, C, Y, X) frames -> (front-padded (B, X', Y', C) float32 model
    input, (pad_x, pad_y)): each channel normalised to its 1-99 percentile
    range, transposed to x-major, zero-padded in front to powers of two."""
    norm = torch.stack([torch.stack([normalize_channel(ch) for ch in frame])
                        for frame in projections])
    x = norm.permute(0, 3, 2, 1)
    sx, sy = x.shape[1], x.shape[2]
    px, py = find_desired_shape(sx, sy)
    return F.pad(x, (0, 0, py - sy, 0, px - sx, 0)), (px - sx, py - sy)
