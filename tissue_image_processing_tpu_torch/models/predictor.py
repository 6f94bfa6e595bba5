"""U-Net segmentation predictor with watershed post-processing.

Port of ``tissue_image_processing_tpu/models/predictor.py``:

1. per-channel 1-99 percentile normalisation;
2. transpose (C, Y, X) -> (1, X, Y, C) — the segmentation runs in the
   reference's x-major space — and front-pad to the next powers of two;
3. U-Net forward pass, unpad;
4. post-process: threshold channel 0 at 0.1 -> HC mask; one binary closing
   (5x5; the reference's repeated rounds are idempotent); erosion (7x7);
   boundary = closed minus eroded, dilated (5x5); binary watershed with lines
   (zero-set seeds by the segmented-scan kernel, no Bellman-Ford phase)
   -> (labels, HC mask).

The int8 path (``quantize=True``) and Keras weight files
(``model_weights_path``) belong to later slices of the port and raise
``NotImplementedError``; nothing falls back to bfloat16 quietly.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tissue_image_processing_tpu_torch._device import resolve_device
from tissue_image_processing_tpu_torch.models.unet import (
    UNet, build_unet, fold_batchnorm)
from tissue_image_processing_tpu_torch.ops.brightness import normalize_channel
from tissue_image_processing_tpu_torch.ops.morphology import (
    binary_closing, binary_dilation, binary_erosion)
from tissue_image_processing_tpu_torch.ops.watershed import (
    watershed, watershed_batch)

__all__ = ["SegmentationPredictor", "find_desired_shape", "unet_postprocess",
           "unet_postprocess_batch", "unet_from_config", "prepare_batch"]


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


def unet_postprocess(predictions: torch.Tensor, hc_threshold: float = 0.1,
                     closing_kernel: int = 5, erosion_kernel: int = 7):
    """(H, W, 2) softmax output -> (labels, HC mask)."""
    boundary, hc = _boundary(predictions, hc_threshold, closing_kernel,
                             erosion_kernel)
    labels = watershed(boundary.to(torch.float32), watershed_line=True,
                       minima_scan=True, binary=True)
    return labels, hc


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


def _norm_of(state: Mapping) -> str:
    if any(".bn0." in k for k in state):
        return "bn"
    return "shift" if any(k.endswith(".shift0") for k in state) else "none"


def unet_from_config(config: Mapping, device: torch.device) -> UNet:
    """The frozen bfloat16 inference model of a :meth:`SegmentationPredictor.
    pipeline_config` dictionary (``params`` = a ``UNet`` ``state_dict``, plus
    ``depth``, ``base_filters``, ``norm``) on ``device``."""
    if config.get("quantized", False):
        raise NotImplementedError(
            "the int8 U-Net path (models/quant.py) is ported in a later slice")
    params = config["params"]
    with torch.device(device):
        model = UNet(depth=config.get("depth", 3),
                     base_filters=config.get("base_filters", 128),
                     dtype=torch.bfloat16, norm=config.get("norm", "shift"),
                     in_channels=params["blocks.0.conv0.weight"].shape[1])
    model.load_state_dict(params)
    return model.eval().requires_grad_(False)


class SegmentationPredictor:
    """Predict a (C=2, Y, X) membrane / marker frame -> (labels, HC mask),
    both in the reference's transposed (X, Y) space.

    ``variables`` is a ``state_dict`` of :class:`UNet` (for example from
    ``utils.state.unet_state_from_flax``); without one the weights are drawn
    from seed 0. ``device=None`` is the card."""

    def __init__(self, model_weights_path: Optional[str], image_shape,
                 depth: int = 3, base_filters: int = 128,
                 dtype: torch.dtype = torch.bfloat16,
                 variables: Optional[Mapping] = None, fold_bn: bool = True,
                 quantize: bool = False, device=None):
        if quantize:
            raise NotImplementedError(
                "the int8 U-Net path (models/quant.py) is ported in a later "
                "slice")
        if model_weights_path:
            raise NotImplementedError(
                "Keras weight files (models/weights_io.py) are ported in a "
                "later slice; pass variables= instead")
        self.device = resolve_device(device)
        sy, sx = find_desired_shape(image_shape[-2], image_shape[-1])
        self.model_shape = (sx, sy, 2)  # x-major like the reference
        self.dtype, self.depth = dtype, depth
        if variables is None:
            model = build_unet(self.model_shape, depth=depth,
                               base_filters=base_filters, dtype=dtype,
                               generator=torch.Generator().manual_seed(0))
        else:
            model = UNet(depth=depth, base_filters=base_filters, dtype=dtype,
                         norm=_norm_of(variables),
                         in_channels=self.model_shape[-1])
            model.load_state_dict(variables)
        model = model.to(self.device).eval().requires_grad_(False)
        if fold_bn:
            folded = fold_batchnorm(model)
            if folded is not None:  # None: a BatchNorm scale <= 0 blocks it
                model = folded.requires_grad_(False)
        self.model = model

    def _forward(self, batch: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model(batch)

    def _prepare(self, images):
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return prepare_batch(images.to(self.device))

    def prepare_image(self, image):
        """(C, Y, X) -> (front-padded (1, X', Y', C) model input, the pads
        ((0, 0), (pad_x, 0), (pad_y, 0), (0, 0)))."""
        padded, (px, py) = self._prepare(image[None])
        return padded, ((0, 0), (px, 0), (py, 0), (0, 0))

    def predict(self, image):
        labels, hc = self.predict_batch(image[None])
        return labels[0], hc[0]

    def predict_batch(self, images):
        """(B, C, Y, X) equally sized frames -> (B, X, Y) labels and
        (B, X, Y) HC masks: one forward pass and one stacked flood."""
        batch, (px, py) = self._prepare(images)
        preds = self._forward(batch)[:, px:, py:, :]
        return unet_postprocess_batch(preds)

    def pipeline_config(self, batch: int = 8) -> dict:
        """Package this predictor for ``movie_pipeline(unet=...)``: the
        model's ``state_dict`` plus its static description."""
        return {"params": self.model.state_dict(), "quantized": False,
                "depth": self.depth, "base_filters": self.model.base_filters,
                "norm": self.model.norm, "batch": batch}
