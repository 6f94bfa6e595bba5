"""Brightness / contrast normalisation.

Port of ``tissue_image_processing_tpu/ops/brightness.py``: the reference's
channel normalisers (``set_brightness``, ``set_channel_brightness``,
``binary_image``, skimage's ``adjust_gamma``) and the U-Net predictor's 1-99
percentile ``normalize_channel``. Percentiles come from
:func:`~tissue_image_processing_tpu_torch.ops.percentile.percentile` and stay
on the input's device; nothing here reads a value on the host.
"""

from __future__ import annotations

import torch

from tissue_image_processing_tpu_torch.ops.percentile import percentile

__all__ = ["adjust_gamma", "set_channel_brightness", "set_brightness",
           "binary_image", "normalize_channel"]


def adjust_gamma(image: torch.Tensor, gamma: float = 1.0,
                 gain: float = 1.0) -> torch.Tensor:
    """``skimage.exposure.adjust_gamma`` for float images in [0, 1]."""
    return gain * torch.pow(image, gamma)


def set_channel_brightness(image: torch.Tensor, max_possible_val: float,
                           method: str = "bestFit",
                           clear_extreme_percentage: float = 1.0,
                           minimum_pixel_val: float = 0.0) -> torch.Tensor:
    """One channel's brightness normalisation:

    1. clip the top ``clear_extreme_percentage`` percentile;
    2. shift by the bottom percentile (or ``minimum_pixel_val`` if larger);
    3. scale to max 1, add 1 / max_possible_val, clamp negatives at 0;
    4. 'bestFit' additionally applies gamma (the default gamma of 1).
    """
    img = image.to(torch.float32)
    if clear_extreme_percentage > 0:
        new_max = percentile(img, 100.0 - clear_extreme_percentage)
        new_min = percentile(img, clear_extreme_percentage)
        if minimum_pixel_val > 0:
            new_min = torch.clamp_min(new_min, minimum_pixel_val)
        img = torch.minimum(img, new_max)
    else:
        new_min = torch.as_tensor(minimum_pixel_val, dtype=torch.float32,
                                  device=img.device)
    if method in ("minMax", "bestFit"):
        img = img - new_min
        img = img / img.max()
        img = img + 1.0 / max_possible_val
        img = torch.clamp_min(img, 0.0)
    if method == "bestFit":
        img = adjust_gamma(img)
    return img


def set_brightness(image: torch.Tensor, channel_axis: int = 0,
                   method: str = "bestFit",
                   clear_extreme_percentage: float = 1.0,
                   min_val: float = 0.0, max_val: float = 0.0) -> torch.Tensor:
    """Normalise each channel of an image or movie to floats in [0, 1].
    ``channel_axis < 0`` means single-channel data."""
    if max_val:
        max_possible = float(max_val)
    else:
        max_possible = {torch.uint8: 255.0, torch.uint16: 65535.0}.get(
            image.dtype, 1.0)

    def one(ch):
        return set_channel_brightness(ch, max_possible, method,
                                      clear_extreme_percentage,
                                      max(min_val, 0.0))

    if channel_axis < 0:
        return one(image)
    moved = torch.movedim(image, channel_axis, 0)
    return torch.movedim(torch.stack([one(ch) for ch in moved]), 0,
                         channel_axis)


def binary_image(image: torch.Tensor, thresholds,
                 channel_axis: int = -1) -> torch.Tensor:
    """Per-channel binarisation: pixels above the channel's threshold -> 1,
    below -> 0, exactly at it keep their value."""
    img = image.to(torch.float32)
    thr = torch.as_tensor(thresholds, dtype=torch.float32, device=img.device)
    if channel_axis >= 0:
        if thr.dim() == 0:
            thr = thr.expand(image.shape[channel_axis])
        shape = [1] * image.dim()
        shape[channel_axis] = image.shape[channel_axis]
        thr = thr.reshape(shape)
    else:
        thr = thr.reshape(())
    return torch.where(img > thr, 1.0, torch.where(img < thr, 0.0, img))


def normalize_channel(image: torch.Tensor) -> torch.Tensor:
    """1-99 percentile clip and rescale to [0, 1] — the U-Net predictor's
    per-channel normalisation. A constant channel gives 0 / 0 = NaN."""
    img = image.to(torch.float32)
    p99 = percentile(img, 99.0)
    p1 = percentile(img, 1.0)
    img = torch.clamp(img, min=p1, max=p99)
    return (img - p1) / (p99 - p1)
