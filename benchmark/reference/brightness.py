"""Brightness / contrast normalisation.

Frozen copy of the plain code of the port's ``ops/brightness.py``: the reference's
channel normalisers (``set_brightness``, ``set_channel_brightness``,
``binary_image``, skimage's ``adjust_gamma``) and the U-Net predictor's 1-99
percentile ``normalize_channel``. Percentiles come from
:func:`~benchmark.reference.percentile.percentile` and stay
on the input's device; nothing here reads a value on the host.
"""

from __future__ import annotations

import torch

from benchmark.reference.percentile import percentile

__all__ = ["normalize_channel"]


def normalize_channel(image: torch.Tensor) -> torch.Tensor:
    """1-99 percentile clip and rescale to [0, 1] — the U-Net predictor's
    per-channel normalisation. A constant channel gives 0 / 0 = NaN."""
    img = image.to(torch.float32)
    p99 = percentile(img, 99.0)
    p1 = percentile(img, 1.0)
    img = torch.clamp(img, min=p1, max=p99)
    return (img - p1) / (p99 - p1)
