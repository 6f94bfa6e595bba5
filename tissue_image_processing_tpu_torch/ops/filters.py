"""Separable Gaussian filtering with ``scipy.ndimage`` ``mode='nearest'``.

Port of ``tissue_image_processing_tpu/ops/filters.py`` (``gaussian_kernel1d``
and ``gaussian_blur``). Every 2-D and 3-D blur runs through
:func:`~tissue_image_processing_tpu_torch.ops.blur_cuda.blur3d`: the CUDA
kernel for tensors on the card, its plain version for CPU tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from tissue_image_processing_tpu_torch.ops.blur_cuda import blur3d

__all__ = ["gaussian_kernel1d", "gaussian_blur"]


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> Tuple[float, ...]:
    """Host-side float32 Gaussian taps identical in construction to scipy's
    (normalised, radius ``int(truncate * sigma + 0.5)``)."""
    radius = int(truncate * float(sigma) + 0.5)
    if radius <= 0 or sigma <= 0:
        return (1.0,)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / np.float32(sigma)) ** 2).astype(np.float32)
    return tuple(float(v) for v in (k / k.sum()))


def gaussian_blur(image: torch.Tensor,
                  std: Union[float, Sequence[float]],
                  truncate: float = 4.0) -> torch.Tensor:
    """Gaussian blur of a 2-D or 3-D image, matching
    ``scipy.ndimage.gaussian_filter(image, std, mode='nearest')``.

    ``std`` is a scalar (every axis) or one value per axis; an axis with
    sigma 0 is left as it is."""
    if image.dim() not in (2, 3):
        raise ValueError(f"gaussian_blur takes 2-D or 3-D images, got "
                         f"{tuple(image.shape)}")
    if not hasattr(std, "__len__"):
        std = (float(std),) * image.dim()
    if len(std) != image.dim():
        raise ValueError(f"std {std} does not match image ndim {image.dim()}")
    std3 = (0.0,) * (3 - image.dim()) + tuple(float(s) for s in std)
    kernels = [gaussian_kernel1d(s, truncate) for s in std3]
    vol = image.to(torch.float32).reshape((1,) * (3 - image.dim()) + image.shape)
    return blur3d(vol.contiguous(), *kernels).reshape(image.shape)
