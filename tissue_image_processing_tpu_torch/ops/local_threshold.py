"""Block-local max thresholding.

Port of ``tissue_image_processing_tpu/ops/local_threshold.py``: the
``block_size`` window max with reflect padding (skimage ``threshold_local``'s
default mode) as a separable log-doubling sliding max. Max is exact, so the
result equals the JAX version bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["threshold_local_max"]


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Source indices of numpy ``mode='reflect'`` padding by ``r`` on both
    sides (edge not repeated; periodic for pads longer than the axis)."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i > n - 1, period - i, i)


def _sliding_max_1d(x: torch.Tensor, window: int, axis: int) -> torch.Tensor:
    """Centred window-``window`` max along ``axis`` (window odd)."""
    r = window // 2
    n = x.shape[axis]
    xp = torch.index_select(x, axis, _reflect_index(n, r, x.device))
    f = xp
    size = 1
    while size * 2 <= window:
        valid = f.shape[axis] - size
        f = torch.maximum(f.narrow(axis, 0, valid), f.narrow(axis, size, valid))
        size *= 2
    valid = n
    return torch.maximum(f.narrow(axis, 0, valid),
                         f.narrow(axis, window - size, valid))


def threshold_local_max(image: torch.Tensor, block_size: int) -> torch.Tensor:
    """Windowed maximum with reflect padding over the trailing 2 axes;
    ``block_size`` is forced odd like the reference."""
    if block_size % 2 == 0:
        block_size += 1
    x = image.to(torch.float32)
    x = _sliding_max_1d(x, block_size, x.dim() - 2)
    return _sliding_max_1d(x, block_size, x.dim() - 1)
