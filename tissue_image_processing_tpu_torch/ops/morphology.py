"""Shifts and the rectangular max filter over the trailing two axes.

Port of ``tissue_image_processing_tpu/ops/morphology.py`` (the parts the
watershed path and the cell tables use). Min and max are exact, so these agree
with the JAX versions bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["shift2d", "maximum_filter"]


def shift2d(x: torch.Tensor, dy: int, dx: int, cval) -> torch.Tensor:
    """``out[..., y, x] = x[..., y - dy, x - dx]``, vacated pixels = ``cval``."""
    H, W = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, cval)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    ys, yd = (slice(0, H - dy), slice(dy, H)) if dy >= 0 else \
        (slice(-dy, H), slice(0, H + dy))
    xs, xd = (slice(0, W - dx), slice(dx, W)) if dx >= 0 else \
        (slice(-dx, W), slice(0, W + dx))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def _window_reduce(x: torch.Tensor, size, cval, op) -> torch.Tensor:
    """Separable centred (sy, sx) window reduction with constant padding."""
    sy, sx = (size, size) if isinstance(size, int) else size
    out = x
    for axis, s in ((-2, sy), (-1, sx)):
        if s <= 1:
            continue
        r = (s - 1) // 2
        acc = None
        for d in range(-r, s - r):
            sh = shift2d(out, -d, 0, cval) if axis == -2 else \
                shift2d(out, 0, -d, cval)
            acc = sh if acc is None else op(acc, sh)
        out = acc
    return out


def maximum_filter(x: torch.Tensor, size=3, cval=0) -> torch.Tensor:
    """``scipy.ndimage.maximum_filter(x, size, mode='constant', cval=cval)``."""
    return _window_reduce(x, size, cval, torch.maximum)
