"""Shifts, rectangular and plus-shaped max / min filters and flat-footprint
grey / binary morphology over the trailing two axes.

Frozen copy of the plain code of the port's ``ops/morphology.py``. Min and max are
exact, so these agree with the JAX versions bit for bit. Leading axes are
batch axes.
"""

from __future__ import annotations

import torch

__all__ = ["shift2d", "maximum_filter", "grey_dilation", "grey_erosion",
           "binary_dilation", "binary_erosion", "binary_closing"]


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


def _constant_mode(mode: str, cval):
    if mode != "constant":
        raise NotImplementedError("only constant mode is used by the pipeline")
    return 0 if cval is None else cval


def maximum_filter(x: torch.Tensor, size=3, mode: str = "constant",
                   cval=None) -> torch.Tensor:
    """``scipy.ndimage.maximum_filter`` with a rectangular footprint over the
    trailing two axes; ``mode='constant'`` pads with ``cval`` (default 0)."""
    return _window_reduce(x, size, _constant_mode(mode, cval), torch.maximum)


def _extreme(dtype: torch.dtype, largest: bool):
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.max if largest else info.min


def grey_dilation(x: torch.Tensor, size: int = 5) -> torch.Tensor:
    """``skimage.morphology.dilation`` with a size x size ones footprint
    (window ``[-r, size - 1 - r]``, ``r = (size - 1) // 2``). Outside the
    image counts as the dtype minimum, so the frame edge adds nothing."""
    return _window_reduce(x, size, _extreme(x.dtype, False), torch.maximum)


def grey_erosion(x: torch.Tensor, size: int = 5) -> torch.Tensor:
    """``skimage.morphology.erosion`` with a size x size ones footprint.
    Outside the image counts as the dtype maximum, so an erosion does not
    eat into the frame edge."""
    return _window_reduce(x, size, _extreme(x.dtype, True), torch.minimum)


def binary_dilation(x: torch.Tensor, size: int = 5) -> torch.Tensor:
    return grey_dilation(x.to(torch.float32), size) > 0


def binary_erosion(x: torch.Tensor, size: int = 5) -> torch.Tensor:
    return grey_erosion(x.to(torch.float32), size) > 0


def binary_closing(x: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Binary closing (dilate, then erode). Closing with a flat footprint is
    idempotent, so one pass equals the reference's repeated rounds."""
    return binary_erosion(binary_dilation(x, size), size)
