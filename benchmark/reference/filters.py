"""Separable Gaussian filtering with ``scipy.ndimage`` ``mode='nearest'``,
block reduction and bilinear resizing.

Frozen copy of the plain code of the port's ``ops/filters.py`` (``gaussian_kernel1d``,
``gaussian_blur``, ``band_pass_filter``, ``block_reduce``,
``resize_bilinear``). ``gaussian_blur``
routes each axis as the JAX version does off the TPU:

- ``fast=True``, sigma >= 6 and the axis longer than 512: a cascade of four
  box filters by cumulative sums (:func:`_box_blur_axis`);
- otherwise kernels of at least 31 taps on axes of at most 8192: a product
  with the edge-folded band matrix (:func:`_band_matrix_nearest`), a plain
  float32 ``torch.matmul`` (``torch.backends.cuda.matmul.allow_tf32`` stays
  False, PyTorch's default, so the card computes it in full float32);
- everything else through
  :func:`~benchmark.reference.blur.blur3d`, the plain separable blur.
  Consecutive axes of this route share one ``blur3d`` call.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from benchmark.reference.host import host_to_device
from benchmark.reference.blur import blur3d

__all__ = ["gaussian_kernel1d", "gaussian_blur", "block_reduce",
           "resize_bilinear"]

# kernels with at least this many taps take the band-matrix product
_MATMUL_TAP_THRESHOLD = 31


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> Tuple[float, ...]:
    """Host-side float32 Gaussian taps identical in construction to scipy's
    (normalised, radius ``int(truncate * sigma + 0.5)``)."""
    radius = int(truncate * float(sigma) + 0.5)
    if radius <= 0 or sigma <= 0:
        return (1.0,)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / np.float32(sigma)) ** 2).astype(np.float32)
    return tuple(float(v) for v in (k / k.sum()))


def _band_matrix_nearest(kernel: Sequence[float], length: int,
                         device) -> torch.Tensor:
    """(L, L) float32 matrix B with ``x @ B.T`` equal to the edge-replicate
    correlation of ``x`` with ``kernel`` along its last axis: the taps that
    fall outside the axis fold onto its first and last columns."""
    k = host_to_device(torch.tensor(kernel, dtype=torch.float32), device)
    ksize = k.shape[0]
    r = (ksize - 1) // 2
    i = torch.arange(length, device=device).reshape(-1, 1)
    j = torch.arange(length, device=device).reshape(1, -1)
    d = j - i
    base = torch.where(d.abs() <= r, k[torch.clamp(d + r, 0, ksize - 1)],
                       torch.zeros((), device=device))
    csum = torch.cumsum(k, 0)
    total = csum[-1]
    rows = torch.arange(length, device=device)
    left = torch.where(r - rows - 1 >= 0,
                       csum[torch.clamp(r - rows - 1, 0, ksize - 1)],
                       torch.zeros((), device=device))
    hi = length - 1 - rows + r
    right = torch.where(hi < ksize - 1,
                        total - csum[torch.clamp(hi, 0, ksize - 1)],
                        torch.zeros((), device=device))
    base[:, 0] += left
    base[:, length - 1] += right
    return base


def _band_blur_axis(x: torch.Tensor, kernel: Sequence[float],
                    axis: int) -> torch.Tensor:
    L = x.shape[axis]
    B = _band_matrix_nearest(kernel, L, x.device)
    xm = torch.movedim(x, axis, -1)
    out = torch.matmul(xm.reshape(-1, L), B.T).reshape(xm.shape)
    return torch.movedim(out, -1, axis)


def _box_sizes_for_gaussian(sigma: float, n: int = 4):
    """n box widths whose cascade approximates a Gaussian of ``sigma``
    (Kovesi's 'fast almost-Gaussian' construction)."""
    w_ideal = math.sqrt(12.0 * sigma * sigma / n + 1.0)
    wl = int(math.floor(w_ideal))
    if wl % 2 == 0:
        wl -= 1
    wu = wl + 2
    m_ideal = (12 * sigma * sigma - n * wl * wl - 4 * n * wl - 3 * n) / \
        (-4 * wl - 4)
    m = int(round(m_ideal))
    return [wl] * m + [wu] * (n - m)


def _box_blur_axis(x: torch.Tensor, width: int, axis: int) -> torch.Tensor:
    """Normalised edge-replicate box filter along ``axis`` by cumulative
    sums."""
    if width <= 1:
        return x
    r = width // 2
    L = x.shape[axis]
    idx = torch.clamp(torch.arange(-(r + 1), L + r, device=x.device), 0, L - 1)
    cs = torch.cumsum(torch.index_select(x, axis, idx), dim=axis)
    return (cs.narrow(axis, width, L) - cs.narrow(axis, 0, L)) / width


def gaussian_blur(image: torch.Tensor,
                  std: Union[float, Sequence[float]],
                  truncate: float = 4.0, fast: bool = False) -> torch.Tensor:
    """Gaussian blur of a 2-D or 3-D image, matching
    ``scipy.ndimage.gaussian_filter(image, std, mode='nearest')``.

    ``std`` is a scalar (every axis) or one value per axis; an axis with
    sigma 0 is left as it is. ``fast=True`` approximates axes with sigma
    >= 6 longer than 512 by a four-box cascade (within ~0.5% of the exact
    Gaussian), for scores where only an argmax matters."""
    if image.dim() not in (2, 3):
        raise ValueError(f"gaussian_blur takes 2-D or 3-D images, got "
                         f"{tuple(image.shape)}")
    if not hasattr(std, "__len__"):
        std = (float(std),) * image.dim()
    if len(std) != image.dim():
        raise ValueError(f"std {std} does not match image ndim {image.dim()}")
    out = image.to(torch.float32)
    pending = [(1.0,)] * out.dim()  # taps of axes waiting for one blur3d call

    def flush(x):
        if all(len(k) == 1 for k in pending):
            return x
        lead = (1,) * (3 - x.dim())
        vol = x.reshape(lead + tuple(x.shape)).contiguous()
        kz, ky, kx = [(1.0,)] * len(lead) + pending
        pending[:] = [(1.0,)] * x.dim()
        return blur3d(vol, kz, ky, kx).reshape(x.shape)

    for axis, sigma in enumerate(float(s) for s in std):
        L = out.shape[axis]
        if fast and sigma >= 6.0 and L > 512:
            out = flush(out)
            for width in _box_sizes_for_gaussian(sigma):
                out = _box_blur_axis(out, width, axis)
            continue
        kernel = gaussian_kernel1d(sigma, truncate)
        if len(kernel) >= _MATMUL_TAP_THRESHOLD and 1 < L <= 8192:
            out = _band_blur_axis(flush(out), kernel, axis)
        else:
            pending[axis] = kernel
    return flush(out)


def block_reduce(image: torch.Tensor, block: Sequence[int],
                 func: str = "mean") -> torch.Tensor:
    """Downsample by non-overlapping blocks after zero-padding each axis to a
    multiple of its block (``skimage.measure.block_reduce``); ``func`` is
    "mean", "var" (population variance) or "max"."""
    block = tuple(int(b) for b in block)
    if len(block) != image.dim():
        raise ValueError("block rank mismatch")
    if func not in ("mean", "var", "max"):
        raise ValueError(f"unknown reduce func {func}")
    pads = []
    for dim, b in zip(reversed(image.shape), reversed(block)):
        pads += [0, (-dim) % b]
    x = torch.nn.functional.pad(image, pads)
    new_shape = []
    for dim, b in zip(x.shape, block):
        new_shape += [dim // b, b]
    x = x.reshape(new_shape)
    axes = tuple(range(1, x.dim(), 2))
    if func == "mean":
        return x.mean(dim=axes)
    if func == "var":
        return x.var(dim=axes, correction=0)
    return x.amax(dim=axes)


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 triangle-kernel weights of ``jax.image.resize``
    (``method='linear'``, ``antialias=True``): half-pixel sample centres, the
    kernel widened by the inverse scale when downsampling, columns normalised
    to sum 1, samples outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(image: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Linear resize of every axis whose size changes, as
    ``jax.image.resize(image, shape, "linear")`` computes it: one float32
    weight matrix per axis (:func:`_linear_weights`), contracted in turn.
    Covers upsampling and (antialiased) downsampling."""
    out = image.to(torch.float32)
    if len(shape) != out.dim():
        raise ValueError(f"shape {tuple(shape)} does not match {tuple(out.shape)}")
    for axis, n_out in enumerate(int(s) for s in shape):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        w = host_to_device(torch.from_numpy(_linear_weights(n_in, n_out)),
                           out.device)
        out = torch.movedim(torch.tensordot(out, w, dims=([axis], [0])), -1, axis)
    return out
