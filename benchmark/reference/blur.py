"""Separable 3-D Gaussian blur, plain PyTorch.

Frozen copy of the port's ``ops/blur_cuda.py:blur3d_plain``: the tap order
(z, then y, then x, each summed from tap 0 upward over an edge-replicated
axis) as separate PyTorch multiplies and adds. The port's kernel forms equal
it bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["blur3d"]

MAX_TAPS = 33


def _correlate_nearest(x: torch.Tensor, taps: Sequence[float],
                       axis: int) -> torch.Tensor:
    """Edge-replicate correlation along ``axis``: tap-by-tap shift and add."""
    k = len(taps)
    r = (k - 1) // 2
    L = x.shape[axis]
    idx = torch.clamp(torch.arange(-r, L + r, device=x.device), 0, L - 1)
    xp = torch.index_select(x, axis, idx)
    out = None
    for t, w in enumerate(taps):
        term = xp.narrow(axis, t, L) * float(w)
        out = term if out is None else out + term
    return out


def blur3d_plain(x: torch.Tensor, kz: Sequence[float], ky: Sequence[float],
                 kx: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version of :func:`blur3d` (any device)."""
    out = x.to(torch.float32)
    for axis, taps in ((0, kz), (1, ky), (2, kx)):
        out = _correlate_nearest(out, taps, axis)
    return out


def blur3d(x: torch.Tensor, kz: Sequence[float], ky: Sequence[float],
           kx: Sequence[float]) -> torch.Tensor:
    """Edge-replicate separable correlation of a (Z, Y, X) volume along z,
    y, x (odd tap counts <= 33), on the volume's device."""
    if x.dim() != 3:
        raise ValueError(f"blur3d: expected (Z, Y, X), got {tuple(x.shape)}")
    if any(len(k) > MAX_TAPS or len(k) % 2 == 0 for k in (kz, ky, kx)):
        raise ValueError("blur3d: tap counts must be odd and <= 33")
    return blur3d_plain(x, kz, ky, kx)
