"""Fused separable 3-D Gaussian blur: CUDA kernel wrapper and plain version.

Port of ``tissue_image_processing_tpu/ops/blur_pallas.py:blur3d_pallas``. The
kernel (``csrc/blur3d.cu``) reads the volume once and writes it once;
``blur3d_plain`` runs the same tap order (z, then y, then x, each summed from
tap 0 upward over an edge-replicated axis) as separate PyTorch multiplies and
adds, and is what CPU tensors use.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tissue_image_processing_tpu_torch import _device

__all__ = ["blur3d", "blur3d_plain", "MAX_TAPS"]

MAX_TAPS = 33
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"blur3d_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)}


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
    """Edge-replicate separable correlation of a (Z, Y, X) float32 volume
    along z, y, x with host-side tap sequences (odd lengths <= 33).

    CPU tensors run :func:`blur3d_plain`; CUDA tensors launch the kernel or
    raise."""
    if x.dim() != 3:
        raise ValueError(f"blur3d: expected (Z, Y, X), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return blur3d_plain(x, kz, ky, kx)
    taps = [list(map(float, k)) for k in (kz, ky, kx)]
    if any(len(k) > MAX_TAPS or len(k) % 2 == 0 for k in taps):
        raise ValueError(f"blur3d: tap counts {[len(k) for k in taps]} must be "
                         f"odd and <= {MAX_TAPS}")
    _device.require_cuda_tensor(x, torch.float32, 3, "blur3d")
    lib = _device.load_library("blur3d", _SIGNATURES)
    Z, Y, X = x.shape
    w = _device.host_to_device(
        torch.tensor(taps[0] + taps[1] + taps[2], dtype=torch.float32), x.device)
    out = torch.empty_like(x)
    rc = lib.blur3d_f32(_device.ptr(x), _device.ptr(out), _device.ptr(w), Z, Y,
                        X, len(taps[0]), len(taps[1]), len(taps[2]),
                        _device.stream_ptr())
    _device.check_cuda(lib, rc, "blur3d")
    _device.LAUNCHES["blur3d"] += 1
    return out
