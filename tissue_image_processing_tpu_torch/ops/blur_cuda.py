"""Fused separable 3-D Gaussian blur: CUDA kernel wrapper and plain version.

Port of ``tissue_image_processing_tpu/ops/blur_pallas.py:blur3d_pallas``. The
kernels (``csrc/blur3d.cu``) read the volume once and write it once, in one
of four forms that :func:`blur3d_form` picks by the taps: a register-only
form for blurs along z alone, a tile form with 25 y / x taps compiled in,
the walk form (a block walks z through its tile, the z window in
registers) for the unfused projection's and the band-pass filter's tap
sets, and the generic tile form for every other tap set. ``blur3d_plain``
runs the same tap order (z, then y, then x, each summed from tap 0 upward
over an edge-replicated axis) as separate PyTorch multiplies and adds, and
is what CPU tensors use. Every form equals it bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from tissue_image_processing_tpu_torch import _device

__all__ = ["blur3d", "blur3d_plain", "blur3d_form", "MAX_TAPS", "WALK_TAPS"]

MAX_TAPS = 33
# the walk form's compiled tap counts (tz, ty, tx): band_pass_filter's low
# sigma, the unfused projection's pre-blur and its z-mask blur
WALK_TAPS = ((1, 9, 9), (5, 9, 9), (9, 17, 17))
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_SIGNATURES = {"blur3d_f32": _ARGS, "blur3d_walk_f32": _ARGS}


def blur3d_form(shape: Sequence[int], taps: Sequence[int]) -> str:
    """The kernel form for a (Z, Y, X) volume blurred with (tz, ty, tx)
    taps: ``"z_only"`` (ty == tx == 1), ``"tile25"`` (ty == tx == 25, the
    watershed pre-blur), ``"walk"`` (the taps of ``WALK_TAPS``, at every
    shape: the band-pass filter's low sigma, the unfused projection's
    pre-blur and z-mask blur), else ``"generic"``."""
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"blur3d_form: expected a (Z, Y, X) shape, got {shape}")
    tz, ty, tx = (int(t) for t in taps)
    if ty == tx == 1:
        return "z_only"
    if ty == tx == 25:
        return "tile25"
    if (tz, ty, tx) in WALK_TAPS:
        return "walk"
    return "generic"


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
           kx: Sequence[float], form: Optional[str] = None) -> torch.Tensor:
    """Edge-replicate separable correlation of a (Z, Y, X) float32 volume
    along z, y, x with host-side tap sequences (odd lengths <= 33).

    CPU tensors run :func:`blur3d_plain`; CUDA tensors launch the kernel
    form that :func:`blur3d_form` picks, or raise. ``form="generic"``
    forces the generic tile form in place of the walk form (to time the
    two in one run); any other ``form`` must be the one picked."""
    if x.dim() != 3:
        raise ValueError(f"blur3d: expected (Z, Y, X), got {tuple(x.shape)}")
    taps = [list(map(float, k)) for k in (kz, ky, kx)]
    counts = tuple(map(len, taps))
    if any(n > MAX_TAPS or n % 2 == 0 for n in counts):
        raise ValueError(f"blur3d: tap counts {list(counts)} must be odd and "
                         f"<= {MAX_TAPS}")
    picked = blur3d_form(tuple(x.shape), counts)
    if form is None:
        form = picked
    elif form != picked and not (form == "generic" and picked == "walk"):
        raise ValueError(f"blur3d: the {form} form does not take taps "
                         f"{counts} (picked: {picked})")
    if x.device.type == "cpu":
        return blur3d_plain(x, kz, ky, kx)
    _device.require_cuda_tensor(x, torch.float32, 3, "blur3d")
    lib = _device.load_library("blur3d", _SIGNATURES)
    entry = lib.blur3d_walk_f32 if form == "walk" else lib.blur3d_f32
    Z, Y, X = x.shape
    out = torch.empty_like(x)
    _device.launch(lib, entry, x.device, f"blur3d ({form})", _device.ptr(x),
                   _device.ptr(out),
                   _device.host_floats(taps[0] + taps[1] + taps[2]), Z, Y, X,
                   *counts)
    _device.count_launch("blur3d", 1,
                         (_device.BLUR_LAUNCHES, (Z, Y, X, *counts)),
                         (_device.BLUR_FORMS, form))
    return out
