"""Fused surface projection: the whole per-timepoint projection in two passes
over the movie.

Port of ``tissue_image_processing_tpu/projection/fused.py``:

- **score pass** (:func:`score_pass`, kernel ``proj_score`` in
  ``csrc/projection.cu``): one read of the uint16 reference channel -> airyscan
  offset, p95 clip, (0.5, 1, 1) blur and 4 x 4 mean decimation -> the small
  (Z, Y/4, X/4) score volume;
- the small-score blur, argmax and bilinear z-map upsample (plain PyTorch on
  ~4 MB);
- **project pass** (:func:`project_pass`, kernel ``proj_project``): one read
  of the raw channels and the z-map -> the blurred one-hot z-mask, built per
  tile and never stored, times each channel, max over z -> (C, Y, X).

Each kernel has a plain PyTorch version (``score_pass_plain``,
``project_pass_plain``) that sums the same taps in the same order (z, then y,
then x, each from tap 0 upward); CPU tensors run it, CUDA tensors launch the
kernel or raise, and on the card the two agree bit for bit.

The result is that of the ``fast=True`` route of
:func:`~tissue_image_processing_tpu_torch.projection.surface.time_point_surface_projection`
except that the z-map argmax runs at the decimated score resolution and is
upsampled bilinearly, which moves the z-map by at most one plane on near-ties.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.ops.blur_cuda import (
    _correlate_nearest, blur3d_plain)
from tissue_image_processing_tpu_torch.ops.filters import (
    gaussian_blur, resize_bilinear)
from tissue_image_processing_tpu_torch.ops.percentile import masked_percentile

__all__ = ["fused_projection", "fused_projection_supported", "score_pass",
           "score_pass_plain", "project_pass", "project_pass_plain"]

_BY = 64  # the TPU kernels' row block, kept in the shape gate
_DEC = 4  # score decimation
_MAX_Z = 256  # z-planes the project kernel's table holds

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "proj_score": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "proj_project": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                     _P),
}


def _taps(sigma: float, truncate: float = 4.0) -> Tuple[float, ...]:
    """Gaussian taps computed in float64 and rounded to float32 (the JAX
    fused kernels' taps; they differ from ``gaussian_kernel1d``'s float32
    construction in the last bit)."""
    radius = int(truncate * float(sigma) + 0.5)
    if radius <= 0 or sigma <= 0:
        return (1.0,)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return tuple((k / k.sum()).astype(np.float32).tolist())


_SCORE_TAPS = (_taps(0.5), _taps(1.0), _taps(1.0))
_PROJECT_TAPS = (_taps(1.0), _taps(2.0), _taps(2.0))


def fused_projection_supported(shape) -> bool:
    """(C, Z, Y, X) with Y % 64 == 0, X % 128 == 0, Z <= 64 and Y >= 128:
    the JAX fused route's gate, kept so that both packages take the same
    route for the same movie."""
    if len(shape) != 4:
        return False
    _, Z, Y, X = shape
    return (Y % _BY == 0 and X % 128 == 0 and Y % _DEC == 0 and X % _DEC == 0
            and Z <= 64 and Y >= 2 * _BY)


def _pool4(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Mean of each 4 consecutive entries along ``axis``, summed in order
    then scaled by 0.25 (exact: a power of two)."""
    xr = x.unflatten(axis, (x.shape[axis] // _DEC, _DEC))
    parts = [xr.select(axis + 1, d) for d in range(_DEC)]
    return (parts[0] + parts[1] + parts[2] + parts[3]) * 0.25


def score_pass_plain(vol: torch.Tensor, p95: torch.Tensor,
                     airyscan_offset: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`score_pass` (any device)."""
    kz, ky, kx = _SCORE_TAPS
    v = vol.to(torch.float32)
    if airyscan_offset:
        v = torch.clamp_min(v - airyscan_offset, 0.0)
    v = torch.minimum(v, p95.to(torch.float32))
    v = _correlate_nearest(v, kz, 0)
    v = _pool4(_correlate_nearest(v, ky, 1), 1)
    return _pool4(_correlate_nearest(v, kx, 2), 2)


def score_pass(vol: torch.Tensor, p95: torch.Tensor,
               airyscan_offset: float = 0.0) -> torch.Tensor:
    """(Z, Y, X) uint16 reference channel and a 0-d float32 p95 on the same
    device -> (Z, Y/4, X/4) float32: offset, clip at p95, (0.5, 1, 1) blur,
    4 x 4 mean. CPU tensors run :func:`score_pass_plain`; CUDA tensors launch
    ``proj_score`` or raise. p95 is read on the card, never on the host."""
    if vol.dim() != 3 or vol.shape[1] % _DEC or vol.shape[2] % _DEC:
        raise ValueError(f"score_pass: expected (Z, Y, X) with Y, X multiples "
                         f"of {_DEC}, got {tuple(vol.shape)}")
    if p95.numel() != 1 or p95.device != vol.device:
        raise ValueError("score_pass: p95 must be one value on the volume's device")
    if vol.device.type == "cpu":
        return score_pass_plain(vol, p95, airyscan_offset)
    _device.require_cuda_tensor(vol, torch.uint16, 3, "score_pass")
    lib = _device.load_library("projection", _SIGNATURES)
    Z, Y, X = vol.shape
    p = p95.to(torch.float32).reshape(1).contiguous()
    out = torch.empty((Z, Y // _DEC, X // _DEC), dtype=torch.float32,
                      device=vol.device)
    _device.launch(lib, lib.proj_score, vol.device, "proj_score",
                   _device.ptr(vol), _device.ptr(p),
                   _device.host_floats(sum(_SCORE_TAPS, ())),
                   _device.ptr(out), Z, Y, X, *(len(k) for k in _SCORE_TAPS),
                   float(airyscan_offset))
    _device.count_launch("proj_score")
    return out


def _mask_plain(rel_z: torch.Tensor, Z: int,
                taps: Sequence[Tuple[float, ...]]) -> torch.Tensor:
    zidx = torch.arange(Z, dtype=torch.int32, device=rel_z.device)
    onehot = (zidx.reshape(Z, 1, 1) == rel_z[None]).to(torch.float32)
    return blur3d_plain(onehot, *taps)


def project_pass_plain(img: torch.Tensor, rel_z: torch.Tensor,
                       airyscan_offset: float = 0.0, ref_channel: int = 0,
                       atoh_shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`project_pass` (any device)."""
    C, Z = img.shape[:2]
    rel_z = rel_z.to(torch.int32)
    m = _mask_plain(rel_z, Z, _PROJECT_TAPS)
    m_s = (_mask_plain(torch.clamp(rel_z + atoh_shift, 0, Z - 1), Z,
                       _PROJECT_TAPS) if atoh_shift else m)
    out = []
    for c in range(C):
        v = img[c].to(torch.float32)
        if airyscan_offset:
            v = torch.clamp_min(v - airyscan_offset, 0.0)
        mm = m if (not atoh_shift or c == ref_channel) else m_s
        out.append((v * mm).amax(dim=0))
    return torch.stack(out)


def project_pass(img: torch.Tensor, rel_z: torch.Tensor,
                 airyscan_offset: float = 0.0, ref_channel: int = 0,
                 atoh_shift: int = 0) -> torch.Tensor:
    """(C, Z, Y, X) uint16 channels and a (Y, X) int32 z-map with values in
    [0, Z) -> (C, Y, X) float32: each channel (after the airyscan offset)
    times the (1, 2, 2)-blurred one-hot mask of the z-map (shifted by
    ``atoh_shift`` for channels other than ``ref_channel``), max over z.
    CPU tensors run :func:`project_pass_plain`; CUDA tensors launch
    ``proj_project`` or raise."""
    if img.dim() != 4 or tuple(rel_z.shape) != tuple(img.shape[2:]):
        raise ValueError(f"project_pass: expected (C, Z, Y, X) and a (Y, X) "
                         f"z-map, got {tuple(img.shape)} and {tuple(rel_z.shape)}")
    if not 0 <= ref_channel < img.shape[0]:
        raise ValueError(f"project_pass: ref_channel {ref_channel} out of range")
    if rel_z.device != img.device:
        raise ValueError("project_pass: z-map and channels on different devices")
    if img.device.type == "cpu":
        return project_pass_plain(img, rel_z, airyscan_offset, ref_channel,
                                  atoh_shift)
    _device.require_cuda_tensor(img, torch.uint16, 4, "project_pass")
    _device.require_cuda_tensor(rel_z, torch.int32, 2, "project_pass z-map")
    C, Z, Y, X = img.shape
    if Z > _MAX_Z:
        raise ValueError(f"project_pass: at most {_MAX_Z} z-planes, got {Z}")
    lib = _device.load_library("projection", _SIGNATURES)
    out = torch.empty((C, Y, X), dtype=torch.float32, device=img.device)
    _device.launch(lib, lib.proj_project, img.device, "proj_project",
                   _device.ptr(img), _device.ptr(rel_z),
                   _device.host_floats(sum(_PROJECT_TAPS, ())),
                   _device.ptr(out), C, Z, Y, X,
                   *(len(k) for k in _PROJECT_TAPS), float(airyscan_offset),
                   int(ref_channel), int(atoh_shift))
    _device.count_launch("proj_project")
    return out


def fused_projection(image: torch.Tensor, reference_channel: int = 0,
                     airyscan: bool = False, airyscan_offset: float = 10000.0,
                     atoh_shift: int = 0):
    """The 'max_averages' surface projection of one (C, Z, Y, X) stack in two
    passes. Returns ((C, Y, X) float32 projection, (Y, X) int32 z-map) like
    ``time_point_surface_projection``; the stack is converted to uint16 as
    the kernels read it."""
    C, Z, Y, X = image.shape
    img_u16 = image if image.dtype == torch.uint16 else image.to(torch.uint16)
    img_u16 = img_u16.contiguous()
    off = airyscan_offset if airyscan else 0.0
    ref = img_u16[reference_channel]
    # p95 of the positive values of a 1-in-16 whole-row subsample
    sub = ref[:, ::16, :].to(torch.float32)
    if off:
        sub = torch.clamp_min(sub - off, 0.0)
    p95 = masked_percentile(sub, sub > 0, 95.0)
    small = score_pass(ref, p95, airyscan_offset=off)  # (Z, Y/4, X/4)
    score = gaussian_blur(small, (0.5, 30.0 / _DEC, 30.0 / _DEC), fast=True)
    rel_small = torch.argmax(score, dim=0).to(torch.float32)
    rel_z = torch.round(resize_bilinear(rel_small, (Y, X))).to(torch.int32)
    rel_z = torch.clamp(rel_z, 0, Z - 1)
    proj = project_pass(img_u16, rel_z, airyscan_offset=off,
                        ref_channel=reference_channel, atoh_shift=atoh_shift)
    return proj, rel_z
