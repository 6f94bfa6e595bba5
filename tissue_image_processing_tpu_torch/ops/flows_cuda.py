"""Cellpose's flow following on the card: the wrapper of
``csrc/follow_flows.cu``. The plain version is
:func:`tissue_image_processing_tpu_torch.ops.flows.follow_plain`; the
kernel equals it bit for bit. The library is built at its first call, so a
pipeline that never follows flows never builds it."""

from __future__ import annotations

import ctypes

import torch

from tissue_image_processing_tpu_torch import _device

__all__ = ["follow_cuda"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"follow_flows": (_P, _P, _I, _I, _I, _I)}


def _lib():
    return _device.load_library("follow_flows", _SIGNATURES)


def follow_cuda(d: torch.Tensor, niter: int) -> torch.Tensor:
    """(B, 2, Y, X) float32 flows on the card -> (B, 2, Y, X) float32 final
    positions (y, x) after ``niter`` steps; one launch."""
    _device.require_cuda_tensor(d, torch.float32, 4, "follow_flows")
    if d.shape[1] != 2:
        raise ValueError(f"follow_flows: expected (B, 2, Y, X), got "
                         f"{tuple(d.shape)}")
    B, _, Y, X = d.shape
    p = torch.empty_like(d)
    if B == 0:
        return p
    lib = _lib()
    _device.launch(lib, lib.follow_flows, d.device, "follow_flows",
                   _device.ptr(d), _device.ptr(p), B, Y, X, int(niter))
    _device.count_launch("follow_flows")
    return p
