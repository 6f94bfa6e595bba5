"""Int8 3x3 SAME convolution with the int8 U-Net's fused epilogue: CUDA
kernel wrapper and plain version.

The JAX package's int8 U-Net (``models/quant.py``) runs each 3x3 conv as an
XLA int8 convolution with int32 sums (``_conv_s8``), then dequantizes, adds
the bias, applies the ReLU and the folded-BatchNorm shift in float32 and
requantizes to int8 with the next tensor's scale. ``conv3x3_s8`` does all of
that in one kernel (``csrc/conv_s8.cu``) on int8 channels-last tensors, in a
single form and a split form over an (up, skip) pair with one accumulator
each, so the concatenation never exists.

``conv3x3_s8_plain`` is the same function in PyTorch: the int32 sums by nine
float64 tap products (exact: every partial sum is an integer below 2^53),
then the epilogue as separate float32 operations in the JAX order. CPU
tensors take it; a CUDA tensor launches the kernel or raises.

Scales are float32 tensors on the tensors' device; the epilogue's scalars
(scale / 127, 127 / scale) are divided there by :func:`exact_div` — PyTorch's
CUDA division by a host scalar multiplies by its reciprocal, which can miss
the correctly rounded quotient by one bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tissue_image_processing_tpu_torch import _device

__all__ = ["conv3x3_s8", "conv3x3_s8_plain", "conv3x3_s8_acc_plain",
           "pack_conv_s8_weight", "packed_pair", "exact_div"]

BLOCK_N, BLOCK_K = 128, 32   # the kernel's output-channel tile and K chunk
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"conv3x3_s8": (_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _P, _P, _P, _P, _P, _P, _P, _P)}


def exact_div(a, b, device=None) -> torch.Tensor:
    """``a / b`` in float32, correctly rounded on every device: both operands
    become float32 tensors on ``device`` (default: that of whichever operand
    is a tensor) before the division."""
    if device is None:
        device = (a if isinstance(a, torch.Tensor) else b).device

    def on_device(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32)
        # filled on the device: no host copy (a CUDA graph may be capturing)
        return torch.full((), float(v), dtype=torch.float32, device=device)

    a, b = torch.broadcast_tensors(on_device(a), on_device(b))
    return torch.div(a, b.contiguous())


def _epilogue_scalars(device, x_scale, out_scale, skip_scale=None):
    s0 = exact_div(x_scale, 127.0, device)
    s1 = None if skip_scale is None else exact_div(skip_scale, 127.0, device)
    return s0, s1, exact_div(127.0, out_scale, device)


def pack_conv_s8_weight(wq: torch.Tensor) -> torch.Tensor:
    """``(Cout, Cin, 3, 3)`` int8 weights -> the kernel's ``(Np, Kp)`` int8
    operand: row n holds output channel n's K = 9 * Cin weights at k = (dy *
    3 + dx) * Cin + c, zero-padded to Kp (a multiple of 32) and Np (of 128)."""
    cout, cin = wq.shape[:2]
    K = 9 * cin
    kp = -(-K // BLOCK_K) * BLOCK_K
    np_ = -(-cout // BLOCK_N) * BLOCK_N
    out = torch.zeros(np_, kp, dtype=torch.int8, device=wq.device)
    out[:cout, :K] = wq.permute(0, 2, 3, 1).reshape(cout, K)
    return out


def conv3x3_s8_acc_plain(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int32 sums of the SAME 3x3 conv of int8 channels-last ``x`` (B,
    H, W, Cin) with int8 ``wq`` (Cout, Cin, 3, 3), as exact float64 (B, H, W,
    Cout): nine tap products, each exact."""
    B, H, W, _ = x.shape
    xp = F.pad(x.to(torch.float64), (0, 0, 1, 1, 1, 1))
    w = wq.to(torch.float64)
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = xp[:, dy:dy + H, dx:dx + W, :] @ w[:, :, dy, dx].T
            acc = term if acc is None else acc.add_(term)
    return acc


def _check_inputs(x, wq, skip, wscale, bias, shift):
    """Shapes, and contiguous inputs on every device: the kernel needs them,
    so the CPU route refuses what the card would."""
    if x.dim() != 4 or wq.dim() != 4 or tuple(wq.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3_s8: expected x (B, H, W, C) and wq (Cout, "
                         f"Cin, 3, 3), got {tuple(x.shape)}, {tuple(wq.shape)}")
    if not x.is_contiguous() or (skip is not None and not skip.is_contiguous()):
        raise ValueError("conv3x3_s8: inputs must be contiguous (B, H, W, C)")
    cin = x.shape[-1] + (0 if skip is None else skip.shape[-1])
    if wq.shape[1] != cin:
        raise ValueError(f"conv3x3_s8: wq has {wq.shape[1]} input channels, "
                         f"the input(s) {cin}")
    if skip is not None and skip.shape[:3] != x.shape[:3]:
        raise ValueError(f"conv3x3_s8: skip {tuple(skip.shape)} does not "
                         f"match {tuple(x.shape)}")
    for name, t in (("wscale", wscale), ("bias", bias), ("shift", shift)):
        if tuple(t.shape) != (wq.shape[0],):
            raise ValueError(f"conv3x3_s8: {name} must be ({wq.shape[0]},), "
                             f"got {tuple(t.shape)}")


def conv3x3_s8_plain(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                     bias: torch.Tensor, shift: torch.Tensor, x_scale,
                     out_scale, skip: Optional[torch.Tensor] = None,
                     skip_scale=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3x3_s8` (any device)."""
    _check_inputs(x, wq, skip, wscale, bias, shift)
    s0, s1, qmul = _epilogue_scalars(x.device, x_scale, out_scale,
                                     skip_scale)
    cu = x.shape[-1]
    acc = conv3x3_s8_acc_plain(x, wq[:, :cu]).to(torch.float32)
    if skip is None:
        y = acc * (wscale * s0) + bias
    else:
        acc_s = conv3x3_s8_acc_plain(skip, wq[:, cu:]).to(torch.float32)
        y = (acc * s0 + acc_s * s1) * wscale + bias
    y = torch.clamp_min(y, 0.0) + shift
    return torch.round(torch.clamp(y * qmul, -127.0, 127.0)).to(torch.int8)


def conv3x3_s8(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
               bias: torch.Tensor, shift: torch.Tensor, x_scale, out_scale,
               skip: Optional[torch.Tensor] = None, skip_scale=None,
               packed: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """int8 SAME 3x3 conv of channels-last ``x`` (B, H, W, Cin) with
    per-output-channel int8 weights ``wq`` (Cout, Cin, 3, 3), then
    dequantize (``x_scale`` / 127 times ``wscale``), + ``bias``, ReLU,
    + ``shift``, requantize with ``out_scale``: (B, H, W, Cout) int8.

    With ``skip`` the input is the channel concat ``[x, skip]`` done as a
    split conv: ``wq[:, :Cx]`` on x and ``wq[:, Cx:]`` on skip, each sum
    scaled by its own scale before ``wscale``. ``packed``: the weights
    already in the kernel's form (:func:`pack_conv_s8_weight` of each half).

    CPU tensors run :func:`conv3x3_s8_plain`; CUDA tensors launch the kernel
    or raise."""
    if x.device.type == "cpu":
        return conv3x3_s8_plain(x, wq, wscale, bias, shift, x_scale, out_scale,
                                skip, skip_scale)
    _check_inputs(x, wq, skip, wscale, bias, shift)
    inputs = (x,) if skip is None else (x, skip)
    for t in inputs:
        _device.require_cuda_tensor(t, torch.int8, 4, "conv3x3_s8")
        if t.data_ptr() % 16:
            raise ValueError("conv3x3_s8: inputs must be 16-byte aligned")
    for t in (wscale, bias, shift):
        _device.require_cuda_tensor(t, torch.float32, 1, "conv3x3_s8")
    cu = x.shape[-1]
    if packed is None:
        packed = packed_pair(wq, None if skip is None else cu)
    for p in packed:
        _device.require_cuda_tensor(p, torch.int8, 2, "conv3x3_s8 packed")
    s0, s1, qmul = _epilogue_scalars(x.device, x_scale, out_scale,
                                     skip_scale)
    lib = _device.load_library("conv_s8", _SIGNATURES)
    B, H, W = x.shape[:3]
    cout = wq.shape[0]
    out = torch.empty(B, H, W, cout, dtype=torch.int8, device=x.device)
    p0 = packed[0]
    if skip is None:
        x1 = w1 = None
        c1 = k1 = 0
    else:
        x1, w1, c1, k1 = _device.ptr(skip), _device.ptr(packed[1]), \
            skip.shape[-1], packed[1].shape[1]
    rc = lib.conv3x3_s8(_device.ptr(x), _device.ptr(p0), cu, p0.shape[1], x1, w1,
                        c1, k1, B, H, W, cout, p0.shape[0], _device.ptr(wscale),
                        _device.ptr(bias), _device.ptr(shift), _device.ptr(s0),
                        _device.ptr(s0 if s1 is None else s1), _device.ptr(qmul),
                        _device.ptr(out), _device.stream_ptr())
    _device.check_cuda(lib, rc, "conv3x3_s8")
    _device.LAUNCHES["conv3x3_s8"] += 1
    return out


def packed_pair(wq: torch.Tensor, cin_first: Optional[int] = None
                ) -> Tuple[torch.Tensor, ...]:
    """The ``packed`` argument of :func:`conv3x3_s8` for ``wq``: one packed
    operand, or two when ``cin_first`` splits the input channels."""
    if cin_first is None:
        return (pack_conv_s8_weight(wq),)
    return (pack_conv_s8_weight(wq[:, :cin_first]),
            pack_conv_s8_weight(wq[:, cin_first:]))
