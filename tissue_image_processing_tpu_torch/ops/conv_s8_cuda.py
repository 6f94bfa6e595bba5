"""Int8 3x3 SAME convolution with the int8 U-Net's fused epilogue: CUDA
kernel wrapper and plain version.

The JAX package's int8 U-Net (``models/quant.py``) runs each 3x3 conv as an
XLA int8 convolution with int32 sums (``_conv_s8``), then dequantizes, adds
the bias, applies the ReLU and the folded-BatchNorm shift in float32 and
requantizes to int8 with the next tensor's scale. ``conv3x3_s8`` does all of
that in one kernel (``csrc/conv_s8.cu``) on int8 channels-last tensors, in a
single form and a split form over an (up, skip) pair with one accumulator
each, so the concatenation never exists.

The kernel has three forms, picked by shape in :func:`conv_s8_form`: the
tensor-core form (TMA-staged tiles, warp-specialised ``wgmma``; every input
with Cin a multiple of 64), the first-conv form (Cin <= 7) and the generic
form (``mma.sync``; every other shape). ``_device.CONV_LAUNCHES`` counts
launches by form beside the total in ``_device.LAUNCHES["conv3x3_s8"]``.

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
           "conv_s8_form", "pack_conv_s8_weight", "packed_pair", "exact_div"]

BLOCK_N, BLOCK_K = 128, 32   # the packed weights' row and K granules
FORMS = ("generic", "tensor_core", "first_conv")   # the C entry's form codes
TC_COLS = 64   # tensor-core form: pixels of one image row in a tile row
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"conv3x3_s8": (_I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                              _P, _P, _P)}


def conv_s8_form(cin: int, skip_cin: int, cout: int) -> str:
    """The kernel form for a conv of ``cin`` (+ ``skip_cin``, 0 for a single
    conv) input channels and ``cout`` output channels: ``"tensor_core"`` when
    every input's channels are a multiple of 64 (its TMA boxes take 128
    channels of one tap), ``"first_conv"`` for a single input of at most 7
    channels (one or two K steps of 32) and Cout a multiple of 64 up to 256,
    else ``"generic"``."""
    if cin > 0 and cin % 64 == 0 and skip_cin % 64 == 0:
        return "tensor_core"
    if skip_cin == 0 and 0 < cin <= 7 and cout % 64 == 0 and cout <= 256:
        return "first_conv"
    return "generic"


def _tc_tiles(H: int, W: int, cout: int, split: bool) -> dict:
    """The tensor-core form's tile for a conv and its tile counts: ``mw``
    image rows of 64 pixels per consumer warpgroup (two warpgroups), ``bn``
    output channels. A split conv keeps two accumulator sets, so 128
    channels; a single one 256 when Cout exceeds 128, else 128 channels and
    two rows a warpgroup."""
    mw, bn = (1, 128) if split else (1, 256) if cout > 128 else (2, 128)
    return dict(mw=mw, bn=bn, tiles_w=-(-W // TC_COLS),
                tiles_h=-(-H // (2 * mw)), tiles_n=-(-cout // bn))


def _tc_units(B: int, tiles: dict) -> int:
    """Output tiles of the persistent kernel; block i computes tiles i, i +
    blocks, i + 2 * blocks, ..."""
    return tiles["tiles_n"] * B * tiles["tiles_h"] * tiles["tiles_w"]


def _tc_tile_origin(unit: int, tiles: dict):
    """(frame, first row, first column, first channel) of output tile
    ``unit`` — the kernel's ``tc_tile``: N tile fastest, then the column
    block, the row block and the frame."""
    nt = unit % tiles["tiles_n"]
    m = unit // tiles["tiles_n"]
    hw = tiles["tiles_h"] * tiles["tiles_w"]
    b, r = divmod(m, hw)
    ht, wt = divmod(r, tiles["tiles_w"])
    return b, ht * 2 * tiles["mw"], wt * TC_COLS, nt * tiles["bn"]


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
    form that :func:`conv_s8_form` picks for the shape, or raise."""
    if x.device.type == "cpu":
        return conv3x3_s8_plain(x, wq, wscale, bias, shift, x_scale, out_scale,
                                skip, skip_scale)
    form = conv_s8_form(x.shape[-1], 0 if skip is None else skip.shape[-1],
                        wq.shape[0])
    return _conv3x3_s8(x, wq, wscale, bias, shift, x_scale, out_scale, skip,
                       skip_scale, packed, form)


def _conv3x3_s8(x, wq, wscale, bias, shift, x_scale, out_scale, skip=None,
                skip_scale=None, packed=None, form: str = "generic"
                ) -> torch.Tensor:
    """:func:`conv3x3_s8` on CUDA tensors through the kernel of ``form``:
    the form :func:`conv_s8_form` picks, or ``"generic"``, which takes every
    shape (``chip_smoke.py`` times it beside the picked form)."""
    _check_inputs(x, wq, skip, wscale, bias, shift)
    cu, cs, cout = x.shape[-1], 0 if skip is None else skip.shape[-1], \
        wq.shape[0]
    if form not in ("generic", conv_s8_form(cu, cs, cout)):
        raise ValueError(f"conv3x3_s8: the {form} form does not take "
                         f"{cu}+{cs} -> {cout} channels")
    inputs = (x,) if skip is None else (x, skip)
    for t in inputs:
        _device.require_cuda_tensor(t, torch.int8, 4, "conv3x3_s8")
        if t.data_ptr() % 16:
            raise ValueError("conv3x3_s8: inputs must be 16-byte aligned")
    for t in (wscale, bias, shift):
        _device.require_cuda_tensor(t, torch.float32, 1, "conv3x3_s8")
    # the first-conv kernel reads two channels' parameters in one 8-byte load
    wscale, bias, shift = (t if t.data_ptr() % 8 == 0 else t.clone()
                           for t in (wscale, bias, shift))
    if packed is None:
        packed = packed_pair(wq, None if skip is None else cu)
    for p in packed:
        _device.require_cuda_tensor(p, torch.int8, 2, "conv3x3_s8 packed")
    s0, s1, qmul = _epilogue_scalars(x.device, x_scale, out_scale,
                                     skip_scale)
    lib = _device.load_library("conv_s8", _SIGNATURES)
    B, H, W = x.shape[:3]
    out = torch.empty(B, H, W, cout, dtype=torch.int8, device=x.device)
    p0 = packed[0]
    if skip is None:
        x1 = w1 = None
        k1 = 0
    else:
        x1, w1, k1 = _device.ptr(skip), _device.ptr(packed[1]), \
            packed[1].shape[1]
    tiles = _tc_tiles(H, W, cout, skip is not None) \
        if form == "tensor_core" else dict(mw=0, bn=0, tiles_w=0, tiles_h=0,
                                           tiles_n=0)
    _device.launch(lib, lib.conv3x3_s8, x.device, f"conv3x3_s8 ({form})",
                   FORMS.index(form), _device.ptr(x), _device.ptr(p0), cu,
                   p0.shape[1], x1, w1, cs, k1, B, H, W, cout, p0.shape[0],
                   tiles["mw"], tiles["bn"], tiles["tiles_w"],
                   tiles["tiles_h"], tiles["tiles_n"], _device.ptr(wscale),
                   _device.ptr(bias), _device.ptr(shift), _device.ptr(s0),
                   _device.ptr(s0 if s1 is None else s1), _device.ptr(qmul),
                   _device.ptr(out))
    _device.count_launch("conv3x3_s8", 1, (_device.CONV_LAUNCHES, form))
    return out


def packed_pair(wq: torch.Tensor, cin_first: Optional[int] = None
                ) -> Tuple[torch.Tensor, ...]:
    """The ``packed`` argument of :func:`conv3x3_s8` for ``wq``: one packed
    operand, or two when ``cin_first`` splits the input channels."""
    if cin_first is None:
        return (pack_conv_s8_weight(wq),)
    return (pack_conv_s8_weight(wq[:, :cin_first]),
            pack_conv_s8_weight(wq[:, cin_first:]))
