"""The int8 inference path of the U-Net.

Port of ``tissue_image_processing_tpu/models/quant.py``, the same scheme
(post-training quantization of the folded-BatchNorm ``UNet(norm="shift")``):

- weights: symmetric per-output-channel int8, s_w[o] = max |w[o]| / 127;
- activations: symmetric per-tensor int8 with static scales, calibrated by
  one float32 forward that records each tensor's absolute maximum;
- activations stay int8 across block boundaries: each 3x3 conv dequantizes
  its int32 sums, adds bias, ReLU and shift, and requantizes for the next
  conv in one kernel (``ops/conv_s8_cuda.py:conv3x3_s8``); the down path's
  max-pool runs on int8 (it commutes with the monotone quantization); the
  skip concatenation is a split conv with each half's own scale;
- the transposed convs and the 1x1 head run in bfloat16 through the library
  on the dequantized int8 tensor (the product taken in bfloat16, as JAX
  does), as the JAX package leaves them to XLA.

Tensors are channels-last ``(B, X, Y, C)`` — the JAX layout — throughout;
the library convs see them as NCHW views in ``channels_last`` memory.

The int8 parameters are a flat dict of tensors (``utils/state.py:
quant_params_from_jax`` builds the same dict from the JAX package's tree):
``in_scale``; ``blocks.k.out_scale``; ``blocks.k.conv{i}.{wq, wscale, bias,
shift}`` and ``blocks.k.conv1.in_scale``; ``ups.j.{weight, bias,
out_scale}``; ``head.{weight, bias}``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

from tissue_image_processing_tpu_torch.models.unet import UNet, _conv
from tissue_image_processing_tpu_torch.ops.conv_s8_cuda import (
    conv3x3_s8, exact_div, packed_pair)

__all__ = ["quantize_unet", "unet_int8_apply", "unet_f32_apply", "Int8UNet"]


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 max-pool of a channels-last (B, H, W, C) tensor of any dtype
    (int8 included), by elementwise maxima of the four phases."""
    return torch.maximum(torch.maximum(x[:, 0::2, 0::2], x[:, 0::2, 1::2]),
                         torch.maximum(x[:, 1::2, 0::2], x[:, 1::2, 1::2]))


def _quant(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """round(clip(x * (127 / a), -127, 127)) as int8, half to even; a
    contiguous channels-last tensor, as the int8 conv takes it."""
    q = x * exact_div(127.0, a, x.device)
    return torch.round(torch.clamp(q, -127.0, 127.0)).to(torch.int8).contiguous()


def _dequant_bf16(xq: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """int8 -> bfloat16 times the bfloat16 scale / 127, the product rounded
    to bfloat16 as the JAX package takes it."""
    return xq.to(torch.bfloat16) * exact_div(xs, 127.0, xq.device).to(
        torch.bfloat16)


def _block(q: Mapping[str, torch.Tensor], k: int) -> Dict[str, torch.Tensor]:
    pre = f"blocks.{k}."
    return {key[len(pre):]: v for key, v in q.items() if key.startswith(pre)}


def _conv_args(d: Mapping, i: int):
    return (d[f"conv{i}.wq"], d[f"conv{i}.wscale"], d[f"conv{i}.bias"],
            d[f"conv{i}.shift"])


def _dc_int8(xq: torch.Tensor, xs: torch.Tensor, d: Mapping):
    """Int8 double conv over int8 ``xq`` (scale ``xs``); ``d`` is one block's
    parameters (keys ``conv0.wq`` ... ``out_scale``, and optionally the
    kernels' ``conv{i}.packed`` weights). Both requantizes are fused into
    the convs. Returns (int8 output, its scale)."""
    a1, out = d["conv1.in_scale"], d["out_scale"]
    y0 = conv3x3_s8(xq, *_conv_args(d, 0), xs, a1, packed=d.get("conv0.packed"))
    y1 = conv3x3_s8(y0, *_conv_args(d, 1), a1, out, packed=d.get("conv1.packed"))
    return y1, out


def _dc_int8_split(upq: torch.Tensor, ups: torch.Tensor, skq: torch.Tensor,
                   sks: torch.Tensor, d: Mapping):
    """Int8 double conv whose first conv consumes the (up, skip) concat as a
    split conv, each half with its own scale: the concat never exists."""
    a1, out = d["conv1.in_scale"], d["out_scale"]
    y0 = conv3x3_s8(upq, *_conv_args(d, 0), ups, a1, skip=skq, skip_scale=sks,
                    packed=d.get("conv0.packed"))
    y1 = conv3x3_s8(y0, *_conv_args(d, 1), a1, out, packed=d.get("conv1.packed"))
    return y1, out


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _forward_int8(q: Mapping[str, torch.Tensor], x: torch.Tensor,
                  depth: int, blocks=None) -> torch.Tensor:
    """The int8 forward of (B, X, Y, C) ``x`` -> float32 softmax (B, X, Y,
    2). ``blocks``: each double conv's parameters (:func:`_block`), with
    packed weights where the caller made them."""
    if blocks is None:
        blocks = [_block(q, k) for k in range(2 * depth + 1)]
    a_in = q["in_scale"]
    xq, xs = _quant(x.to(torch.float32), a_in), a_in
    skips = []
    for k in range(depth):
        sq, ss = _dc_int8(xq, xs, blocks[k])
        skips.append((sq, ss))
        # max pooling commutes with the monotone quantization: the pooled
        # tensor keeps the producing block's scale
        xq, xs = _pool2(sq).contiguous(), ss
    xq, xs = _dc_int8(xq, xs, blocks[depth])
    for j in range(depth):
        pre = f"ups.{j}."
        up = _conv(_nchw(_dequant_bf16(xq, xs)), q[pre + "weight"],
                   q[pre + "bias"], torch.bfloat16, transpose=True)
        upq = _quant(_nhwc(up), q[pre + "out_scale"])
        skq, sks = skips[depth - 1 - j]
        xq, xs = _dc_int8_split(upq, q[pre + "out_scale"], skq, sks,
                                blocks[depth + 1 + j])
    y = _conv(_nchw(_dequant_bf16(xq, xs)), q["head.weight"], q["head.bias"],
              torch.bfloat16)
    return _nhwc(torch.softmax(y, dim=1))


def _state_of(model_or_state: Union[UNet, Mapping]) -> Mapping:
    if isinstance(model_or_state, UNet):
        if model_or_state.norm != "shift" or model_or_state.up_kind != "convt":
            raise ValueError("the int8 path needs UNet(norm='shift', "
                             "up_kind='convt'): fold the BatchNorm first")
        return model_or_state.state_dict()
    return model_or_state


def _forward(state: Mapping[str, torch.Tensor], x: torch.Tensor, depth: int,
             record: Optional[dict] = None) -> torch.Tensor:
    """``UNet(norm="shift", up_kind="convt")`` float32 inference wiring over
    its ``state_dict`` — the calibration twin of the int8 forward. ``record``
    collects the absolute maxima the quantizer needs: each conv's input
    (``blocks.k.conv{i}``), each double conv's output (``blocks.k.out``),
    each transposed conv's output (``ups.j.out``) and the input (``in``)."""
    f32 = torch.float32

    def rec(name, t):
        if record is not None:
            record[name] = t.abs().amax()

    def dc(x, k):
        pre = f"blocks.{k}."
        for i in range(2):
            rec(f"{pre}conv{i}", x)
            y = _conv(x, state[f"{pre}conv{i}.weight"],
                      state[f"{pre}conv{i}.bias"], f32)
            x = torch.relu(y) + state[f"{pre}shift{i}"][None, :, None, None]
        rec(f"{pre}out", x)
        return x

    x = _nchw(x.to(f32))
    rec("in", x)
    skips = []
    for k in range(depth):
        skips.append(dc(x, k))
        x = torch.nn.functional.max_pool2d(skips[-1], 2)
    x = dc(x, depth)
    for j in range(depth):
        up = _conv(x, state[f"ups.{j}.weight"], state[f"ups.{j}.bias"], f32,
                   transpose=True)
        rec(f"ups.{j}.out", up)
        x = dc(torch.cat([up, skips[depth - 1 - j]], dim=1), depth + 1 + j)
    y = _conv(x, state["head.weight"], state["head.bias"], f32)
    return _nhwc(torch.softmax(y, dim=1))


def unet_f32_apply(model_or_state: Union[UNet, Mapping], x: torch.Tensor,
                   depth: int = 3, record: Optional[dict] = None
                   ) -> torch.Tensor:
    """float32 forward of the folded ``UNet(norm="shift")`` (model or
    ``state_dict``) on (B, X, Y, C) ``x``: the calibration / parity twin of
    :func:`unet_int8_apply`, the same wiring as ``UNet.forward``."""
    with torch.no_grad():
        return _forward(_state_of(model_or_state), x, depth, record)


def quantize_unet(model_or_state: Union[UNet, Mapping], sample: torch.Tensor,
                  depth: int = 3, headroom: float = 1.02
                  ) -> Dict[str, torch.Tensor]:
    """Post-training quantization of the folded ``UNet(norm="shift")``.

    ``sample``: a representative (B, X, Y, 2) input batch; one float32
    forward records the per-tensor absolute maxima, scaled by ``headroom``
    (the 2% absorbs the int8 path's own noise on tensors calibrated on the
    float twin). Returns the int8 parameters (module docstring) on the
    state's device. Of the input scales only Conv_1's is kept: Conv_0's
    input arrives int8 with its producer's scale."""
    state = _state_of(model_or_state)
    record: dict = {}
    unet_f32_apply(state, sample, depth, record)
    rec = {k: torch.clamp_min(v * headroom, 1e-8) for k, v in record.items()}
    out = {"in_scale": rec["in"]}
    for k in range(2 * depth + 1):
        pre = f"blocks.{k}."
        out[pre + "out_scale"] = rec[pre + "out"]
        for i in range(2):
            w = state[f"{pre}conv{i}.weight"].detach().to(torch.float32)
            s_w = exact_div(torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12),
                            127.0)
            out[f"{pre}conv{i}.wq"] = torch.round(
                w / s_w[:, None, None, None]).to(torch.int8)
            out[f"{pre}conv{i}.wscale"] = s_w
            out[f"{pre}conv{i}.bias"] = state[f"{pre}conv{i}.bias"].detach()
            out[f"{pre}conv{i}.shift"] = state[f"{pre}shift{i}"].detach()
        out[pre + "conv1.in_scale"] = rec[pre + "conv1"]
    for j in range(depth):
        for name in ("weight", "bias"):
            out[f"ups.{j}.{name}"] = state[f"ups.{j}.{name}"].detach()
        out[f"ups.{j}.out_scale"] = rec[f"ups.{j}.out"]
    out["head.weight"] = state["head.weight"].detach()
    out["head.bias"] = state["head.bias"].detach()
    return out


class Int8UNet:
    """The int8 forward with its parameters on ``device`` once: on the card
    each 3x3 conv's weights are packed for the kernel here, not per call.
    ``model(x)`` takes (B, X, Y, C) and returns the float32 softmax."""

    def __init__(self, qparams: Mapping[str, torch.Tensor], depth: int = 3,
                 device=None):
        device = torch.device(device if device is not None
                              else qparams["in_scale"].device)
        self.depth = depth
        self.q = {k: v.to(device) for k, v in qparams.items()}
        self.blocks = [_block(self.q, k) for k in range(2 * depth + 1)]
        if device.type == "cuda":
            for k, d in enumerate(self.blocks):
                # the up path's first conv is split at the up half's width
                split = (d["conv0.wq"].shape[1] // 2 if k > depth else None)
                d["conv0.packed"] = packed_pair(d["conv0.wq"], split)
                d["conv1.packed"] = packed_pair(d["conv1.wq"])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _forward_int8(self.q, x, self.depth, self.blocks)


def unet_int8_apply(qparams: Mapping[str, torch.Tensor], x: torch.Tensor,
                    depth: int = 3) -> torch.Tensor:
    """int8 inference forward of (B, X, Y, C) ``x`` -> float32 softmax (B,
    X, Y, 2), on ``x``'s device; within quantization noise of the float
    forward (mean |dP| ~1e-3 on calibrated data)."""
    with torch.no_grad():
        return Int8UNet(qparams, depth, x.device)(x)
