"""The segmentation U-Net.

Port of ``tissue_image_processing_tpu/models/unet.py``: ``depth`` down blocks
starting at ``base_filters`` (the reference architecture: 128 / 256 / 512 and
a 1024 bottleneck), each block Conv3x3 -> ReLU -> BatchNorm twice (the Keras
order: activation before the norm), 2x2 max-pool and dropout on the way down,
stride-2 transposed conv + skip concat + dropout + double conv on the way up,
and a 1x1 conv softmax over two classes (HC and SC probability).

The convolutions are library calls (``F.conv2d`` / ``F.conv_transpose2d``),
as the JAX package leaves them to XLA outside any kernel.

Layout. Public tensors keep the JAX shapes: ``(B, X, Y, C)`` in and
``(B, X, Y, num_classes)`` out. Inside, the tensor is viewed as NCHW with
H = X and W = Y; a contiguous channel-last input therefore is in PyTorch's
``channels_last`` memory format already, and every activation stays in it.

Precision. With ``dtype=torch.bfloat16`` the JAX package feeds the convs
bfloat16 operands, accumulates in float32, keeps bias, ReLU and the norm in
float32 and rounds to bfloat16 once per block. Here:

- on the card ``F.conv2d`` takes bfloat16 operands and returns bfloat16 (the
  tensor cores accumulate in float32, the result is rounded): one rounding
  earlier than JAX, per conv. Bias, ReLU, the norm or shift, and the softmax
  then run in float32 and the block output is rounded to bfloat16;
- on the CPU the operands are rounded to bfloat16 and convolved in float32,
  which is the JAX arithmetic up to the order of summation.

With ``dtype=torch.float32`` the convs run in full float32 on both; on the
card TF32 is switched off around them, so card and CPU can be compared.

The ablation knobs ``up_kind`` and ``row_split`` of the JAX module are not
ported.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["UNet", "DoubleConv", "build_unet", "fold_batchnorm"]

_NORMS = ("bn", "shift", "none")
# running-stats BatchNorm of the reference: epsilon 1e-3, Keras momentum 0.99
_BN_EPS = 1e-3
_BN_MOMENTUM = 0.01


@contextlib.contextmanager
def _full_float32_convs(device: torch.device):
    """cuDNN float32 convolutions default to TF32 (about three decimal
    digits); switch that off for the block on the card."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype, transpose: bool = False) -> torch.Tensor:
    """SAME 3x3 / 1x1 conv, or the stride-2 transposed conv, with operands in
    ``dtype`` and a float32 result including the bias (module docstring)."""
    if dtype == torch.float32:
        x, w = x.to(torch.float32), weight
    elif x.device.type == "cuda":
        x, w = x.to(dtype), weight.to(dtype)
    else:
        x, w = x.to(dtype).to(torch.float32), weight.to(dtype).to(torch.float32)
    with _full_float32_convs(x.device):
        if transpose:
            # tap k of the JAX kernel lands at output 2i + 2 - k; the weight
            # is stored spatially flipped, so here tap k' = 2 - k lands at
            # 2i + k' (padding 0) and the output is the first 2H x 2W of the
            # 2H + 1 rows and columns
            H, W = x.shape[-2:]
            y = F.conv_transpose2d(x, w, stride=2)[..., :2 * H, :2 * W]
        else:
            y = F.conv2d(x, w, padding=weight.shape[-1] // 2)
    # y is this call's own tensor (or a view of it): add the bias in place
    return y.to(torch.float32).add_(bias[None, :, None, None])


class DoubleConv(nn.Module):
    """Conv3x3 -> ReLU -> norm, twice. ``norm="bn"`` is the reference's
    BatchNorm, ``"shift"`` a per-channel bias in its place (the inference
    form :func:`fold_batchnorm` produces), ``"none"`` nothing. Takes and
    returns NCHW tensors; the output is in ``dtype``."""

    def __init__(self, in_channels: int, filters: int,
                 dtype: torch.dtype = torch.float32, norm: str = "bn"):
        super().__init__()
        if norm not in _NORMS:
            raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
        self.dtype, self.norm = dtype, norm
        for i, cin in enumerate((in_channels, filters)):
            setattr(self, f"conv{i}", nn.Conv2d(cin, filters, 3, padding=1))
            if norm == "bn":
                setattr(self, f"bn{i}", nn.BatchNorm2d(
                    filters, eps=_BN_EPS, momentum=_BN_MOMENTUM))
            elif norm == "shift":
                setattr(self, f"shift{i}", nn.Parameter(torch.zeros(filters)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            conv = getattr(self, f"conv{i}")
            x = torch.relu_(_conv(x, conv.weight, conv.bias, self.dtype))
            if self.norm == "bn":
                x = getattr(self, f"bn{i}")(x)
            elif self.norm == "shift":
                x = x + getattr(self, f"shift{i}")[None, :, None, None]
        return x.to(self.dtype)


class UNet(nn.Module):
    """U-Net with ``depth`` down blocks starting at ``base_filters``.

    ``forward`` takes ``(B, X, Y, in_channels)`` and returns the float32
    softmax ``(B, X, Y, num_classes)``; X and Y must be multiples of
    ``2 ** depth``. ``blocks`` holds the 2 * depth + 1 double convs in the
    order the JAX module creates them (down, bottleneck, up), ``ups`` the
    transposed convs, ``head`` the 1x1 conv."""

    def __init__(self, depth: int = 3, base_filters: int = 128,
                 num_classes: int = 2, dropout_rate: float = 0.3,
                 dtype: torch.dtype = torch.float32, norm: str = "bn",
                 in_channels: int = 2):
        super().__init__()
        self.depth, self.base_filters = depth, base_filters
        self.num_classes, self.dropout_rate = num_classes, dropout_rate
        self.dtype, self.norm, self.in_channels = dtype, norm, in_channels
        filters = [base_filters * 2 ** i for i in range(depth)]
        blocks, cin = [], in_channels
        for f in filters:
            blocks.append(DoubleConv(cin, f, dtype, norm))
            cin = f
        blocks.append(DoubleConv(cin, 2 * cin, dtype, norm))
        cin, ups = 2 * cin, []
        for f in reversed(filters):
            ups.append(nn.ConvTranspose2d(cin, f, 3, stride=2))
            blocks.append(DoubleConv(2 * f, f, dtype, norm))
            cin = f
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        self.head = nn.Conv2d(cin, num_classes, 1)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.dropout_rate, self.training)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != self.in_channels:
            raise ValueError(f"UNet takes (B, X, Y, {self.in_channels}), "
                             f"got {tuple(x.shape)}")
        if x.shape[1] % 2 ** self.depth or x.shape[2] % 2 ** self.depth:
            raise ValueError(f"UNet needs X and Y divisible by "
                             f"{2 ** self.depth}, got {tuple(x.shape)}")
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for block in self.blocks[:self.depth]:
            skip = block(x)
            skips.append(skip)
            x = self._drop(F.max_pool2d(skip, 2))
        x = self.blocks[self.depth](x)
        for j, up in enumerate(self.ups):
            x = _conv(x, up.weight, up.bias, self.dtype,
                      transpose=True).to(self.dtype)
            x = self._drop(torch.cat([x, skips.pop()], dim=1))
            x = self.blocks[self.depth + 1 + j](x)
        logits = _conv(x, self.head.weight, self.head.bias, self.dtype)
        return torch.softmax(logits, dim=1).permute(0, 2, 3, 1)


def _variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                       generator: Optional[torch.Generator]) -> None:
    """Truncated normal (+-2 sigma) of variance ``scale / fan_in``, the
    he-normal (scale 2) and lecun-normal (scale 1) initialisers, drawn by
    inverse CDF from ``generator``."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    lo, hi = 0.022750131948179195, 0.9772498680518208  # Phi(-2), Phi(2)
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    with torch.no_grad():
        w.copy_((z * std).to(w.dtype))


def build_unet(input_shape: Tuple[int, int, int], depth: int = 3,
               base_filters: int = 128, dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None) -> UNet:
    """A freshly initialised U-Net for ``input_shape = (X, Y, C)``:
    he-normal 3x3 convs, lecun-normal transposed convs and head, zero
    biases, identity BatchNorm — all drawn from ``generator`` (a CPU
    ``torch.Generator``; None uses the global one)."""
    model = UNet(depth=depth, base_filters=base_filters, dtype=dtype,
                 in_channels=input_shape[-1])
    for block in model.blocks:
        for conv in (block.conv0, block.conv1):
            _variance_scaling_(conv.weight, 2.0,
                               conv.in_channels * 9, generator)
            nn.init.zeros_(conv.bias)
    for conv in (*model.ups, model.head):
        k = conv.kernel_size[0] * conv.kernel_size[1]
        _variance_scaling_(conv.weight, 1.0, conv.in_channels * k, generator)
        nn.init.zeros_(conv.bias)
    return model


def fold_batchnorm(model: UNet) -> Optional[UNet]:
    """Inference-only transform: fold each post-ReLU BatchNorm's scale into
    its own conv and return the ``norm="shift"`` model.

    With a per-channel a > 0, BN(relu(y)) = a * relu(y) + b = relu(a * y) + b:
    the scale moves back through the ReLU into the conv's output channels
    (which zero padding cannot disturb) and only the shift b stays at the
    norm's place. Returns None if the model has no BatchNorm or any a <= 0
    (the ReLU commute needs a > 0), so callers keep the BatchNorm model."""
    if model.norm != "bn":
        return None
    dev = model.head.weight.device
    folded = UNet(model.depth, model.base_filters, model.num_classes,
                  model.dropout_rate, model.dtype, "shift",
                  model.in_channels).to(dev)
    with torch.no_grad():
        for src, dst in zip(model.blocks, folded.blocks):
            for i in range(2):
                bn, conv = getattr(src, f"bn{i}"), getattr(src, f"conv{i}")
                a = bn.weight / torch.sqrt(bn.running_var + bn.eps)
                if bool((a <= 0).any()):
                    return None
                out = getattr(dst, f"conv{i}")
                out.weight.copy_(conv.weight * a[:, None, None, None])
                out.bias.copy_(conv.bias * a)
                getattr(dst, f"shift{i}").copy_(bn.bias - bn.running_mean * a)
        folded.ups.load_state_dict(model.ups.state_dict())
        folded.head.load_state_dict(model.head.state_dict())
    return folded.train(model.training)
