"""The segmentation U-Net.

Frozen copy of the plain code of the port's ``models/unet.py``: ``depth`` down blocks
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
``dtype=torch.float64`` (with ``model.double()``) computes in float64
throughout: a reference where two float32 runs sum in different orders.

The JAX module's knobs: ``up_kind="convt"`` (the reference's stride-2
transposed conv), ``"subpixel"`` (the same map as one 2 x 2 conv to 4f
channels plus a depth-to-space interleave; ``variables_to_subpixel``
converts the weights) or ``"resize_conv"`` (nearest 2x resize + 3 x 3 conv,
not weight-compatible); ``row_split`` evaluates each 3 x 3 conv on row
slices with one-row halos stacked along the batch, exactly the unsplit conv.

Training. In training mode the BatchNorm normalises with the batch's biased
variance and updates its running statistics as Flax does (momentum 0.99,
biased variance; ``nn.BatchNorm2d`` would store the unbiased one).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["UNet", "DoubleConv"]

_NORMS = ("bn", "shift", "none")
_UP_KINDS = ("convt", "subpixel", "resize_conv")
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
          dtype: torch.dtype, transpose: bool = False,
          padding=None) -> torch.Tensor:
    """SAME 3x3 / 1x1 conv (or ``padding`` (rows, columns)), or the stride-2
    transposed conv, with operands in ``dtype`` and a float32 result
    including the bias (module docstring); float64 stays float64."""
    if dtype in (torch.float32, torch.float64) or x.device.type == "cuda":
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
            y = F.conv2d(x, w, padding=(weight.shape[-1] // 2 if padding is None
                                        else padding))
    # y is this call's own tensor (or a view of it): add the bias in place
    out = torch.float64 if dtype == torch.float64 else torch.float32
    return y.to(out).add_(bias[None, :, None, None])


def _auto_row_split(B: int, H: int) -> int:
    """The JAX package's row-split factor: the smallest S with B * S >= 8,
    S dividing H and at least 128 rows a slice, else 1 (1 from B >= 8)."""
    if B >= 8:
        return 1
    for S in range(-(-8 // B), H // 128 + 1):
        if H % S == 0 and H // S >= 128:
            return S
    return 1


def _row_split_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    dtype: torch.dtype, S: int) -> torch.Tensor:
    """The SAME 3x3 conv of NCHW ``x`` on S row slices, each with a one-row
    halo from its neighbours (zeros at the outer edges), stacked along the
    batch: the same sums as the unsplit conv."""
    B, C, H, W = x.shape
    h = H // S
    xs = x.reshape(B, C, S, h, W)
    zero = x.new_zeros(B, C, 1, 1, W)
    above = torch.cat([zero, xs[:, :, :-1, -1:]], dim=2)
    below = torch.cat([xs[:, :, 1:, :1], zero], dim=2)
    xh = torch.cat([above, xs, below], dim=3)          # (B, C, S, h + 2, W)
    xh = xh.permute(0, 2, 1, 3, 4).reshape(B * S, C, h + 2, W)
    y = _conv(xh, weight, bias, dtype, padding=(0, 1))
    F_ = y.shape[1]
    return y.reshape(B, S, F_, h, W).permute(0, 2, 1, 3, 4).reshape(B, F_, H, W)


def _batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Training-mode BatchNorm as Flax computes it: normalise with the
    batch mean and BIASED variance over (N, H, W), and move the running
    statistics by ``1 - momentum`` (0.01) towards them, the variance biased
    too."""
    mean = x.mean(dim=(0, 2, 3))
    var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * var)
        bn.num_batches_tracked.add_(1)
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
            + bn.bias[None, :, None, None])


class DoubleConv(nn.Module):
    """Conv3x3 -> ReLU -> norm, twice. ``norm="bn"`` is the reference's
    BatchNorm, ``"shift"`` a per-channel bias in its place (the inference
    form :func:`fold_batchnorm` produces), ``"none"`` nothing. ``row_split``
    is 1 (off), S > 1 or -1 (:func:`_auto_row_split` of each call's shape).
    Takes and returns NCHW tensors; the output is in ``dtype``."""

    def __init__(self, in_channels: int, filters: int,
                 dtype: torch.dtype = torch.float32, norm: str = "bn",
                 row_split: int = 1):
        super().__init__()
        if norm not in _NORMS:
            raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
        self.dtype, self.norm, self.row_split = dtype, norm, row_split
        for i, cin in enumerate((in_channels, filters)):
            setattr(self, f"conv{i}", nn.Conv2d(cin, filters, 3, padding=1))
            if norm == "bn":
                setattr(self, f"bn{i}", nn.BatchNorm2d(
                    filters, eps=_BN_EPS, momentum=_BN_MOMENTUM))
            elif norm == "shift":
                setattr(self, f"shift{i}", nn.Parameter(torch.zeros(filters)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        S = self.row_split
        if S == -1:
            S = _auto_row_split(x.shape[0], x.shape[2])
        for i in range(2):
            conv = getattr(self, f"conv{i}")
            if S > 1 and x.shape[2] % S == 0:
                y = _row_split_conv(x, conv.weight, conv.bias, self.dtype, S)
            else:
                y = _conv(x, conv.weight, conv.bias, self.dtype)
            x = torch.relu_(y)
            if self.norm == "bn":
                bn = getattr(self, f"bn{i}")
                x = _batch_norm_train(x, bn) if self.training else bn(x)
            elif self.norm == "shift":
                x = x + getattr(self, f"shift{i}")[None, :, None, None]
        return x.to(self.dtype)


class _SubpixelUp(nn.Module):
    """The stride-2 transposed conv as one 2 x 2 conv over the front-padded
    half-resolution input to 4f channels, channel (di * 2 + dj) * f + c
    holding output phase (di, dj) — the JAX package's channel order — then
    the depth-to-space interleave written out (``F.pixel_shuffle`` expects
    c * 4 + di * 2 + dj)."""

    def __init__(self, in_channels: int, filters: int):
        super().__init__()
        self.filters = filters
        self.packed = nn.Conv2d(in_channels, 4 * filters, 2)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, _, H, W = x.shape
        f = self.filters
        # padding ((1, 0), (1, 0)): one row and column in front
        y = _conv(F.pad(x, (1, 0, 1, 0)), self.packed.weight, self.packed.bias,
                  dtype, padding=0).to(dtype)
        y = y.reshape(B, 2, 2, f, H, W).permute(0, 3, 4, 1, 5, 2)
        return y.reshape(B, f, 2 * H, 2 * W)


class UNet(nn.Module):
    """U-Net with ``depth`` down blocks starting at ``base_filters``.

    ``forward`` takes ``(B, X, Y, in_channels)`` and returns the float32
    softmax ``(B, X, Y, num_classes)``; X and Y must be multiples of
    ``2 ** depth``. ``blocks`` holds the 2 * depth + 1 double convs in the
    order the JAX module creates them (down, bottleneck, up), ``ups`` the
    up-sampling layers (``up_kind``), ``head`` the 1x1 conv."""

    def __init__(self, depth: int = 3, base_filters: int = 128,
                 num_classes: int = 2, dropout_rate: float = 0.3,
                 dtype: torch.dtype = torch.float32, norm: str = "bn",
                 in_channels: int = 2, up_kind: str = "convt",
                 row_split: int = 1):
        super().__init__()
        if up_kind not in _UP_KINDS:
            raise ValueError(f"up_kind must be one of {_UP_KINDS}, got {up_kind!r}")
        self.depth, self.base_filters = depth, base_filters
        self.num_classes, self.dropout_rate = num_classes, dropout_rate
        self.dtype, self.norm, self.in_channels = dtype, norm, in_channels
        self.up_kind, self.row_split = up_kind, row_split
        filters = [base_filters * 2 ** i for i in range(depth)]
        blocks, cin = [], in_channels
        for f in filters:
            blocks.append(DoubleConv(cin, f, dtype, norm, row_split))
            cin = f
        blocks.append(DoubleConv(cin, 2 * cin, dtype, norm, row_split))
        cin, ups = 2 * cin, []
        for f in reversed(filters):
            if up_kind == "convt":
                ups.append(nn.ConvTranspose2d(cin, f, 3, stride=2))
            elif up_kind == "subpixel":
                ups.append(_SubpixelUp(cin, f))
            else:
                ups.append(nn.Conv2d(cin, f, 3, padding=1))
            blocks.append(DoubleConv(2 * f, f, dtype, norm, row_split))
            cin = f
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        self.head = nn.Conv2d(cin, num_classes, 1)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.dropout_rate, self.training)

    def _up(self, up: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.up_kind == "convt":
            return _conv(x, up.weight, up.bias, self.dtype,
                         transpose=True).to(self.dtype)
        if self.up_kind == "subpixel":
            return up(x, self.dtype)
        # nearest 2x resize (output pixel i reads input i // 2), then a SAME
        # 3 x 3 conv
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return _conv(x, up.weight, up.bias, self.dtype).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.logits(x), dim=1).permute(0, 2, 3, 1)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head's NCHW logits, before the softmax."""
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
            x = self._up(up, x)
            x = self._drop(torch.cat([x, skips.pop()], dim=1))
            x = self.blocks[self.depth + 1 + j](x)
        return _conv(x, self.head.weight, self.head.bias, self.dtype)
