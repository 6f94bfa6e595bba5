"""Seeded random U-Net weights, made by the benchmark on the card.

The state dictionary has the keys of the port's ``UNet(norm="bn")`` (the
reference's inference network with its BatchNorm, before any folding). It
is drawn from one ``torch.Generator`` on the device in three calls: one
uniform draw turned into truncated normals (+-2 sigma) for every conv
weight, he-normal for the 3 x 3 convs and lecun-normal for the transposed
convs and the head, as the port initialises them; one uniform draw for every
BatchNorm scale, bias and running statistic, away from the identity (scales
and variances in [0.5, 1.5], so the program can fold them); biases zero.
``head_bias_for_share`` then moves the head's channel-0 bias so that a
chosen share of a frame passes the post-process's 0.1 threshold: with random
weights the softmax would otherwise pass everywhere or nowhere and the
flood would be trivial.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from benchmark.reference.unet import UNet

__all__ = ["unet_state", "head_bias_for_share"]

_PHI_M2, _PHI_P2 = 0.022750131948179195, 0.9772498680518208  # Phi(-2), Phi(2)
_TRUNC_STD = 0.87962566103423978  # std of the unit normal cut at +-2
_BN_RANGES = {"weight": (0.5, 1.5), "bias": (-0.2, 0.2),
              "running_mean": (0.0, 0.5), "running_var": (0.5, 1.5)}


def unet_state(unet: Mapping, seed: int, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """float32 weights of the U-Net ``unet`` (depth, base_filters,
    in_channels) drawn from ``seed`` on ``device``."""
    with torch.device("meta"):
        shapes = UNet(depth=unet["depth"], base_filters=unet["base_filters"],
                      norm="bn", in_channels=unet["in_channels"]).state_dict()
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    convs = {k: v.shape for k, v in shapes.items()
             if k.endswith(".weight") and len(v.shape) == 4}
    bns = {k: v.shape for k, v in shapes.items()
           if k.rsplit(".", 1)[1] in _BN_RANGES and ".bn" in k}
    n_conv = sum(math.prod(s) for s in convs.values())
    n_bn = sum(math.prod(s) for s in bns.values())
    u = torch.rand(n_conv, generator=g, device=device, dtype=torch.float32)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (_PHI_M2 + (_PHI_P2 - _PHI_M2) * u)
                                      - 1.0)
    r = torch.rand(n_bn, generator=g, device=device, dtype=torch.float32)
    state, at_z, at_r = {}, 0, 0
    for key, ref in shapes.items():
        if key in convs:
            shape = convs[key]
            n = math.prod(shape)
            ups = key.startswith("ups.")
            # ConvTranspose2d stores (in, out, kh, kw): its fan-in is the
            # input channels times the taps, as for the other convs
            fan_in = (shape[0] if ups else shape[1]) * shape[2] * shape[3]
            gain = 1.0 if ups or key.startswith("head.") else 2.0
            std = math.sqrt(gain / fan_in) / _TRUNC_STD
            state[key] = (z[at_z:at_z + n] * std).reshape(shape)
            at_z += n
        elif key in bns:
            n = math.prod(bns[key])
            lo, hi = _BN_RANGES[key.rsplit(".", 1)[1]]
            state[key] = (lo + (hi - lo) * r[at_r:at_r + n]).reshape(bns[key])
            at_r += n
        else:  # conv biases, num_batches_tracked
            state[key] = torch.zeros(ref.shape, dtype=ref.dtype, device=device)
    return state


def head_bias_for_share(logits: torch.Tensor, share: float,
                        threshold: float = 0.1) -> float:
    """What to add to the head's channel-0 bias so that ``share`` of the
    pixels pass p0 > ``threshold``, from the head's (1, 2, H, W) logits: the
    log-odds cut minus the (1 - share) quantile of logit0 - logit1."""
    gap = (logits[:, 0] - logits[:, 1]).float().reshape(-1)
    kth = max(1, int(round((1.0 - share) * gap.numel())))
    cut = math.log(threshold / (1.0 - threshold))
    return float(cut - torch.kthvalue(gap.cpu(), kth).values)
