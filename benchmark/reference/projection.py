"""Surface projection: 3-D membrane z-stack -> 2-D projection + height map.

Frozen copy of the plain code of the port's ``projection/surface.py``: the unfused
per-timepoint projection (airyscan offset, percentile clip, anisotropic
blurs, block-reduced scores, height-map argmax or continuity-constrained
manifold, one-hot z-mask blur, per-channel max), the parallel wavefront form
of the reference's spiral manifold construction. The port's fused
projection kernels are not copied: the unfused route is the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.filters import (
    block_reduce, gaussian_blur, resize_bilinear)
from benchmark.reference.morphology import shift2d
from benchmark.reference.percentile import (
    masked_percentile, percentile)

__all__ = ["time_point_surface_projection", "build_continuous_manifold"]

# the reference's neighbour priority in find_pixel_plane: row-1, row+1,
# col-1, col+1
_SHIFTS = [(-1, 0), (1, 0), (0, -1), (0, 1)]


def build_continuous_manifold(score: torch.Tensor) -> torch.Tensor:
    """Continuity-constrained (H, W) int32 height map over a (Z, H, W) score
    volume: a BFS front from the global score argmax assigns each pixel a
    plane by the reference's neighbour rule (the first two assigned
    neighbours, in the priority up, down, left, right, set the search
    window: one neighbour or two equal -> argmax over [n1-1, n1+1]; two
    differing by one -> argmax over [min, min+1]; farther apart -> their
    midpoint). One host read of ``frontier.any()`` per front step."""
    Z, H, W = score.shape
    dev = score.device
    zidx = torch.arange(Z, dtype=torch.int32, device=dev).reshape(Z, 1, 1)
    flat_peak = torch.argmax(score)
    pz = (flat_peak // (H * W)).to(torch.int32)
    py = (flat_peak // W) % H
    px = flat_peak % W
    z = torch.zeros((H, W), dtype=torch.int32, device=dev)
    z[py, px] = pz
    assigned = torch.zeros((H, W), dtype=torch.bool, device=dev)
    assigned[py, px] = True
    none = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=score.dtype, device=dev)
    while True:
        n1, n2 = none, none
        for dy, dx in _SHIFTS:
            qz = shift2d(z, -dy, -dx, 0)
            qa = shift2d(assigned, -dy, -dx, False)
            take1 = qa & (n1 == -1)
            take2 = qa & (n1 != -1) & (n2 == -1) & ~take1
            n1 = torch.where(take1, qz, n1)
            n2 = torch.where(take2, qz, n2)
        frontier = ~assigned & (n1 != -1)
        if not bool(frontier.any()):
            return z
        single = (n2 == -1) | (n1 == n2)
        adjacent = (n1 - n2).abs() == 1
        lo_single = torch.clamp_min(n1 - 1, 0)
        hi_single = torch.clamp_max(n1 + 1, Z - 1)
        mlo = torch.minimum(n1, n2)
        lo_adj = torch.clamp_min(mlo, 0)
        hi_adj = torch.clamp_max(mlo + 1, Z - 1)
        lo = torch.where(single, lo_single, lo_adj)
        hi = torch.where(single, hi_single, hi_adj)
        masked = torch.where((zidx >= lo[None]) & (zidx <= hi[None]), score,
                             neg_inf)
        win_z = torch.argmax(masked, dim=0).to(torch.int32)
        far_z = torch.div(n1 + n2, 2, rounding_mode="floor").to(torch.int32)
        new_val = torch.where(single | adjacent, win_z, far_z)
        z = torch.where(frontier, new_val, z)
        assigned = assigned | frontier


def _score_blur(vol: torch.Tensor, precise: bool) -> torch.Tensor:
    """The sigma (0.5, 30, 30) scoring blur. The fast form decimates 4x
    before blurring at >= 512^2 (sigma 30 passes nothing above ~1/60
    cycles/px) and returns the small volume for the caller's resize."""
    if precise:
        return gaussian_blur(vol, (0.5, 30.0, 30.0))
    _, Y, X = vol.shape
    if Y >= 512 and X >= 512 and Y % 4 == 0 and X % 4 == 0:
        small = block_reduce(vol, (1, 4, 4), "mean")
        return gaussian_blur(small, (0.5, 7.5, 7.5), fast=True)
    return gaussian_blur(vol, (0.5, 30.0, 30.0), fast=True)


def time_point_surface_projection(
    image: torch.Tensor,
    reference_channel: int = 0,
    min_z: int = 0,
    max_z: int = 0,
    method: str = "max_averages",
    bin_size: int = 1,
    airyscan: bool = True,
    atoh_shift: int = 0,
    build_manifold: bool = False,
    airyscan_offset: float = 10000.0,
    precise: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project one (C, Z, Y, X) timepoint to ((C, Y, X) float32 projection,
    (Y, X) int32 z-map), on the stack's device.

    - optional airyscan offset (subtract ``airyscan_offset``, clamp at 0);
    - z-window [min_z, max_z) when ``max_z > 0``;
    - the reference channel clipped at the 95th percentile of its positive
      values, then blurred (0.5, 1, 1);
    - score = blurred mean ('max_averages'), block variance ('max_std') or
      the atoh x zo product ('multi_channel'); the sigma-30 score blur is a
      box cascade unless ``precise``;
    - height map = per-pixel argmax over z, or the continuity-constrained
      manifold (``build_manifold``);
    - blurred one-hot z-mask times each channel, max over z (the mask of the
      z-map shifted by ``atoh_shift`` for the other channels).
    """
    img = image.to(torch.float32)
    if airyscan:
        img = torch.clamp_min(img - airyscan_offset, 0.0)
    if max_z > 0:
        img = img[:, min_z:max_z]
    channels, z_size, y_size, x_size = img.shape

    proj_ch = img[reference_channel]
    p95 = masked_percentile(proj_ch, proj_ch > 0, 95.0)
    proj_ch = torch.where((proj_ch > p95) & (p95 > 0), p95, proj_ch)
    proj_ch = gaussian_blur(proj_ch, (0.5, 1.0, 1.0))

    if bin_size > 1:
        block = (1, bin_size, bin_size)
        if method == "max_averages":
            score = block_reduce(gaussian_blur(proj_ch, (0.5, 30.0, 30.0),
                                               fast=not precise), block, "mean")
        elif method == "max_std":
            score = block_reduce(proj_ch, block, "var")
        elif method == "multi_channel":
            atoh = img[(reference_channel + 1) % channels]
            atoh = torch.minimum(atoh, percentile(atoh, 95.0))
            atoh = gaussian_blur(atoh, (0.5, 1.0, 1.0))
            zo_score = block_reduce(proj_ch, block, "var")
            atoh_score = block_reduce(gaussian_blur(atoh, (0.5, 30.0, 30.0),
                                                    fast=not precise),
                                      block, "mean")
            score = atoh_score * zo_score
        else:
            raise ValueError(f"No such method {method}")
    else:
        score = _score_blur(proj_ch, precise)

    if build_manifold:
        chosen = build_continuous_manifold(score)
        if tuple(chosen.shape) != (y_size, x_size):
            chosen = torch.round(resize_bilinear(
                chosen.to(torch.float32), (y_size, x_size))).to(torch.int32)
    else:
        if tuple(score.shape[1:]) != (y_size, x_size):
            score = resize_bilinear(score, (z_size, y_size, x_size))
        chosen = torch.argmax(score, dim=0).to(torch.int32)
    # the masks index the (possibly) windowed stack with window-relative
    # planes; the reported z-map is absolute
    rel_z = chosen
    rel_z_atoh = torch.clamp(rel_z + atoh_shift, 0, z_size - 1)

    zidx = torch.arange(z_size, dtype=torch.int32, device=img.device
                        ).reshape(z_size, 1, 1)
    mask = gaussian_blur((zidx == rel_z[None]).to(torch.float32), (1.0, 2.0, 2.0))
    if atoh_shift == 0:
        mask_atoh = mask
    else:
        mask_atoh = gaussian_blur((zidx == rel_z_atoh[None]).to(torch.float32),
                                  (1.0, 2.0, 2.0))
    projection = torch.stack([
        (img[c] * (mask if c == reference_channel else mask_atoh)).amax(dim=0)
        for c in range(channels)])
    return projection, chosen + min_z
