"""Region properties via segment reductions.

Frozen copy of the plain code of the port's ``ops/regionprops.py``: area, centroid,
skimage's weighted border-pattern perimeter and the bounding box of every
label 1..N of a label map, as padded (N+1,) vectors indexed by label. Sums
are taken exactly in int64 by ``index_add_`` (the JAX version's radix one-hot
matmuls are exact in float32 for the same integer sums) and the bounding box
by ``scatter_reduce`` min/max.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from benchmark.reference import host as _device
from benchmark.reference.numerics import fma_f32
from benchmark.reference.morphology import shift2d

__all__ = ["regionprops", "perimeter_codes"]

_NBRS4 = [(1, 0), (-1, 0), (0, 1), (0, -1)]
_DIAG4 = [(1, 1), (1, -1), (-1, 1), (-1, -1)]
_SQRT2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32).item()


def _host_perimeter_tables() -> torch.Tensor:
    a = torch.zeros(50, dtype=torch.int64)
    b = torch.zeros(50, dtype=torch.int64)
    a[[5, 7, 15, 17, 25, 27]] = 2
    b[[21, 33]] = 2
    a[[13, 23]] = 1
    b[[13, 23]] = 1
    return torch.stack([a, b])


def _perimeter_tables(device):
    """Weight = (a + b*sqrt2) / 2 with small ints a, b per border code. Built
    on the host and copied once per device and stream, so a call makes no
    host synchronisation."""
    ab = _device.host_constant("perimeter_tables", _host_perimeter_tables,
                               device)
    return ab[0], ab[1]


def perimeter_codes(labels: torch.Tensor) -> torch.Tensor:
    """Benkrid/Crookes border-pattern code per pixel (0 for non-border)."""
    lab = labels.to(torch.int32)
    fg = lab > 0
    interior = fg.clone()
    for dy, dx in _NBRS4:
        interior &= shift2d(lab, -dy, -dx, -1) == lab
    border = fg & ~interior
    code = border.to(torch.int32)
    for dy, dx in _NBRS4:
        nb = shift2d(border, -dy, -dx, False) & (shift2d(lab, -dy, -dx, -1) == lab)
        code = code + 2 * nb.to(torch.int32)
    for dy, dx in _DIAG4:
        nb = shift2d(border, -dy, -dx, False) & (shift2d(lab, -dy, -dx, -1) == lab)
        code = code + 10 * nb.to(torch.int32)
    return torch.where(border, code, 0)


def regionprops(labels: torch.Tensor, num_labels: int,
                intensity: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Per-label properties of an (H, W) label map (0 = background).

    Returns (num_labels+1,)-shaped tensors: area, cy, cx, perimeter,
    bbox_min_row, bbox_min_col, bbox_max_row, bbox_max_col (max exclusive),
    exists, and the scalar ``overflow`` (labels dropped past the capacity);
    with an (H, W) ``intensity`` image also ``mean_intensity`` (summed in
    float64, divided in float32)."""
    H, W = labels.shape
    dev = labels.device
    lab_raw = labels.to(torch.int32)
    overflow = torch.clamp(lab_raw.max() - num_labels, min=0)
    lab = torch.where(lab_raw > num_labels, 0, torch.clamp(lab_raw, min=0))
    flat = lab.reshape(-1).to(torch.int64)
    ns = num_labels + 1
    ys = torch.arange(H, device=dev).repeat_interleave(W)
    xs = torch.arange(W, device=dev).repeat(H)
    code = torch.clamp(perimeter_codes(lab_raw), 0, 49).reshape(-1)
    pa, pb = _perimeter_tables(dev)

    def seg_sum(v):
        return torch.zeros(ns, dtype=torch.int64, device=dev).index_add_(0, flat, v)

    counts = seg_sum(torch.ones_like(flat))
    area = counts.to(torch.float32)
    safe_area = torch.clamp(area, min=1.0)
    cy = seg_sum(ys).to(torch.float32) / safe_area
    cx = seg_sum(xs).to(torch.float32) / safe_area
    perim = fma_f32(seg_sum(pb[code]).to(torch.float32), _SQRT2,
                    seg_sum(pa[code]).to(torch.float32)) / 2.0

    def seg_ext(v, reduce, init):
        return torch.full((ns,), init, dtype=torch.int64, device=dev).scatter_reduce_(
            0, flat, v, reduce=reduce, include_self=False)

    exists = counts > 0
    zero = torch.zeros_like(counts)
    out = {
        "area": area, "cy": cy, "cx": cx, "perimeter": perim,
        "bbox_min_row": torch.where(exists, seg_ext(ys, "amin", 0), zero),
        "bbox_min_col": torch.where(exists, seg_ext(xs, "amin", 0), zero),
        "bbox_max_row": torch.where(exists, seg_ext(ys, "amax", -1) + 1, zero),
        "bbox_max_col": torch.where(exists, seg_ext(xs, "amax", -1) + 1, zero),
        "exists": exists, "overflow": overflow,
    }
    for k in ("bbox_min_row", "bbox_min_col", "bbox_max_row", "bbox_max_col"):
        out[k] = out[k].to(torch.int32)
    if intensity is not None:
        sums = torch.zeros(ns, dtype=torch.float64, device=dev).index_add_(
            0, flat, intensity.reshape(-1).to(torch.float64))
        out["mean_intensity"] = sums.to(torch.float32) / safe_area
    return out
