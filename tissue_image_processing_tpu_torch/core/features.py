"""Per-frame feature engine over cell tables.

Port of ``tissue_image_processing_tpu/core/features.py``: every feature
family is a vectorised function over the padded ``CellTable`` and its
neighbour lists, computed on the table's own device.

Families:
- SPECIAL  : psi6, shape index, roundness, neighbours by type (first and
             second order), contact lengths, distance from ablation
- GLOBAL   : density, type_fraction, total_area, neighbours correlation
             (two methods)
- SPATIAL  : windowed density / type_fraction maps

``second_order_neighbors_from_type`` is a dense (N+1)^2 0/1 product, exact
in any accumulation order (TF32 included); ``spatial_map`` broadcasts over
row chunks of its grid so grid x capacity stays bounded.
``voronoi_neighbor_lists`` is host scipy.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tissue_image_processing_tpu_torch.core.cell_table import (
    CellTable, is_positive_for_type, to_numpy)

__all__ = [
    "roundness", "shape_index", "neighbors_adjacency", "n_neighbors_from_type",
    "second_order_neighbors_from_type", "psi_n", "total_area", "density",
    "type_fraction", "neighbors_correlation", "contact_lengths_by_type",
    "distance_from_points", "cells_inside_circle", "spatial_map",
    "voronoi_neighbor_lists",
]

# elements of a spatial_map chunk (grid points x capacity)
_SPATIAL_CHUNK = 1 << 24


def roundness(table: CellTable) -> torch.Tensor:
    """4*pi*area/perimeter^2."""
    p2 = torch.clamp(table.perimeter ** 2, min=1e-9)
    return 4.0 * math.pi * table.area / p2


def shape_index(table: CellTable) -> torch.Tensor:
    """perimeter/sqrt(area)."""
    return table.perimeter / torch.sqrt(torch.clamp(table.area, min=1e-9))


def neighbors_adjacency(table: CellTable) -> torch.Tensor:
    """(N+1, N+1) bool adjacency from the padded neighbour lists."""
    n = table.capacity
    dev = table.neighbors.device
    cols = table.neighbors.to(torch.int64)
    rows = torch.arange(1, n + 1, dtype=torch.int64,
                        device=dev)[:, None].expand_as(cols)
    valid = cols > 0
    adj = torch.zeros((n + 1) * (n + 1), dtype=torch.bool, device=dev)
    adj[(rows * (n + 1) + cols)[valid]] = True
    adj[0] = False
    return adj.reshape(n + 1, n + 1)


def _type_mask(table: CellTable, type_index, positive_for_type: bool
               ) -> torch.Tensor:
    pos = is_positive_for_type(table.type, type_index)
    return pos if positive_for_type else ~pos


def _neighbor_rows(table: CellTable):
    """(slot holds a neighbour, the neighbour's row) over the padded lists."""
    nbr = table.neighbors
    return nbr > 0, torch.clamp(nbr - 1, 0, table.capacity - 1).long()


def n_neighbors_from_type(table: CellTable, type_index=None,
                          positive_for_type: bool = True,
                          same_type: bool = False,
                          count_mode: str = "typed") -> torch.Tensor:
    """Per-cell count of neighbours matching a type predicate.

    count_mode: 'typed' (valid & non-empty & type predicate), 'all' (every
    listed neighbour), 'valid', or 'invalid'."""
    has, idx = _neighbor_rows(table)
    nbr_valid = (table.valid[idx] == 1) & (table.empty_cell[idx] == 0)
    if count_mode == "all":
        ok = has
    elif count_mode == "valid":
        ok = has & nbr_valid
    elif count_mode == "invalid":
        ok = has & (table.valid[idx] == 0) & (table.empty_cell[idx] == 0)
    elif same_type:
        # each cell looks for neighbours positive for ITS own type bits
        nbr_type = table.type[idx]
        own = table.type[:, None]
        match = ((nbr_type & own) == own) & (nbr_type != 255) & (own != 255)
        ok = has & nbr_valid & (match if positive_for_type else ~match)
    else:
        tm = _type_mask(table, type_index, positive_for_type)
        ok = has & nbr_valid & tm[idx]
    return ok.to(torch.int32).sum(dim=1, dtype=torch.int32)


def second_order_neighbors_from_type(table: CellTable, type_index=None,
                                     positive_for_type: bool = True,
                                     count_all: bool = False) -> torch.Tensor:
    """Count of second-order neighbours with a type predicate: the union of
    neighbours of valid neighbours, self excluded, first order kept. The
    reach is a 0/1 matrix product, exact in any accumulation order."""
    adj = neighbors_adjacency(table).to(torch.float32)
    dev = adj.device
    valid1 = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                        table.valid_mask()])
    mid = adj * valid1.to(torch.float32)[None, :]
    reach = torch.matmul(mid, adj) > 0
    reach.fill_diagonal_(False)
    ok = reach & valid1[None, :]
    if not count_all:
        tm = _type_mask(table, type_index, positive_for_type)
        ok = ok & torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                             tm])[None, :]
    return ok[1:, 1:].to(torch.int32).sum(dim=1, dtype=torch.int32)


def psi_n(table: CellTable, neighbor_sets: torch.Tensor, n: int = 6
          ) -> torch.Tensor:
    """Bond-orientational order parameter psi_n: |sum_j exp(-i n theta_j)| /
    n_neighbours over the given (N, K) neighbour-label lists (typically the
    Voronoi nearest HCs)."""
    idx = torch.clamp(neighbor_sets - 1, 0, table.capacity - 1).long()
    has = neighbor_sets > 0
    dy = table.cy[idx] - table.cy[:, None]
    dx = table.cx[idx] - table.cx[:, None]
    theta = torch.atan2(dy, dx)
    re = torch.where(has, torch.cos(n * theta), 0.0).sum(dim=1)
    im = torch.where(has, -torch.sin(n * theta), 0.0).sum(dim=1)
    cnt = torch.clamp(has.to(torch.float32).sum(dim=1), min=1.0)
    return torch.sqrt(re ** 2 + im ** 2) / cnt


def total_area(table: CellTable, mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    m = table.valid_mask() if mask is None else mask
    return torch.where(m, table.area, 0.0).sum()


def density(table: CellTable, mask: torch.Tensor,
            reference_area: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cells per unit total area."""
    if reference_area is None:
        reference_area = total_area(table, table.exists())
    n = mask.to(torch.float32).sum()
    return torch.where(reference_area > 0, n / reference_area,
                       torch.zeros_like(n))


def type_fraction(table: CellTable, mask: torch.Tensor,
                  reference_count: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    if reference_count is None:
        reference_count = table.valid_mask().to(torch.float32).sum()
    n = mask.to(torch.float32).sum()
    return torch.where(reference_count > 0, n / reference_count,
                       torch.zeros_like(n))


def neighbors_correlation(table: CellTable, state: torch.Tensor,
                          mask: torch.Tensor, method: str = "neighbors"
                          ) -> torch.Tensor:
    """Neighbour state correlation. ``state``: (N,) float per-cell state
    (e.g. 1 for HC); ``mask``: the valid cells included."""
    nm = mask.to(torch.float32).sum()
    avg = torch.where(mask, state, 0.0).sum() / torch.clamp(nm, min=1.0)
    var = (torch.where(mask, (state - avg) ** 2, 0.0).sum()
           / torch.clamp(nm, min=1.0))
    has, idx = _neighbor_rows(table)
    pair_ok = mask[:, None] & has & mask[idx]
    if method == "neighbors":
        contrib = (state[idx] - avg) * (state[:, None] - avg)
        corr = torch.where(pair_ok, contrib, 0.0).sum()
        cnt = pair_ok.to(torch.float32).sum()
        return corr / torch.clamp(cnt * var, min=1e-12)
    # neighbours average
    nbr_sum = torch.where(pair_ok, state[idx], 0.0).sum(dim=1)
    nbr_cnt = pair_ok.to(torch.float32).sum(dim=1)
    nbr_avg = torch.where(nbr_cnt > 0, nbr_sum / torch.clamp(nbr_cnt, min=1.0),
                          0.0)
    nm2 = torch.clamp(nm, min=1.0)
    na_mean = torch.where(mask, nbr_avg, 0.0).sum() / nm2
    na_std = torch.sqrt(torch.where(mask, (nbr_avg - na_mean) ** 2,
                                    0.0).sum() / nm2)
    num = torch.where(mask, (state - avg) * (nbr_avg - na_mean), 0.0).sum()
    return num / torch.clamp(nm2 * torch.sqrt(var) * na_std, min=1e-12)


def contact_lengths_by_type(table: CellTable, contact_matrix: torch.Tensor,
                            type_index=None, positive_for_type: bool = True,
                            all_types: bool = False) -> torch.Tensor:
    """Per-cell total boundary contact with neighbours of a type."""
    dev = table.type.device
    if all_types:
        sel = torch.ones(table.capacity, dtype=torch.bool, device=dev)
    else:
        sel = _type_mask(table, type_index, positive_for_type)
    sel = sel & (table.empty_cell == 0)
    col_mask = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                          sel]).to(torch.float32)
    return (contact_matrix[1:, :] * col_mask[None, :]).sum(dim=1)


def distance_from_points(table: CellTable, points_yx: torch.Tensor
                         ) -> torch.Tensor:
    """Min distance from each cell centroid to any of the (M, 2) points."""
    dy = table.cy[:, None] - points_yx[None, :, 0]
    dx = table.cx[:, None] - points_yx[None, :, 1]
    return torch.sqrt(dy ** 2 + dx ** 2).min(dim=1).values


def cells_inside_circle(table: CellTable, center_yx, radius) -> torch.Tensor:
    """(N,) mask of the cells inside a circle."""
    dy = table.cy - center_yx[0]
    dx = table.cx - center_yx[1]
    return (dy ** 2 + dx ** 2) < radius ** 2


def spatial_map(table: CellTable, shape, window_radius: float, step_size: int,
                values: torch.Tensor, mask: torch.Tensor,
                feature: str = "mean") -> torch.Tensor:
    """Windowed spatial map: an (H, W) map where each ``step_size`` block
    holds the windowed aggregate of ``values`` over the cells within
    ``window_radius`` of the block centre. feature: 'mean' | 'density'
    (count of values > 0 / total window area) | 'fraction' (count of
    values > 0 / count). The grid is taken in row chunks of at most
    ``_SPATIAL_CHUNK`` grid points x cells."""
    H, W = shape
    dev = table.cy.device
    gys = torch.arange(step_size // 2, H, step_size, device=dev,
                       dtype=torch.float32)
    gxs = torch.arange(step_size // 2, W, step_size, device=dev,
                       dtype=torch.float32)
    values = values.to(torch.float32)
    r2 = float(window_radius) ** 2   # squared in double, compared in float32
    dx2 = (table.cx[None, :] - gxs[:, None]) ** 2               # (gx, N)
    rows_per = max(1, _SPATIAL_CHUNK // max(gxs.numel() * table.capacity, 1))
    out = []
    for r0 in range(0, gys.numel(), rows_per):
        dy2 = (table.cy[None, :] - gys[r0:r0 + rows_per, None]) ** 2  # (gy, N)
        inside = mask & (dy2[:, None, :] + dx2[None, :, :] < r2)
        cnt = inside.to(torch.float32).sum(-1)
        if feature == "mean":
            s = torch.where(inside, values, 0.0).sum(-1)
            out.append(torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0))
            continue
        sel = (inside & (values > 0)).to(torch.float32).sum(-1)
        if feature == "density":
            area = torch.where(inside, table.area, 0.0).sum(-1)
            out.append(torch.where(area > 0, sel / area, 0.0))
        else:  # fraction
            out.append(torch.where(cnt > 0, sel / cnt, 0.0))
    grid = torch.cat(out, 0)
    up = grid.repeat_interleave(step_size, 0).repeat_interleave(step_size, 1)
    return up[:H, :W]


def voronoi_neighbor_lists(table: CellTable, mask,
                           max_neighbors: int = 32) -> np.ndarray:
    """Nearest-neighbour sets from a Voronoi tessellation of the masked
    centroids (host scipy). Returns (N, K) padded label lists."""
    from scipy.spatial import Voronoi

    n = table.capacity
    out = np.zeros((n, max_neighbors), np.int32)
    idxs = np.nonzero(to_numpy(mask))[0]
    if idxs.size < 4:
        return out
    centers = np.stack([to_numpy(table.cx)[idxs], to_numpy(table.cy)[idxs]], 1)
    sets = [set() for _ in range(idxs.size)]
    vor = Voronoi(centers)
    for a, b in vor.ridge_points:
        sets[a].add(int(idxs[b]) + 1)
        sets[b].add(int(idxs[a]) + 1)
    for local_i, cell_i in enumerate(idxs):
        vals = sorted(sets[local_i])[:max_neighbors]
        out[cell_i, :len(vals)] = vals
    return out
