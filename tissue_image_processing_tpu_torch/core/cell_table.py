"""Struct-of-tensors cell tables.

Port of ``tissue_image_processing_tpu/core/cell_table.py``: one frame's cells
as fixed-capacity padded tensors (row i holds segmentation label i+1), and
``frame_cellinfo_checked``, the table of one label map with the compacted
adjacency and its overflow flag.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from tissue_image_processing_tpu_torch.ops.neighbors import (
    adjacency_matrix, adjacency_matrix_checked, neighbor_lists)
from tissue_image_processing_tpu_torch.ops.regionprops import regionprops

__all__ = ["CellTable", "frame_cellinfo", "frame_cellinfo_checked",
           "stack_tables"]


@dataclasses.dataclass(frozen=True)
class CellTable:
    """Cells of one frame (fields of shape (N, ...)) or of a stack of frames
    (fields of shape (T, N, ...))."""

    area: torch.Tensor          # f32
    perimeter: torch.Tensor     # f32
    label: torch.Tensor         # i32 — track id, 0 = unassigned
    cx: torch.Tensor            # f32
    cy: torch.Tensor            # f32
    valid: torch.Tensor         # i32
    type: torch.Tensor          # u8 bitmask
    bbox: torch.Tensor          # (..., 4) i32 (min_row, min_col, max_row, max_col)
    empty_cell: torch.Tensor    # i32 — 1 if slot has no cell
    neighbors: torch.Tensor     # (..., K) i32 segmentation labels, 0-padded
    n_neighbors: torch.Tensor   # i32

    def valid_mask(self) -> torch.Tensor:
        return (self.valid == 1) & (self.empty_cell == 0)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "CellTable":
        """Apply ``fn`` to every field (e.g. slicing or ``.cpu()``)."""
        return CellTable(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


def stack_tables(tables: List[CellTable], cat: bool = False) -> CellTable:
    """Stack per-frame tables along a new leading axis (``cat=False``) or
    concatenate stacked tables along their leading axis (``cat=True``)."""
    join = torch.cat if cat else torch.stack
    return CellTable(**{f.name: join([getattr(t, f.name) for t in tables], 0)
                        for f in dataclasses.fields(CellTable)})


def _frame_cellinfo_impl(labels, capacity, max_neighbors, min_cell_area,
                         max_cell_area, neighbor_compact_k
                         ) -> Tuple[CellTable, torch.Tensor]:
    props = regionprops(labels, num_labels=capacity)
    exists = props["exists"].clone()
    exists[0] = False
    area = torch.where(exists, props["area"], 0.0)[1:capacity + 1]
    exists_c = exists[1:capacity + 1]
    n_cells = torch.clamp(exists_c.sum(), min=1).to(torch.float32)
    mean_area = area.sum() / n_cells
    valid = (exists_c & (area < max_cell_area * mean_area)
             & (area > min_cell_area * mean_area)).to(torch.int32)
    # the reference only inserts pairs whose window-max cell is valid
    working = torch.cat([torch.zeros(1, dtype=torch.bool, device=labels.device),
                         valid == 1])
    if neighbor_compact_k is not None:
        adj, overflow = adjacency_matrix_checked(
            labels, num_labels=capacity, working_mask=working,
            compact_k=neighbor_compact_k)
    else:
        adj = adjacency_matrix(labels, num_labels=capacity, working_mask=working)
        overflow = torch.zeros((), dtype=torch.bool, device=labels.device)
    nbrs, counts = neighbor_lists(adj, max_neighbors=max_neighbors)
    bbox = torch.stack([props["bbox_min_row"], props["bbox_min_col"],
                        props["bbox_max_row"], props["bbox_max_col"]], dim=1)
    seg_label = torch.arange(1, capacity + 1, dtype=torch.int32,
                             device=labels.device)
    table = CellTable(
        area=area,
        perimeter=torch.where(exists_c, props["perimeter"][1:], 0.0),
        label=torch.where(exists_c, seg_label, 0),
        cx=torch.where(exists_c, props["cx"][1:], 0.0),
        cy=torch.where(exists_c, props["cy"][1:], 0.0),
        valid=valid,
        type=torch.zeros(capacity, dtype=torch.uint8, device=labels.device),
        bbox=bbox[1:],
        empty_cell=(~exists_c).to(torch.int32),
        neighbors=nbrs[1:],
        n_neighbors=counts[1:],
    )
    return table, overflow


def frame_cellinfo(labels: torch.Tensor, capacity: int,
                   max_neighbors: int = 64, min_cell_area: float = 0.1,
                   max_cell_area: float = 10.0,
                   neighbor_compact_k: Optional[int] = None) -> CellTable:
    """One frame's cell table: region properties, validity by area within
    (min_cell_area, max_cell_area) x the mean area, and the neighbour graph of
    valid cells. ``neighbor_compact_k=None`` is the exact one-vote-per-pixel
    adjacency, the recompute path for frames whose compacted table
    overflowed."""
    return _frame_cellinfo_impl(labels, capacity, max_neighbors, min_cell_area,
                                max_cell_area, neighbor_compact_k)[0]


def frame_cellinfo_checked(labels: torch.Tensor, capacity: int,
                           max_neighbors: int = 64,
                           min_cell_area: float = 0.1,
                           max_cell_area: float = 10.0,
                           neighbor_compact_k: int = 192
                           ) -> Tuple[CellTable, torch.Tensor]:
    """:func:`frame_cellinfo` with the compacted adjacency AND its overflow
    flag: (table, overflow). Recompute a flagged frame with
    ``frame_cellinfo(..., neighbor_compact_k=None)``."""
    return _frame_cellinfo_impl(labels, capacity, max_neighbors, min_cell_area,
                                max_cell_area, neighbor_compact_k)
