"""Struct-of-tensors cell tables.

Port of ``tissue_image_processing_tpu/core/cell_table.py``: one frame's cells
as fixed-capacity padded tensors (row i holds segmentation label i+1),
``frame_cellinfo_checked``, the table of one label map with the compacted
adjacency and its overflow flag, the reference's type bitmask (uint8, bit k
= positive for type k, 255 = invalid) and the bridge to its pandas schema.
``pandas`` is imported only inside ``to_pandas`` / ``from_pandas``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from tissue_image_processing_tpu_torch._device import resolve_device
from tissue_image_processing_tpu_torch.ops.neighbors import (
    adjacency_matrix, adjacency_matrix_checked, neighbor_lists)
from tissue_image_processing_tpu_torch.ops.regionprops import regionprops

__all__ = ["CellTable", "frame_cellinfo", "frame_cellinfo_checked",
           "stack_tables", "is_positive_for_type", "change_type",
           "to_numpy", "replace_fields",
           "CELL_INFO_COLUMNS", "INVALID_TYPE_INDEX"]

INVALID_TYPE_INDEX = 255
CELL_INFO_COLUMNS = [
    "area", "perimeter", "label", "cx", "cy", "neighbors", "n_neighbors", "valid",
    "type", "bounding_box_min_row", "bounding_box_min_col", "bounding_box_max_row",
    "bounding_box_max_col", "empty_cell",
]
_BBOX_COLUMNS = ["bounding_box_min_row", "bounding_box_min_col",
                 "bounding_box_max_row", "bounding_box_max_col"]


def is_positive_for_type(cell_type: torch.Tensor, type_index) -> torch.Tensor:
    """Bitmask type query (reference ``is_positive_for_type``): ``type_index``
    is an int or a (positive list, negative list) tuple; invalid cells (255)
    are never positive."""
    cell_type = torch.as_tensor(cell_type)
    if isinstance(type_index, tuple):
        pos_types, neg_types = type_index
        res = torch.ones(cell_type.shape, dtype=torch.bool,
                         device=cell_type.device)
        for t in pos_types:
            res = res & is_positive_for_type(cell_type, t)
        for t in neg_types:
            res = res & ~is_positive_for_type(cell_type, t)
        return res
    if type_index < 0:
        return torch.zeros(cell_type.shape, dtype=torch.bool,
                           device=cell_type.device)
    ct = cell_type.to(torch.uint8)
    bit = 1 << type_index
    return ((ct & bit) == bit) & (ct != INVALID_TYPE_INDEX)


def change_type(current_type: torch.Tensor, type_index: int,
                is_positive) -> torch.Tensor:
    """Set (``is_positive``) or clear one type bit; invalid cells become
    valid first (reference ``change_type``)."""
    ct = torch.as_tensor(current_type).to(torch.uint8)
    ct = torch.where(ct == INVALID_TYPE_INDEX, torch.zeros_like(ct), ct)
    bit = torch.tensor(1 << type_index, dtype=torch.uint8, device=ct.device)
    cleared = ct & ~bit
    return torch.where(torch.as_tensor(is_positive, device=ct.device),
                       cleared | bit, cleared)


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

    @property
    def capacity(self) -> int:
        return self.area.shape[-1]

    def exists(self) -> torch.Tensor:
        return self.empty_cell == 0

    def valid_mask(self) -> torch.Tensor:
        return (self.valid == 1) & (self.empty_cell == 0)

    @classmethod
    def empty(cls, capacity: int, max_neighbors: int = 64,
              device: Optional[Union[str, torch.device]] = None) -> "CellTable":
        """A table of ``capacity`` empty slots on ``device`` (None: the card)."""
        dev = resolve_device(device)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return cls(area=zeros(capacity, dtype=torch.float32),
                   perimeter=zeros(capacity, dtype=torch.float32),
                   label=zeros(capacity), cx=zeros(capacity, dtype=torch.float32),
                   cy=zeros(capacity, dtype=torch.float32), valid=zeros(capacity),
                   type=zeros(capacity, dtype=torch.uint8),
                   bbox=zeros(capacity, 4),
                   empty_cell=torch.ones(capacity, dtype=torch.int32, device=dev),
                   neighbors=zeros(capacity, max_neighbors),
                   n_neighbors=zeros(capacity))

    def to_pandas(self):
        """One frame's table as a DataFrame of the reference's schema
        (neighbours as sets), interoperable with the ``.seg`` pickles the
        reference writes."""
        import pandas as pd

        host = self.map(lambda t: t.cpu().numpy())
        counts = host.n_neighbors
        neighbor_sets = [set(map(int, host.neighbors[i, :counts[i]]))
                         for i in range(self.capacity)]
        cols = {
            "area": host.area.astype(np.float64),
            "perimeter": host.perimeter.astype(np.float64),
            "label": host.label.astype(np.int64),
            "cx": host.cx.astype(np.float64),
            "cy": host.cy.astype(np.float64),
            "neighbors": neighbor_sets,
            "n_neighbors": counts.astype(np.int64),
            "valid": host.valid.astype(np.int64),
            "type": host.type.astype(np.uint8),
        }
        for j, col in enumerate(_BBOX_COLUMNS):
            cols[col] = host.bbox[:, j].astype(np.int64)
        cols["empty_cell"] = host.empty_cell.astype(np.int64)
        return pd.DataFrame(cols)

    @classmethod
    def from_pandas(cls, df, capacity: Optional[int] = None,
                    max_neighbors: int = 64,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> "CellTable":
        """A table from a DataFrame of the reference's schema: its first
        ``capacity`` rows (default: all), neighbour sets sorted and cut to
        ``max_neighbors``; on ``device`` (None: the card)."""
        dev = resolve_device(device)
        n = len(df)
        cap = capacity or n
        nbrs = np.zeros((cap, max_neighbors), np.int32)
        counts = np.zeros((cap,), np.int32)
        for i, s in enumerate(df["neighbors"].tolist()[:cap]):
            vals = sorted(int(v) for v in s)[:max_neighbors]
            nbrs[i, :len(vals)] = vals
            counts[i] = len(vals)

        def put(col, dtype, fill=0):
            arr = np.full((cap,), fill, dtype)
            arr[:n] = np.asarray(df[col], dtype)[:cap]
            return arr

        bbox = np.stack([put(col, np.int32) for col in _BBOX_COLUMNS], 1)
        fields = dict(
            area=put("area", np.float32), perimeter=put("perimeter", np.float32),
            label=put("label", np.int32), cx=put("cx", np.float32),
            cy=put("cy", np.float32), valid=put("valid", np.int32),
            type=put("type", np.uint8), bbox=bbox,
            empty_cell=put("empty_cell", np.int32, fill=1), neighbors=nbrs,
            n_neighbors=counts)
        return cls(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                      for k, v in fields.items()})

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "CellTable":
        """Apply ``fn`` to every field (e.g. slicing or ``.cpu()``)."""
        return CellTable(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


def to_numpy(x) -> np.ndarray:
    """A host numpy array of a tensor (read from the card if it lives there)
    or of anything ``np.asarray`` takes."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def replace_fields(table: CellTable, **fields) -> CellTable:
    """``dataclasses.replace`` with each new field (numpy or tensor) cast to
    the field's dtype on the device of the table's own tensor: a table on
    the CPU stays on the CPU, one on the card on the card."""
    out = {}
    for name, value in fields.items():
        old = getattr(table, name)
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value))
        out[name] = value.to(device=old.device, dtype=old.dtype)
    return dataclasses.replace(table, **out)


def stack_tables(tables: List[CellTable], cat: bool = False) -> CellTable:
    """Stack per-frame tables along a new leading axis (``cat=False``) or
    concatenate stacked tables along their leading axis (``cat=True``)."""
    join = torch.cat if cat else torch.stack
    return CellTable(**{f.name: join([getattr(t, f.name) for t in tables], 0)
                        for f in dataclasses.fields(CellTable)})


def _frame_cellinfo_impl(labels, capacity, max_neighbors, min_cell_area,
                         max_cell_area, intensity, with_neighbors,
                         neighbor_compact_k
                         ) -> Tuple[CellTable, torch.Tensor]:
    props = regionprops(labels, num_labels=capacity, intensity=intensity)
    # label 0 (background) is no cell; index_fill with an index on the
    # device, where ``exists[0] = False`` would copy from the host and wait
    exists = props["exists"].index_fill(
        0, torch.zeros(1, dtype=torch.int64, device=labels.device), False)
    area = torch.where(exists, props["area"], 0.0)[1:capacity + 1]
    exists_c = exists[1:capacity + 1]
    n_cells = torch.clamp(exists_c.sum(), min=1).to(torch.float32)
    mean_area = area.sum() / n_cells
    valid = (exists_c & (area < max_cell_area * mean_area)
             & (area > min_cell_area * mean_area)).to(torch.int32)
    overflow = torch.zeros((), dtype=torch.bool, device=labels.device)
    if with_neighbors:
        # the reference only inserts pairs whose window-max cell is valid
        working = torch.cat([torch.zeros(1, dtype=torch.bool,
                                         device=labels.device), valid == 1])
        if neighbor_compact_k is not None:
            adj, overflow = adjacency_matrix_checked(
                labels, num_labels=capacity, working_mask=working,
                compact_k=neighbor_compact_k)
        else:
            adj = adjacency_matrix(labels, num_labels=capacity,
                                   working_mask=working)
        nbrs, counts = neighbor_lists(adj, max_neighbors=max_neighbors)
    else:
        nbrs = torch.zeros((capacity + 1, max_neighbors), dtype=torch.int32,
                           device=labels.device)
        counts = torch.zeros(capacity + 1, dtype=torch.int32,
                             device=labels.device)
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
                   intensity: Optional[torch.Tensor] = None,
                   with_neighbors: bool = True,
                   neighbor_compact_k: Optional[int] = None) -> CellTable:
    """One frame's cell table: region properties, validity by area within
    (min_cell_area, max_cell_area) x the mean area, and the neighbour graph of
    valid cells. ``intensity`` (an (H, W) image) goes to ``regionprops``.
    ``with_neighbors=False`` skips the adjacency and zero-fills
    ``neighbors`` / ``n_neighbors`` (tracking reads positions and areas
    only). ``neighbor_compact_k=None`` is the exact one-vote-per-pixel
    adjacency, the recompute path for frames whose compacted table
    overflowed."""
    return _frame_cellinfo_impl(labels, capacity, max_neighbors, min_cell_area,
                                max_cell_area, intensity, with_neighbors,
                                neighbor_compact_k)[0]


def frame_cellinfo_checked(labels: torch.Tensor, capacity: int,
                           max_neighbors: int = 64,
                           min_cell_area: float = 0.1,
                           max_cell_area: float = 10.0,
                           intensity: Optional[torch.Tensor] = None,
                           neighbor_compact_k: int = 192
                           ) -> Tuple[CellTable, torch.Tensor]:
    """:func:`frame_cellinfo` with the compacted adjacency AND its overflow
    flag: (table, overflow). Recompute a flagged frame with
    ``frame_cellinfo(..., neighbor_compact_k=None)``."""
    return _frame_cellinfo_impl(labels, capacity, max_neighbors, min_cell_area,
                                max_cell_area, intensity, True,
                                neighbor_compact_k)
