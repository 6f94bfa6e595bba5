"""Interactive segmentation editing: add / remove boundary lines, relabel, undo.

Port of ``tissue_image_processing_tpu/core/editing.py``. Adding a
segmentation line splits a cell (a connected-component relabel inside its
bounding box); removing a line merges the two neighbours. The edits are
pointer-driven and small, so they run on the host label map; the frame's
table is then recomputed by ``Tissue.calculate_frame_cellinfo`` on the
session's device and its rows rewritten on the table's own device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tissue_image_processing_tpu_torch.core.cell_table import (
    change_type, is_positive_for_type, replace_fields, to_numpy)

__all__ = ["draw_line", "draw_disk", "find_nearest_segmentation_pixel",
           "SegmentationEditor", "MAX_SEG_LINE_LENGTH"]

MAX_SEG_LINE_LENGTH = 100


def draw_line(y0: int, x0: int, y1: int, x1: int):
    """Bresenham line (``skimage.draw.line`` semantics): the integer pixel
    chain from (y0, x0) to (y1, x1) inclusive."""
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
    swapped = x0 > x1
    if swapped:
        x0, x1 = x1, x0
        y0, y1 = y1, y0
    dx = x1 - x0
    dy = abs(y1 - y0)
    err = dx / 2.0
    ystep = 1 if y0 < y1 else -1
    y = y0
    rr, cc = [], []
    for x in range(x0, x1 + 1):
        if steep:
            rr.append(x)
            cc.append(y)
        else:
            rr.append(y)
            cc.append(x)
        err -= dy
        if err < 0:
            y += ystep
            err += dx
    pts = (np.array(rr), np.array(cc))
    if swapped:
        pts = (pts[0][::-1], pts[1][::-1])
    return pts


def draw_disk(center, radius, shape=None):
    """Filled disk pixel coordinates (``skimage.draw.disk`` semantics)."""
    cy, cx = center
    r = int(np.ceil(radius))
    yy, xx = np.mgrid[int(cy) - r:int(cy) + r + 1, int(cx) - r:int(cx) + r + 1]
    inside = (yy - cy) ** 2 + (xx - cx) ** 2 < radius ** 2
    rr, cc = yy[inside], xx[inside]
    if shape is not None:
        ok = (rr >= 0) & (rr < shape[0]) & (cc >= 0) & (cc < shape[1])
        rr, cc = rr[ok], cc[ok]
    return rr, cc


def find_nearest_segmentation_pixel(labels: np.ndarray, point, distance_limit: int = -1):
    """Nearest boundary (0-labelled) pixel by expanding square rings."""
    x, y = int(point[0]), int(point[1])
    H, W = labels.shape
    if distance_limit > 0:
        max_d = distance_limit
    else:
        edges = [x, W - x, y, H - y]
        max_d = edges[int(np.argmin(edges))]
    for d in range(max_d):
        y0, y1 = max(y - d, 0), min(y + d, H - 1)
        x0, x1 = max(x - d, 0), min(x + d, W - 1)
        for i in (y0, y1):
            row = labels[i, x0:x1 + 1]
            hits = np.nonzero(row == 0)[0]
            if hits.size:
                return x0 + hits[0], i
        for j in (x0, x1):
            col = labels[y0:y1 + 1, j]
            hits = np.nonzero(col == 0)[0]
            if hits.size:
                return j, y0 + hits[0]
    if distance_limit > 0:
        return None, None
    edges = [0, W - 1, 0, H - 1]
    nearest = int(np.argmin([x, W - x, y, H - y]))
    if nearest < 2:
        return edges[nearest], y
    return x, edges[nearest]


class SegmentationEditor:
    """Stateful editing session over a Tissue.

    Every completed action (add line, remove line) pushes a sparse patch —
    the changed pixels' old values plus the pre-edit table and cell-types
    pixels — onto an undo stack, so ``undo_last_action`` restores the frame
    BIT FOR BIT (labels, track ids, types) at any depth of undo."""

    def __init__(self, tissue):
        self.tissue = tissue
        self.last_added_line: List[Tuple[int, int]] = []
        self.last_action: List[str] = []
        self._undo_stack: List[dict] = []
        self._pending: Optional[dict] = None  # open (multi-click) action
        self._neighbors_labels: List[int] = []
        self._line_pixels: List[Tuple[int, int]] = []

    # ------------- undo patches

    @property
    def _labels_before(self) -> Optional[np.ndarray]:
        """Pre-edit label map of the action being built."""
        return self._pending["labels"] if self._pending else None

    def _begin_action(self, frame: int, action: str):
        if self._pending is not None:
            # a half-drawn line left open: seal its patch first, or its
            # zeroed pixels would become unrecoverable
            self._commit_action()
        labels = self.tissue.get_labels(frame)
        types_map = self.tissue.get_cell_types(frame)
        self._pending = {
            "action": action, "frame": frame, "labels": labels.copy(),
            "table": self.tissue.get_cells_info(frame),
            "types_map": None if types_map is None else types_map.copy()}

    def _commit_action(self):
        """Close the pending action: diff the frame against its pre-edit
        snapshot and keep only the changed pixels."""
        pre = self._pending
        self._pending = None
        if pre is None:
            return
        frame = pre["frame"]
        entry = {"action": pre["action"], "frame": frame,
                 "table": pre["table"]}
        now = self.tissue.get_labels(frame)
        ys, xs = np.nonzero(now != pre["labels"])
        entry["pixels"] = (ys, xs, pre["labels"][ys, xs])
        types_now = self.tissue.get_cell_types(frame)
        if pre["types_map"] is not None and types_now is not None:
            tys, txs = np.nonzero(types_now != pre["types_map"])
            entry["type_pixels"] = (tys, txs, pre["types_map"][tys, txs])
        self._undo_stack.append(entry)
        self.last_action.append(entry["action"])  # mirrors _undo_stack

    def undo_last_action(self, frame: int) -> int:
        """Revert the most recent completed action on ``frame``: labels,
        table (track ids and types included) and the cell-types map return
        to their exact pre-edit state."""
        if self._pending is not None and self._pending["frame"] == frame:
            self._commit_action()  # undo of a half-drawn line: close it first
        if not self._undo_stack or self._undo_stack[-1]["frame"] != frame:
            return 0
        entry = self._undo_stack.pop()
        if self.last_action:
            self.last_action.pop()
        labels = self.tissue.get_labels(frame)
        ys, xs, old = entry["pixels"]
        labels[ys, xs] = old
        self.tissue.set_labels(frame, labels)
        self.tissue.set_cells_info(frame, entry["table"])
        if "type_pixels" in entry:
            types_map = self.tissue.get_cell_types(frame)
            tys, txs, told = entry["type_pixels"]
            types_map[tys, txs] = told
            self.tissue.set_cell_types(frame, types_map)
        return 1

    # ------------- add line (split a cell)

    def add_segmentation_line(self, frame: int, point1, point2=None,
                              initial: bool = False, final: bool = False) -> int:
        """Draw one segment of a (possibly multi-click) boundary polyline.

        ``initial=True`` opens the line at ``point1``; each further call
        draws ``point2 -> point1``; ``final=True`` closes it. Free ends snap
        to the nearest pre-edit boundary pixel. A ``point1`` farther than
        MAX_SEG_LINE_LENGTH from ``point2`` is a stray click: the line
        closes at ``point2`` instead and 1 is returned. On close, the cell
        the line crossed — the majority pre-edit label under the drawn
        pixels — is split into its connected components."""
        labels = self.tissue.get_labels(frame)
        if labels is None:
            return 0
        if initial:
            self._begin_action(frame, "add")
            self._line_pixels = []
            self.last_added_line.append((int(point1[0]), int(point1[1])))
        stray_click = False
        end = (int(point1[0]), int(point1[1]))
        if point2 is not None:
            start = (int(point2[0]), int(point2[1]))
            gap2 = (end[0] - start[0]) ** 2 + (end[1] - start[1]) ** 2
            if gap2 > MAX_SEG_LINE_LENGTH ** 2:
                stray_click, final = True, True
                end, start = start, None  # close at the previous point
        else:
            start = None
        if start is None:
            snapped = find_nearest_segmentation_pixel(self._labels_before, end)
            start = end
            end = snapped
        rr, cc = draw_line(start[1], start[0], end[1], end[0])
        labels[rr, cc] = 0
        self._line_pixels.extend(zip(rr.tolist(), cc.tolist()))
        cell_types = self.tissue.get_cell_types(frame)
        if cell_types is not None:
            cell_types[rr, cc] = 255
        if final:
            self._finish_added_line(frame)
        return int(stray_click)

    def _finish_added_line(self, frame: int):
        """Vote the split cell from the drawn pixels and relabel, then seal
        the undo patch."""
        if self._line_pixels and self._labels_before is not None:
            ys, xs = np.array(self._line_pixels).T
            under = self._labels_before[ys, xs]
            under = under[under > 0]
            if under.size:
                split_label = int(np.bincount(under).argmax())
                self._update_after_line_addition(frame, split_label)
        self._commit_action()

    def _update_after_line_addition(self, frame: int, cell_label: int):
        """Split the edited cell into connected components and refresh its
        table rows."""
        from scipy import ndimage as ndi

        tissue = self.tissue
        labels = tissue.get_labels(frame)
        table = tissue.get_cells_info(frame)
        if table is None:
            return
        bbox = to_numpy(table.bbox[cell_label - 1])
        r0 = max(0, int(bbox[0]) - 2)
        c0 = max(0, int(bbox[1]) - 2)
        r1 = int(bbox[2]) + 2
        c1 = int(bbox[3]) + 2
        region = labels[r0:r1, c0:c1]
        comp, _ = ndi.label((region != 0).astype(int),
                            structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
        regional = np.unique(comp[region == cell_label])
        regional = regional[regional > 0]
        if regional.size <= 1:
            print("New line did not split the cell")
            return
        new_labels = [cell_label] + self._get_new_labels(frame, regional.size - 1)
        for reg, lab in zip(regional, new_labels):
            region[comp == reg] = lab
        labels[r0:r1, c0:c1] = region
        self._refresh_rows(frame, new_labels, origin_label=cell_label,
                           region_offset=(r0, c0))

    def _get_new_labels(self, frame: int, n: int) -> List[int]:
        table = self.tissue.get_cells_info(frame)
        empty = np.nonzero(to_numpy(table.empty_cell) == 1)[0]
        out = [int(e) + 1 for e in empty[:n]]
        if n - len(out) > 0:
            raise ValueError("cell table capacity exhausted")
        return out

    def _refresh_rows(self, frame: int, touched_labels: List[int],
                      origin_label: int, region_offset):
        """Recompute the frame's table on the session's device, keeping the
        old track ids and types; the touched labels take the origin cell's
        type."""
        tissue = self.tissue
        old_table = tissue.get_cells_info(frame)
        old_ids = to_numpy(old_table.label).copy()
        old_types = to_numpy(old_table.type).copy()
        old_type = int(old_types[origin_label - 1])
        tissue.calculate_frame_cellinfo(frame)
        new_table = tissue.get_cells_info(frame)
        ids = to_numpy(new_table.label).copy()
        keep = old_ids > 0
        ids[keep] = old_ids[keep]
        types = old_types.copy()
        for lab in touched_labels:
            types[lab - 1] = old_type
        tissue.set_cells_info(frame, replace_fields(new_table, label=ids,
                                                    type=types))
        tissue.update_cell_types_by_cells_info(frame)

    # ------------- remove line (merge two cells)

    def remove_segmentation_line(self, frame: int, point1, part_of_undo=False) -> int:
        """Walk and delete a boundary line from the clicked point until
        junctions, then merge the two separated cells."""
        tissue = self.tissue
        labels = tissue.get_labels(frame)
        if labels is None:
            return 0
        point = find_nearest_segmentation_pixel(labels, point1, distance_limit=20)
        if point[0] is None:
            return 0
        if not part_of_undo:
            self._begin_action(frame, "remove")
        self._neighbors_labels = []
        H, W = labels.shape
        removed = []
        stack = [(int(point[0]), int(point[1]), True)]
        while stack:
            x, y, initial_point = stack.pop()
            if labels[y, x] != 0:
                continue
            labels[y, x] = -1
            removed.append((y, x))
            ys = slice(max(0, y - 1), min(y + 2, H))
            xs = slice(max(0, x - 1), min(x + 2, W))
            neighborhood = labels[ys, xs]
            unique_cells = np.unique(neighborhood[neighborhood > 0])
            zero_pos = np.argwhere(neighborhood == 0)
            zero_abs = [(ys.start + dy, xs.start + dx) for dy, dx in zero_pos]
            if initial_point or len(zero_abs) == 1:
                for cell in unique_cells:
                    if cell not in self._neighbors_labels:
                        self._neighbors_labels.append(int(cell))
                if len(self._neighbors_labels) > 2:  # reached a junction
                    labels[y, x] = 0
                    removed.pop()
                    continue
                for (ny, nx) in zero_abs:
                    stack.append((nx, ny, False))
            elif len(zero_abs) > 1:
                new_cell = any(c not in self._neighbors_labels for c in unique_cells)
                if new_cell:
                    labels[y, x] = 0
                    removed.pop()
                    continue
                ny, nx = zero_abs[0]
                stack.append((nx, ny, False))
        first = self._neighbors_labels[0] if self._neighbors_labels else 0
        second = self._neighbors_labels[1] if len(self._neighbors_labels) > 1 else first
        self._merge_cells(frame, first, second, part_of_undo)
        if not part_of_undo:
            self._commit_action()
        return 0

    def _merge_cells(self, frame: int, cell1: int, cell2: int, part_of_undo=False):
        """Merge a cell pair after a line removal."""
        tissue = self.tissue
        labels = tissue.get_labels(frame)
        if cell1 == cell2 or cell1 == 0 or cell2 == 0:
            labels[labels == -1] = cell1 if cell1 > 0 else 0
            return
        new_label = min(cell1, cell2)
        delete_label = max(cell1, cell2)
        labels[labels == delete_label] = new_label
        labels[labels == -1] = new_label
        table = tissue.get_cells_info(frame)
        if table is None:
            return
        old_ids = to_numpy(table.label).copy()
        old_types = to_numpy(table.type).copy()
        merged_type = max(old_types[cell1 - 1], old_types[cell2 - 1])
        tissue.calculate_frame_cellinfo(frame)
        new_table = tissue.get_cells_info(frame)
        ids = to_numpy(new_table.label).copy()
        keep = (old_ids > 0) & (to_numpy(new_table.empty_cell) == 0)
        ids[keep] = old_ids[keep]
        types = old_types.copy()
        types[new_label - 1] = merged_type
        types[delete_label - 1] = 0
        tissue.set_cells_info(frame, replace_fields(new_table, label=ids,
                                                    type=types))
        tissue.update_cell_types_by_cells_info(frame)

    # ------------- other edits

    def change_cell_type(self, frame: int, pos, type_name: str) -> int:
        """Toggle a type bit on the clicked cell (``"invalid"`` makes it
        invalid)."""
        tissue = self.tissue
        labels = tissue.get_labels(frame)
        x, y = int(pos[0]), int(pos[1])
        idx = int(labels[y, x]) - 1
        if idx < 0:
            return 0
        table = tissue.get_cells_info(frame)
        types = to_numpy(table.type).copy()
        valid = to_numpy(table.valid).copy()
        if type_name == "invalid":
            valid[idx] = 0
        else:
            ti = tissue.type_name_to_index(type_name)
            if not isinstance(ti, int) or ti < 0:
                tissue.type_names.append(type_name)
                ti = len(tissue.type_names) - 1
            cur = table.type[idx:idx + 1].cpu()
            pos_now = bool(is_positive_for_type(cur, ti)[0])
            types[idx] = int(change_type(cur, ti, not pos_now)[0])
            valid[idx] = 1
        tissue.set_cells_info(frame, replace_fields(table, type=types,
                                                    valid=valid))
        tissue.update_cell_types_by_cells_info(frame)
        return 0

    def make_invalid_cell(self, frame: int, pos) -> int:
        labels = self.tissue.get_labels(frame)
        x, y = int(pos[0]), int(pos[1])
        idx = int(labels[y, x]) - 1
        if idx < 0:
            return 0
        table = self.tissue.get_cells_info(frame)
        valid = to_numpy(table.valid).copy()
        valid[idx] = 0
        self.tissue.set_cells_info(frame, replace_fields(table, valid=valid))
        self.tissue.update_cell_types_by_cells_info(frame)
        return 0
