"""Session maintenance / repair utilities.

Port of ``tissue_image_processing_tpu/utils/maintenance.py``: axis flips,
type repair from the painted map, bbox / neighbour refreshes, zero and
duplicate track-id repair, invalid-cell merging and non-sensory-region
removal. The repairs read each table to the host, fix it in numpy and
write the fields back on the table's own device.
"""

from __future__ import annotations

import numpy as np
import torch

from tissue_image_processing_tpu_torch.core.cell_table import (
    is_positive_for_type, replace_fields, to_numpy)

__all__ = ["flip_frame_data", "flip_all_data", "fix_types_in_cell_info",
           "update_bounding_box_for_all_cells", "update_neighbors_for_all_cells",
           "fix_zero_labeled_cells", "fix_duplicated_label_cells_in_frame",
           "fix_duplicated_labels_in_all_frames", "detect_non_sensory_region_cells",
           "remove_cells_outside_of_sensory_region", "merge_invalid_neighboring_cells",
           "calculate_average_area_in_movie", "fix_mean_intensity"]


def flip_frame_data(tissue, frame: int) -> None:
    """Transpose X/Y of one frame's artifacts (reference ``flip_frame_data``,
    ``tissue_info.py:3837-3864``)."""
    labels = tissue.get_labels(frame)
    if labels is not None:
        tissue.set_labels(frame, labels.T)
    ct = tissue.get_cell_types(frame)
    if ct is not None:
        tissue.set_cell_types(frame, ct.T)
    table = tissue.get_cells_info(frame)
    if table is not None:
        bbox = to_numpy(table.bbox)
        flipped = bbox[:, [1, 0, 3, 2]]
        tissue.set_cells_info(frame, replace_fields(
            table, cx=table.cy, cy=table.cx, bbox=flipped))


def flip_all_data(tissue) -> None:
    """(reference ``flip_all_data``, ``tissue_info.py:3826-3835``)."""
    for frame in range(1, tissue.number_of_frames + 1):
        flip_frame_data(tissue, frame)
    tissue.drifts[:, [0, 1]] = tissue.drifts[:, [1, 0]]
    cols = ["start_pos_y", "start_pos_x", "end_pos_y", "end_pos_x",
            "daughter_pos_y", "daughter_pos_x"]
    swapped = ["start_pos_x", "start_pos_y", "end_pos_x", "end_pos_y",
               "daughter_pos_x", "daughter_pos_y"]
    if len(tissue.events):
        tissue.events.loc[:, cols] = tissue.events.loc[:, swapped].values


def fix_types_in_cell_info(tissue) -> None:
    """Repair table types by sampling the painted type map at centroids (reference
    ``fix_types_in_cell_info``, ``tissue_info.py:3866-3882``)."""
    for frame in range(1, tissue.number_of_frames + 1):
        table = tissue.get_cells_info(frame)
        ct = tissue.get_cell_types(frame)
        if table is None or ct is None:
            continue
        mask = to_numpy(table.valid_mask())
        cy = np.round(to_numpy(table.cy)[mask]).astype(int)
        cx = np.round(to_numpy(table.cx)[mask]).astype(int)
        sampled = ct[np.clip(cy, 0, ct.shape[0] - 1), np.clip(cx, 0, ct.shape[1] - 1)]
        types = to_numpy(table.type).copy()
        valid = to_numpy(table.valid).copy()
        rows = np.nonzero(mask)[0]
        good = sampled != 255
        types[rows[good]] = sampled[good]
        valid[rows[~good]] = 0
        tissue.set_cells_info(frame, replace_fields(table, type=types,
                                                    valid=valid))


def update_bounding_box_for_all_cells(tissue) -> None:
    """(reference ``tissue_info.py:4230-4241``) — recompute per-frame regionprops
    (bboxes included) while keeping track ids and types."""
    for frame in range(1, tissue.number_of_frames + 1):
        _refresh_preserving(tissue, frame)


def update_neighbors_for_all_cells(tissue) -> None:
    """(reference ``tissue_info.py:4243-4247``)."""
    for frame in range(1, tissue.number_of_frames + 1):
        _refresh_preserving(tissue, frame)


def _refresh_preserving(tissue, frame: int) -> None:
    table = tissue.get_cells_info(frame)
    if table is None or tissue.get_labels(frame) is None:
        return
    ids = to_numpy(table.label).copy()
    types = to_numpy(table.type).copy()
    tissue.calculate_frame_cellinfo(frame)
    new = tissue.get_cells_info(frame)
    keep = ids > 0
    out_ids = to_numpy(new.label).copy()
    out_ids[keep] = ids[keep]
    tissue.set_cells_info(frame, replace_fields(new, label=out_ids,
                                                type=types))


def fix_zero_labeled_cells(tissue) -> None:
    """Assign fresh track ids to label==0 cells (reference
    ``fix_zero_labeled_cells``, ``tissue_info.py:4274-4286``)."""
    for frame in range(1, tissue.number_of_frames + 1):
        table = tissue.get_cells_info(frame)
        if table is None:
            continue
        ids = to_numpy(table.label).copy()
        exists = to_numpy(table.empty_cell) == 0
        zero = exists & (ids == 0)
        if not zero.any():
            continue
        existing = np.unique(ids[ids > 0])
        new_ids = np.nonzero(zero)[0] + 1
        clash = np.isin(new_ids, existing)
        top = existing.max() if existing.size else 0
        new_ids[clash] = top + np.arange(1, clash.sum() + 1)
        ids[zero] = new_ids
        tissue.set_cells_info(frame, replace_fields(table, label=ids))


def fix_duplicated_label_cells_in_frame(tissue, frame: int) -> None:
    """Keep one cell per duplicated track id, renumber the rest (reference
    ``fix_duplicated_label_cells_in_frame``, ``tissue_info.py:4288-4310``)."""
    table = tissue.get_cells_info(frame)
    if table is None:
        return
    ids = to_numpy(table.label).copy()
    valid = to_numpy(table.valid)
    exists = to_numpy(table.empty_cell) == 0
    existing = np.unique(ids[ids > 0])
    to_update = []
    vals, counts = np.unique(ids[exists & (ids > 0)], return_counts=True)
    for lab in vals[counts > 1]:
        rows = np.nonzero(exists & (ids == lab))[0]
        valid_rows = rows[valid[rows] == 1]
        keep = valid_rows[0] if valid_rows.size else rows[0]
        to_update.extend(r for r in rows if r != keep)
    if not to_update:
        return
    to_update = np.array(to_update)
    new_ids = to_update + 1
    clash = np.isin(new_ids, existing)
    new_ids[clash] = existing.max() + np.arange(1, clash.sum() + 1)
    ids[to_update] = new_ids
    tissue.set_cells_info(frame, replace_fields(table, label=ids))


def fix_duplicated_labels_in_all_frames(tissue) -> None:
    for frame in range(1, tissue.number_of_frames + 1):
        fix_duplicated_label_cells_in_frame(tissue, frame)


def detect_non_sensory_region_cells(tissue, frame: int) -> np.ndarray:
    """Rows outside the Delaunay hull of HC cells (reference
    ``detect_non_sensory_region_cells``, ``tissue_info.py:614-620``)."""
    from scipy.spatial import Delaunay

    table = tissue.get_cells_info(frame)
    mask = to_numpy(table.valid_mask())
    hc = mask & to_numpy(is_positive_for_type(table.type, 0))
    if hc.sum() < 4:
        return np.empty((0,), int)
    pts = np.stack([to_numpy(table.cx)[hc], to_numpy(table.cy)[hc]], 1)
    hull = Delaunay(pts)
    exists = to_numpy(table.empty_cell) == 0
    all_pts = np.stack([to_numpy(table.cx), to_numpy(table.cy)], 1)
    outside = hull.find_simplex(all_pts) < 0
    return np.nonzero(outside & exists)[0]


def remove_cells_outside_of_sensory_region(tissue, frame: int) -> None:
    """(reference ``tissue_info.py:2781-2792``)."""
    rows = detect_non_sensory_region_cells(tissue, frame)
    table = tissue.get_cells_info(frame)
    valid = to_numpy(table.valid).copy()
    valid[rows] = 0
    tissue.set_cells_info(frame, replace_fields(table, valid=valid))
    tissue.update_cell_types_by_cells_info(frame)


def merge_invalid_neighboring_cells(tissue, frame: int, editor=None) -> None:
    """Remove boundary lines between adjacent invalid cells (reference
    ``merge_invalid_neighboring_cells``, ``tissue_info.py:403-417``)."""
    from scipy.ndimage import maximum_filter as ndi_max

    from tissue_image_processing_tpu_torch.core.editing import SegmentationEditor

    import warnings

    editor = editor or SegmentationEditor(tissue)
    merged_any = False
    for it in range(10000):
        labels = tissue.get_labels(frame)
        ct = tissue.get_cell_types(frame)
        if ct is None:
            tissue.update_cell_types_by_cells_info(frame)
            ct = tissue.get_cell_types(frame)
        # candidate border pixels: labels==0 surrounded by invalid-only cells
        cand = (labels == 0) & (ndi_max((ct != 255).astype(int), size=3,
                                        mode="constant") == 0)
        pts = np.argwhere(cand)
        if not len(pts):
            break
        editor.remove_segmentation_line(frame, (int(pts[0, 1]), int(pts[0, 0])))
        merged_any = True
    else:
        warnings.warn("merge_invalid_neighboring_cells: iteration cap hit; "
                      "some invalid-cell boundaries may remain unmerged")
    if merged_any:
        # refresh the painted type map after the merges (reference
        # update_labels call at tissue_info.py:417)
        tissue.update_cell_types_by_cells_info(frame)


def calculate_average_area_in_movie(tissue) -> float:
    """(reference ``calculate_average_area_in_movie``, ``tissue_info.py:3884-3896``)."""
    area = 0.0
    n = 0
    for frame in range(1, tissue.number_of_frames + 1):
        if not tissue.is_frame_valid(frame):
            continue
        table = tissue.get_cells_info(frame)
        if table is None:
            continue
        mask = to_numpy(table.valid_mask())
        area += float(to_numpy(table.area)[mask].sum())
        n += 1
    return area / max(n, 1)


def fix_mean_intensity(tissue, img: np.ndarray) -> None:
    """Recompute cached per-type mean intensities from the movie (reference
    ``fix_mean_intensity``, ``tissue_info.py:4317-4332``). img: (T, C, 1, Y, X)."""
    from tissue_image_processing_tpu_torch.ops.regionprops import regionprops

    for frame in range(1, tissue.number_of_frames + 1):
        table = tissue.get_cells_info(frame)
        labels = tissue.get_labels(frame)
        if table is None or labels is None:
            continue
        for ci, cname in enumerate(tissue.channel_names):
            if ci >= img.shape[1] or cname not in tissue.type_names:
                continue
            intensity = np.asarray(img[frame - 1, ci, 0]).T
            dev = tissue.device
            props = regionprops(
                torch.from_numpy(labels.astype(np.int32)).to(dev),
                num_labels=tissue.capacity,
                intensity=torch.from_numpy(np.ascontiguousarray(
                    intensity, np.float32)).to(dev))
            tissue._mean_intensity_cache[(frame, cname)] = to_numpy(
                props["mean_intensity"])[1:]
