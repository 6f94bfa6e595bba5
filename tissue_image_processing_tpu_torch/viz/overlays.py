"""RGB overlay renderers.

Port of ``tissue_image_processing_tpu/viz/overlays.py``. All return (3, H,
W) float host arrays, so a viewer (napari, matplotlib, an export pipeline)
can alpha-blend them over the raw channels.
"""

from __future__ import annotations

import numpy as np

from tissue_image_processing_tpu_torch.core.cell_table import (
    is_positive_for_type, to_numpy)
from tissue_image_processing_tpu_torch.core.editing import draw_disk, draw_line

__all__ = ["draw_cell_types", "draw_neighbors_connections", "draw_cell_tracking",
           "get_tracking_labels", "draw_all_cell_tracking", "draw_events",
           "draw_marking_points"]

TRACK_COLOR = (0, 1, 0)
NEIGHBORS_COLOR = (1, 1, 1)
POS_COLOR = (1, 0, 1)
NEG_COLOR = (1, 1, 0)
MARKING_COLOR = (0.5, 0.5, 0.5)
EVENTS_COLOR = {"ablation": (1, 1, 0), "division": (0, 0, 1),
                "delamination": (1, 0, 0), "differentiation": (0, 1, 1),
                "promoted differentiation": (1, 1, 1)}
TRACKING_COLOR_CYCLE = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
                        (0, 1, 1)]


def draw_cell_types(tissue, frame: int, type_name: str = ""):
    """Positive cells magenta, negative yellow (reference ``draw_cell_types``,
    ``tissue_info.py:2585-2593``)."""
    ti = tissue.type_name_to_index(type_name) if type_name else 0
    cell_types = tissue.get_cell_types(frame)
    if cell_types is None or (isinstance(ti, int) and ti < 0):
        return 0
    pos = to_numpy(is_positive_for_type(cell_types, ti))
    neg = (~pos) & (cell_types != 255)
    img = pos[None] * np.array(POS_COLOR).reshape(3, 1, 1) + \
        neg[None] * np.array(NEG_COLOR).reshape(3, 1, 1)
    return img


def draw_neighbors_connections(tissue, frame: int):
    """White lines between neighbor centroids (reference ``tissue_info.py:2595-2606``)."""
    labels = tissue.get_labels(frame)
    table = tissue.get_cells_info(frame)
    img = np.zeros(labels.shape)
    if table is None:
        return np.tile(img, (3, 1, 1))
    nbrs = to_numpy(table.neighbors)
    cx = to_numpy(table.cx)
    cy = to_numpy(table.cy)
    exists = to_numpy(table.empty_cell) == 0
    for i in np.nonzero(exists)[0]:
        for nb in nbrs[i][nbrs[i] > 0]:
            j = int(nb) - 1
            rr, cc = draw_line(int(cy[i]), int(cx[i]), int(cy[j]), int(cx[j]))
            ok = (rr >= 0) & (rr < img.shape[0]) & (cc >= 0) & (cc < img.shape[1])
            img[rr[ok], cc[ok]] = 1
    return np.tile(img, (3, 1, 1)) * np.array(NEIGHBORS_COLOR).reshape(3, 1, 1)


def draw_cell_tracking(tissue, frame: int, cell_label: int, radius: int = 5):
    """Green disk at one tracked cell (reference ``tissue_info.py:2608-2623``);
    cell_label == 0 draws every track in a color cycle."""
    if cell_label == 0:
        return draw_all_cell_tracking(tissue, frame)
    labels = tissue.get_labels(frame)
    img = np.zeros(labels.shape)
    c = tissue.get_cell_centroid_by_id(frame, cell_label)
    if c is None:
        return img[None] * np.array(TRACK_COLOR).reshape(3, 1, 1)
    rr, cc = draw_disk((c[1], c[0]), radius, shape=img.shape)
    img[rr, cc] = 1
    return img[None] * np.array(TRACK_COLOR).reshape(3, 1, 1)


def get_tracking_labels(tissue, frame: int):
    """Label map carrying track ids (reference ``get_trackking_labels``,
    ``tissue_info.py:4021-4028``)."""
    labels = tissue.get_labels(frame)
    table = tissue.get_cells_info(frame)
    if labels is None or table is None:
        return None
    lut = np.zeros((tissue.capacity + 1,), np.int64)
    lut[1:] = to_numpy(table.label)
    return lut[np.clip(labels, 0, tissue.capacity)]


def draw_all_cell_tracking(tissue, frame: int):
    """Track-id color cycle over all cells (reference ``tissue_info.py:2625-2635``)."""
    track_labels = get_tracking_labels(tissue, frame)
    ncolors = len(TRACKING_COLOR_CYCLE)
    out = np.zeros((3,) + track_labels.shape)
    palette = np.array(TRACKING_COLOR_CYCLE)
    mod = track_labels % ncolors
    for j in range(3):
        out[j] = palette[mod, j]
        out[j][track_labels == 0] = 0
    return out


def draw_events(tissue, frame: int, radius: int = 5):
    """Colored disks at event cells (reference ``draw_events``,
    ``tissue_info.py:584-607``)."""
    labels = tissue.get_labels(frame)
    if labels is None:
        return 0
    out = np.zeros((3,) + labels.shape)
    for _, event in tissue.events.iterrows():
        if not (event.start_frame <= frame <= event.end_frame):
            continue
        color = EVENTS_COLOR.get(event.type, (1, 1, 1))
        for cid in ([event.cell_id, event.daughter_id]
                    if event.type == "division" else [event.cell_id]):
            if not cid:
                continue
            c = tissue.get_cell_centroid_by_id(frame, int(cid))
            if c is None:
                continue
            rr, cc = draw_disk((c[1], c[0]), radius, shape=labels.shape)
            for i in range(3):
                out[i, rr, cc] = color[i]
    return out


def draw_marking_points(tissue, frame: int, points, radius: int = 5):
    """Grey disks at shape-fitting click points (reference ``tissue_info.py:2637-2645``)."""
    labels = tissue.get_labels(frame)
    img = np.zeros(labels.shape)
    for point in points:
        rr, cc = draw_disk((point[1], point[0]), radius, shape=img.shape)
        img[rr, cc] = 1
    return img[None] * np.array(MARKING_COLOR).reshape(3, 1, 1)
