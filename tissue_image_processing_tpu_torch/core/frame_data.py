"""Feature-name dispatch: the string feature API over the feature engine.

Port of ``tissue_image_processing_tpu/core/frame_data.py``: the feature
names the reference's GUI exposes (SPECIAL / GLOBAL / SPATIAL families)
resolve to the vectorised functions of ``core/features.py``, computed on the
session's device (a table kept on the host is copied there) and returned as
host numpy arrays, floats or DataFrames.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from tissue_image_processing_tpu_torch.core import features as F
from tissue_image_processing_tpu_torch.core.cell_table import (
    is_positive_for_type, to_numpy)

__all__ = ["get_frame_data", "get_event_statistics", "SPECIAL_FEATURES",
           "SPATIAL_FEATURES", "SPECIAL_X_ONLY_FEATURES", "GLOBAL_FEATURES",
           "COLUMN_FEATURES"]

SPECIAL_FEATURES = ["shape index", "roundness", "neighbors from the same type",
                    "HC neighbors", "SC neighbors", "HC second neighbors",
                    "SC second neighbors", "second neighbors",
                    "second neighbors from the same type", "contact length",
                    "HC contact length", "SC contact length", "Mean atoh intensity",
                    "Distance from ablation", "neighbors by type"]
SPATIAL_FEATURES = ["HC density", "SC density", "HC type_fraction", "SC type_fraction"]
SPECIAL_X_ONLY_FEATURES = ["psi6"]
GLOBAL_FEATURES = ["density", "type_fraction", "total_area", "number_of_cells",
                   "neighbors correlation", "neighbors correlation average"]
COLUMN_FEATURES = ["area", "perimeter", "label", "cx", "cy", "n_neighbors", "type",
                   "valid"]


def _hc_index(tissue) -> int:
    idx = tissue.type_name_to_index("HC")
    return idx if isinstance(idx, int) and idx >= 0 else 0


def get_frame_data(tissue, frame: int, feature: str, mask: np.ndarray,
                   intensity_img=None, window_radius: float = 200.0,
                   types: Optional[list] = None):
    """Compute ``feature`` for the masked cells of a frame. Returns (value,
    message): a numpy array of per-cell values (aligned with the mask), a
    scalar for global features, or a DataFrame for 'neighbors by type'."""
    table = tissue.get_cells_info(frame)
    if table is None:
        return None, "No frame data is available"
    dev = tissue.device   # features run on the session's device
    table = table.map(lambda t: t.to(dev))
    hc = _hc_index(tissue)
    m = to_numpy(mask).astype(bool)

    def per_cell(vals):
        return to_numpy(vals)[m]

    def on_device(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    if feature in COLUMN_FEATURES:
        return per_cell(getattr(table, feature)), ""
    if feature == "roundness":
        return per_cell(F.roundness(table)), ""
    if feature == "shape index":
        return per_cell(F.shape_index(table)), ""
    if feature == "psi6":
        vor = F.voronoi_neighbor_lists(table, m & to_numpy(
            is_positive_for_type(table.type, hc)))
        return per_cell(F.psi_n(table, on_device(vor), 6)), ""
    if feature == "HC neighbors":
        return per_cell(F.n_neighbors_from_type(table, hc, True)), ""
    if feature == "SC neighbors":
        return per_cell(F.n_neighbors_from_type(table, hc, False)), ""
    if feature == "neighbors from the same type":
        return per_cell(F.n_neighbors_from_type(table, same_type=True)), ""
    if feature == "second neighbors":
        return per_cell(F.second_order_neighbors_from_type(table, count_all=True)), ""
    if feature == "HC second neighbors":
        return per_cell(F.second_order_neighbors_from_type(table, hc, True)), ""
    if feature == "SC second neighbors":
        return per_cell(F.second_order_neighbors_from_type(table, hc, False)), ""
    if feature == "second neighbors from the same type":
        return per_cell(F.second_order_neighbors_from_type(table, count_all=True)), ""
    if feature == "neighbors by type":
        names = types or (tissue.type_names + ["all"])
        data = {}
        for name in names:
            if name == "all":
                data[name] = per_cell(F.n_neighbors_from_type(table, count_mode="all"))
            else:
                ti = tissue.type_name_to_index(name)
                data[name] = per_cell(F.n_neighbors_from_type(table, ti, True))
        return pd.DataFrame(data), ""
    if "contact length" in feature:
        contact = on_device(tissue.calc_neighbors_contact_matrix(frame))
        if "HC" in feature:
            vals = F.contact_lengths_by_type(table, contact, hc, True)
        elif "SC" in feature:
            vals = F.contact_lengths_by_type(table, contact, hc, False)
        else:
            vals = F.contact_lengths_by_type(table, contact, all_types=True)
        return per_cell(vals), ""
    if feature == "Mean atoh intensity":
        cached = tissue.get_mean_intensity(frame, "HC")
        if cached is not None:
            return cached[m], ""
        if intensity_img is None:
            return None, "No intensity image available"
        from tissue_image_processing_tpu_torch.ops.regionprops import regionprops
        props = regionprops(on_device(tissue.get_labels(frame).astype(np.int32)),
                            num_labels=tissue.capacity,
                            intensity=on_device(to_numpy(intensity_img)))
        return to_numpy(props["mean_intensity"])[1:][m], ""
    if feature == "Distance from ablation":
        abl = tissue.events.query('type == "ablation"')
        if not len(abl):
            return None, "No ablation events"
        frames = abl.start_frame.values.astype(int)
        nearest = frames[np.argmin(np.abs(frames - frame))]
        pts = abl.query(f"start_frame == {nearest}")[
            ["start_pos_y", "start_pos_x"]].values.astype(np.float32)
        return per_cell(F.distance_from_points(table, on_device(pts))), ""
    if feature in GLOBAL_FEATURES:
        if feature == "number_of_cells":
            return int(m.sum()), ""
        mask_t = on_device(m)
        if feature == "total_area":
            return float(F.total_area(table, mask_t)), ""
        if feature == "density":
            return float(F.density(table, mask_t)), ""
        if feature == "type_fraction":
            return float(F.type_fraction(table, mask_t)), ""
        method = "neighbors average" if "average" in feature else "neighbors"
        state = is_positive_for_type(table.type, hc).to(torch.float32)
        return float(F.neighbors_correlation(table, state, mask_t, method)), ""
    if feature in SPATIAL_FEATURES:
        # windowed per-cell density / fraction around each masked cell
        kind, stat = feature.split(" ")
        tm = to_numpy(is_positive_for_type(table.type, hc))
        tm = tm if kind == "HC" else ~tm
        valid = tissue.get_valid_non_edge_mask(frame)
        cy = to_numpy(table.cy)
        cx = to_numpy(table.cx)
        area = to_numpy(table.area)
        out = np.zeros(int(m.sum()))
        rows = np.nonzero(m)[0]
        for k, i in enumerate(rows):
            inside = valid & ((cy - cy[i]) ** 2 + (cx - cx[i]) ** 2 < window_radius ** 2)
            sel = inside & tm
            if stat == "density":
                tot = area[inside].sum()
                out[k] = sel.sum() / tot if tot > 0 else 0.0
            else:
                cnt = inside.sum()
                out[k] = sel.sum() / cnt if cnt > 0 else 0.0
        return out, ""
    if ":" in feature:
        shape_name, shape_feature = feature.split(":")
        results = tissue.shape_fitting_results[frame - 1]
        if shape_name in results:
            return tuple(results[shape_name][shape_feature]), ""
    return None, f"Not implemented: {feature}"


def get_event_statistics(tissue, event_type: str, x_feature: str,
                         y_feature: Optional[str] = None,
                         frame: Optional[int] = None,
                         window_radius: float = 200.0) -> Optional[pd.DataFrame]:
    """Per-event (or reference-population) feature table."""
    hc = _hc_index(tissue)
    if "reference" in event_type:
        if frame is None or tissue.get_cells_info(frame) is None:
            return None
        table = tissue.get_cells_info(frame)
        mask = tissue.get_valid_non_edge_mask(frame)
        tm = to_numpy(is_positive_for_type(table.type, hc))
        mask = mask & (tm if "SC" not in event_type else ~tm)
        xd, _ = get_frame_data(tissue, frame, x_feature, mask,
                               window_radius=window_radius)
        res = {"event type": event_type, x_feature: xd}
        if y_feature:
            yd, _ = get_frame_data(tissue, frame, y_feature, mask,
                                   window_radius=window_radius)
            res[y_feature] = yd
        return pd.DataFrame(res)
    events = tissue.events.query(f'type == "{event_type}"')
    if not len(events):
        return None
    if x_feature == "timing histogram":
        return pd.DataFrame({"event type": event_type,
                             "timing": events.significant_frame.values.astype(float)})
    rows = []
    for _, ev in events.iterrows():
        f = int(ev.significant_frame) or int(ev.start_frame)
        table = tissue.get_cells_info(f)
        if table is None:
            continue
        mask = (to_numpy(table.label) == ev.cell_id) & to_numpy(table.valid_mask())
        if not mask.any():
            continue
        xd, _ = get_frame_data(tissue, f, x_feature, mask,
                               window_radius=window_radius)
        row = {"event type": event_type,
               x_feature: float(np.atleast_1d(xd)[0]) if xd is not None else np.nan}
        if y_feature:
            yd, _ = get_frame_data(tissue, f, y_feature, mask,
                                   window_radius=window_radius)
            row[y_feature] = float(np.atleast_1d(yd)[0]) if yd is not None else np.nan
        rows.append(row)
    return pd.DataFrame(rows) if rows else None
