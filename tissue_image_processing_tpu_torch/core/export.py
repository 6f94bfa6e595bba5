"""Exporters: matlab / tiff / npy / tabular outputs.

Port of ``tissue_image_processing_tpu/core/export.py``: tracked label maps
through a look-up table, multi-channel TIFFs of labels and types, matlab
structs, per-frame simulation bundles (labels, contact matrix and the
renamed table) and cross-feature event-statistics dumps, all written from
host arrays. ``write_table`` writes Excel when openpyxl is there, CSV
otherwise.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from tissue_image_processing_tpu_torch.viz.overlays import get_tracking_labels

__all__ = ["export_segmentation_to_matlab", "export_segmentation_to_tiff",
           "export_segmentation_and_cell_types_to_tiff", "export_segmentation_to_npy",
           "save_frame_data_for_simulation", "save_event_statistics_data",
           "write_table"]


def write_table(df, path: str) -> str:
    """Excel if openpyxl is available, CSV otherwise; returns the path written."""
    if path.endswith(".xlsx"):
        try:
            df.to_excel(path, index=False)
            return path
        except Exception:
            path = path.replace(".xlsx", ".csv")
    df.to_csv(path, index=False)
    return path


def export_segmentation_to_matlab(tissue, outfolder: str, filename: str) -> int:
    """(reference ``tissue_info.py:4030-4038``)."""
    from scipy.io import savemat

    out = {}
    for frame in range(1, tissue.number_of_frames + 1):
        labels = get_tracking_labels(tissue, frame)
        if labels is not None:
            out["frame%d" % frame] = labels.astype("uint16")
    out["valid_frames"] = tissue.valid_frames
    out["number_of_frames"] = tissue.number_of_frames
    savemat(os.path.join(outfolder, filename + ".mat"), out)
    return 0


def export_segmentation_to_tiff(tissue, outfolder: str, filename: str) -> int:
    """(reference ``tissue_info.py:4054-4062``)."""
    from tissue_image_processing_tpu_torch.io.tiff import save_tiff

    shape = None
    for f in range(1, tissue.number_of_frames + 1):
        if tissue.get_labels(f) is not None:
            shape = tissue.get_labels(f).shape
            break
    out = np.zeros((tissue.number_of_frames, 1, 1) + shape, dtype="uint16")
    for frame in range(1, tissue.number_of_frames + 1):
        if tissue.is_frame_valid(frame) and tissue.get_labels(frame) is not None:
            out[frame - 1, 0, 0] = tissue.get_labels(frame).astype("uint16")
    save_tiff(os.path.join(outfolder, filename + ".tif"), out, axes="TCZYX",
              data_type="uint16")
    return 0


def export_segmentation_and_cell_types_to_tiff(tissue, outfolder: str,
                                               filename: str) -> int:
    """Two channels: tracked labels + remapped type map (reference
    ``tissue_info.py:4040-4052``: 0 -> 2, 255 -> 0)."""
    from tissue_image_processing_tpu_torch.io.tiff import save_tiff

    shape = None
    for f in range(1, tissue.number_of_frames + 1):
        if tissue.get_labels(f) is not None:
            shape = tissue.get_labels(f).shape
            break
    out = np.zeros((tissue.number_of_frames, 2, 1) + shape, dtype="uint16")
    for frame in range(1, tissue.number_of_frames + 1):
        if not tissue.is_frame_valid(frame):
            continue
        labels = get_tracking_labels(tissue, frame)
        if labels is None:
            continue
        out[frame - 1, 0, 0] = labels.astype("uint16")
        ct = tissue.get_cell_types(frame)
        if ct is not None:
            ct = ct.astype("uint16").copy()
            ct[ct == 0] = 2
            ct[ct == 255] = 0
            out[frame - 1, 1, 0] = ct
    save_tiff(os.path.join(outfolder, filename + ".tif"), out, axes="TCZYX",
              data_type="uint16")
    return 0


def export_segmentation_to_npy(tissue, outfolder: str, filename: str) -> int:
    """(reference ``tissue_info.py:4064-4071``)."""
    out = []
    for frame in range(1, tissue.number_of_frames + 1):
        labels = get_tracking_labels(tissue, frame)
        out.append(labels.astype("uint16") if labels is not None else None)
    out = np.array([o for o in out if o is not None]).astype("uint16")
    np.save(os.path.join(outfolder, filename), out)
    return 0


def save_frame_data_for_simulation(tissue, frame: int,
                                   outdir: Optional[str] = None) -> int:
    """Per-frame simulation bundle: labels + contact matrix + renamed cell table
    (reference ``save_frame_data_for_simulation``, ``tissue_info.py:4127-4145``)."""
    outdir = outdir or os.path.dirname(tissue.data_path) or "."
    movie_name = os.path.basename(tissue.data_path).replace(".tif", "")
    labels = tissue.get_labels(frame)
    table = tissue.get_cells_info(frame)
    df = table.to_pandas()
    df["valid"] = ((df["valid"] == 1) & (df["empty_cell"] == 0)).astype(int)
    df = df.drop(columns="empty_cell")
    df = df.rename(columns={"label": "cell_id"})
    df["label"] = np.arange(1, len(df) + 1)
    edge = np.zeros(len(df))
    edge_rows = tissue.detect_edge_cells(frame)
    edge[edge_rows[edge_rows < len(df)]] = 1
    df["edge_cell"] = edge
    contact = tissue.calc_neighbors_contact_matrix(frame)
    np.save(os.path.join(outdir, f"{movie_name}_contact_matrix_frame_{frame}"), contact)
    np.save(os.path.join(outdir, f"{movie_name}_labels_frame_{frame}"), labels)
    df.to_pickle(os.path.join(outdir, f"{movie_name}_cells_info_frame_{frame}"))
    return 0


EVENT_STAT_FEATURES = [("area", "roundness"), ("HC contact length", "SC contact length"),
                       ("HC density", "HC type_fraction"), ("HC neighbors", "SC neighbors"),
                       ("n_neighbors",), ("perimeter",), ("timing histogram",)]
EVENT_STAT_LABELS = ["area_and_roundness", "contact_length_by_type",
                     "HC_density_and_fraction", "neighbors_by_type",
                     "number_of_neighbors", "perimeter", "timing"]


def save_event_statistics_data(tissue, ref_frames: List[int], output_dir: str) -> int:
    """Batch export of per-event-type feature tables (reference
    ``save_event_statistics_data``, ``tissue_info.py:3898-3951``); data pickles only
    (plots are a viewer concern)."""
    from tissue_image_processing_tpu_torch.core.frame_data import get_event_statistics

    os.makedirs(output_dir, exist_ok=True)
    event_types = ["division", "delamination", "differentiation",
                   "overall reference SC", "overall reference HC"]
    event_labels = ["division", "delamination", "differentiation",
                    "reference_SC", "reference_HC"]
    for event_type, event_label in zip(event_types, event_labels):
        for feature, feature_label in zip(EVENT_STAT_FEATURES, EVENT_STAT_LABELS):
            x_feature = feature[0]
            y_feature = feature[1] if len(feature) > 1 else None
            if "reference" in event_type:
                if x_feature == "timing histogram":
                    continue
                for frame in ref_frames:
                    res = get_event_statistics(tissue, event_type, x_feature,
                                               y_feature, frame=frame)
                    if res is not None:
                        res.to_pickle(os.path.join(
                            output_dir, f"{feature_label}_{event_label}_frame{frame}_data"))
            else:
                res = get_event_statistics(tissue, event_type, x_feature, y_feature)
                if res is not None:
                    res.to_pickle(os.path.join(
                        output_dir, f"{feature_label}_{event_label}_data"))
    return 0
