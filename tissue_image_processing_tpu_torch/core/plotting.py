"""Analysis plotting: the GUI plot windows as library functions.

Port of ``tissue_image_processing_tpu/core/plotting.py``: single-cell time
series, event-related traces, per-frame scatter / histogram, frame
comparisons and spatial maps, each drawing onto a supplied matplotlib axis
and returning its data. matplotlib itself is imported only where a function
needs it (``plot_spatial_map``'s colour map), so the module imports on a
machine without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import pandas as pd

from tissue_image_processing_tpu_torch.core.cell_table import (
    is_positive_for_type, to_numpy)
from tissue_image_processing_tpu_torch.core.frame_data import get_frame_data

__all__ = ["get_single_cell_data", "plot_single_cell_data",
           "plot_event_related_data", "plot_single_frame_data",
           "plot_compare_frames_data", "plot_spatial_map",
           "save_figure_with_data"]


def get_single_cell_data(tissue, cell_id: int, frames: Sequence[int], feature: str,
                         window_radius: float = 0.0):
    """Per-frame feature values of one tracked cell (reference
    ``get_single_cell_data``, ``tissue_info.py:933-954``)."""
    data = np.full(len(frames), np.nan)
    msg = ""
    for i, frame in enumerate(frames):
        if not tissue.is_frame_valid(frame):
            msg += f"frame {frame} is invalid\n"
            continue
        table = tissue.get_cells_info(frame)
        if table is None:
            continue
        mask = (to_numpy(table.label) == cell_id) & to_numpy(table.valid_mask())
        if not mask.any():
            continue
        vals, m = get_frame_data(tissue, frame, feature, mask,
                                 window_radius=window_radius)
        if vals is None:
            return None, m
        data[i] = float(np.atleast_1d(vals)[0])
    return data, msg


def plot_single_cell_data(tissue, cell_id: int, feature: str, ax,
                          frame_interval_min: float = 15.0):
    """(reference ``plot_single_cell_data``, ``tissue_info.py:921-931``)."""
    frames = np.arange(1, tissue.number_of_frames + 1)
    t = (frames - 1) * frame_interval_min
    data, msg = get_single_cell_data(tissue, cell_id, frames, feature)
    keep = ~np.isnan(data)
    ax.plot(t[keep], data[keep], "*")
    ax.set_xlabel("Time (minutes)")
    ax.set_ylabel(feature)
    ax.set_title(f"{feature} of cell number {cell_id}")
    return pd.DataFrame({"Time": t[keep], feature: data[keep]})


def plot_event_related_data(tissue, cell_id: int, event_frame: int, feature: str,
                            frames_around_event: int, ax,
                            frame_interval_min: float = 15.0):
    """(reference ``plot_event_related_data``, ``tissue_info.py:956-989``)."""
    ev = tissue.events.query(
        f"cell_id == {cell_id} and start_frame <= {event_frame} <= end_frame")
    if not len(ev):
        return None
    frames = np.arange(max(event_frame - frames_around_event, 1),
                       min(event_frame + frames_around_event + 1,
                           tissue.number_of_frames + 1))
    t = (frames - 1) * frame_interval_min
    data, _ = get_single_cell_data(tissue, cell_id, frames, feature)
    keep = ~np.isnan(data)
    before = keep & (frames < event_frame)
    after = keep & (frames >= event_frame)
    ax.plot(t[before], data[before], "b*", label="before event")
    ax.plot(t[after], data[after], "g*", label="after event")
    res = {"Time": t[keep], feature: data[keep],
           "Event type": [ev.type.values[0]] * int(keep.sum()),
           "Cell ID": [cell_id] * int(keep.sum())}
    if ev.type.values[0] == "division" and int(ev.daughter_id.values[0]) > 0:
        did = int(ev.daughter_id.values[0])
        dframes = np.arange(event_frame, frames[-1] + 1)
        ddata, _ = get_single_cell_data(tissue, did, dframes, feature)
        dk = ~np.isnan(ddata)
        ax.plot((dframes[dk] - 1) * frame_interval_min, ddata[dk], "r*",
                label="daughter cell after event")
    ax.set_xlabel("Time (minutes)")
    ax.set_ylabel(feature)
    ax.legend()
    return pd.DataFrame(res)


def _typed_mask(tissue, frame: int, cells_type: str, positive_for_type: bool):
    mask = tissue.get_valid_non_edge_mask(frame)
    if cells_type != "all":
        table = tissue.get_cells_info(frame)
        ti = tissue.type_name_to_index(cells_type)
        tm = to_numpy(is_positive_for_type(table.type, ti))
        mask = mask & (tm if positive_for_type else ~tm)
    return mask


def plot_single_frame_data(tissue, frame: int, x_feature: str, y_feature: str, ax,
                           cells_type: str = "all", positive_for_type: bool = True):
    """Scatter / histogram of per-cell features for one frame (reference
    ``plot_single_frame_data``, ``tissue_info.py:1269-1317``)."""
    mask = _typed_mask(tissue, frame, cells_type, positive_for_type)
    x_data, msg = get_frame_data(tissue, frame, x_feature, mask)
    if x_data is None:
        return None, msg
    if y_feature == "histogram":
        if isinstance(x_data, pd.DataFrame):
            for col in x_data.columns:
                ax.hist(x_data[col], alpha=0.5, label=str(col))
            ax.legend()
            res = x_data.assign(Frame=frame)
        else:
            ax.hist(np.asarray(x_data, float))
            res = pd.DataFrame({"Frame": frame, x_feature: np.asarray(x_data, float)})
        ax.set_xlabel(x_feature)
        ax.set_ylabel("frequency")
        return res, ""
    y_data, msg = get_frame_data(tissue, frame, y_feature, mask)
    if y_data is None:
        return None, msg
    ax.plot(np.asarray(x_data, float), np.asarray(y_data, float), "*")
    ax.set_xlabel(x_feature)
    ax.set_ylabel(y_feature)
    return pd.DataFrame({"Frame": frame, x_feature: np.asarray(x_data, float),
                         y_feature: np.asarray(y_data, float)}), ""


def plot_compare_frames_data(tissue, frames: Sequence[int], feature: str, ax,
                             cells_type: str = "all",
                             positive_for_type: bool = True):
    """Bar chart of a feature across frames (reference
    ``plot_compare_frames_data``, ``tissue_info.py:1356-1412``)."""
    data, err, ns, used = [], [], [], []
    for frame in frames:
        if not tissue.is_frame_valid(frame) or tissue.get_cells_info(frame) is None:
            continue
        mask = _typed_mask(tissue, frame, cells_type, positive_for_type)
        raw, msg = get_frame_data(tissue, frame, feature, mask)
        if raw is None:
            return None, msg
        arr = np.atleast_1d(np.asarray(raw, float))
        used.append(frame)
        data.append(arr.mean())
        err.append(arr.std() / np.sqrt(arr.size) if arr.size > 1 else 0.0)
        ns.append(arr.size)
    x = np.arange(len(used))
    ax.bar(x, data, yerr=err, align="center", alpha=0.5, ecolor="black", capsize=10)
    ax.set_xticks(x)
    ax.set_xticklabels([f"frame {f} (N = {n})" for f, n in zip(used, ns)])
    ax.set_ylabel(feature)
    return pd.DataFrame({"Frame": used, feature + " average": data,
                         feature + " se": err, "N": ns}), ""


def plot_spatial_map(tissue, frame: int, feature: str, window_radius: float,
                     window_step: int, ax, cells_type: str = "all",
                     positive_for_type: bool = True, vmin=None, vmax=None):
    """Masked RdBu spatial map (reference ``plot_spatial_map``,
    ``tissue_info.py:1337-1354``)."""
    import copy as _copy

    import matplotlib.cm as colormap
    import torch

    from tissue_image_processing_tpu_torch.core import features as F

    table = tissue.get_cells_info(frame)
    labels = tissue.get_labels(frame)
    mask = _typed_mask(tissue, frame, cells_type, positive_for_type)
    vals, msg = get_frame_data(tissue, frame, feature, np.ones_like(mask))
    if vals is None:
        return None, msg
    kind = "fraction" if "fraction" in feature else \
        "density" if "density" in feature else "mean"
    dev = tissue.device
    m = to_numpy(F.spatial_map(
        table.map(lambda t: t.to(dev)), labels.shape, window_radius, window_step,
        torch.from_numpy(np.asarray(vals, np.float32)).to(dev),
        torch.from_numpy(np.asarray(mask)).to(dev), feature=kind))
    palette = _copy.copy(colormap.RdBu)
    palette.set_bad("k")
    palette.set_under("k")
    if "fraction" in feature:
        vmin, vmax = 0, 1
    if vmin is None:
        vmin = m[m > 0].min() if (m > 0).any() else 0
    if vmax is None:
        vmax = m[m > 0].max() if (m > 0).any() else 1
    masked = np.ma.masked_where(labels == 0, m)
    im = ax.imshow(masked, cmap=palette, vmin=vmin, vmax=vmax)
    ax.figure.colorbar(im, ax=ax)
    return m, ""


def save_figure_with_data(fig, path: str, data=None, data_format: str = "auto"):
    """Save a figure AND its underlying data next to it — the library
    counterpart of the reference's plot-window save toolbar, which pickles or
    CSVs the plotted DataFrame alongside the image (``gui.py:62-91``).

    ``data``: DataFrame / ndarray / dict. ``data_format``: "csv", "pickle", or
    "auto" (csv for DataFrame/ndarray, pickle for dict). Returns the data path
    (or None when no data was given).
    """
    import os
    import pickle

    fig.savefig(path)
    if data is None:
        return None
    base = os.path.splitext(path)[0]
    fmt = data_format
    if fmt == "auto":
        fmt = "pickle" if isinstance(data, dict) else "csv"
    if fmt == "csv":
        data_path = base + "_data.csv"
        if isinstance(data, pd.DataFrame):
            data.to_csv(data_path)
        elif isinstance(data, np.ndarray):
            pd.DataFrame(data).to_csv(data_path)
        else:
            with open(data_path, "w") as f:
                import csv
                w = csv.writer(f)
                for k, v in data.items():
                    w.writerow([k, v])
    else:
        if isinstance(data, pd.DataFrame):
            data_path = base + "_data.pkl"
            data.to_pickle(data_path)
        elif isinstance(data, np.ndarray):
            data_path = base + "_data.npy"
            np.save(data_path, data)
        else:
            data_path = base + "_data.pkl"
            with open(data_path, "wb") as f:
                pickle.dump(data, f)
    return data_path
