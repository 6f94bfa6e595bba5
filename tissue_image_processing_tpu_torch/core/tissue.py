"""The Tissue session: per-frame artifacts, persistence, and the analysis API.

Port of ``tissue_image_processing_tpu/core/tissue.py``. Artifacts per frame
are (label map, cell-types map, ``CellTable``): the maps are host numpy
arrays, the tables tensors where they were made — on the session's
``device`` (``None``: the card) when the session computes them, on the host
when a caller hands host tables in (``apply_track_ids`` and every later
rewrite keep a table's residency). The per-pixel and per-cell work (tables,
cell types, contacts, drifts, tracking) runs on the session's device.
Persistence is the ``.seg`` archive: a working
directory of ``frame_N_labels.npy`` / ``frame_N_types.npy`` /
``frame_N_data.pkl`` (pandas pickles of ``CellTable.to_pandas``) plus
``events_data.pkl``, ``drifts.npy``, ``valid_frames.npy``,
``shape_fitting_data.json``, ``cell_type_names.pkl``, ``channel_names.pkl``
and ``fake_channels.pkl``, zipped. Only numpy, pandas and Python objects are
pickled, never a tensor, so an archive written by the JAX package loads here
and one written here loads there.
"""

from __future__ import annotations

import ast
import json
import os
import pickle
import shutil
import tempfile
import time
import weakref
import zipfile
from typing import Dict, Iterator, List, Optional

import numpy as np
import pandas as pd
import torch

from tissue_image_processing_tpu_torch._device import resolve_device
from tissue_image_processing_tpu_torch.core.cell_table import (
    CellTable, frame_cellinfo, frame_cellinfo_checked, INVALID_TYPE_INDEX,
    change_type, replace_fields, to_numpy)
from tissue_image_processing_tpu_torch.ops.percentile import (
    segment_percentile, percentile)
from tissue_image_processing_tpu_torch.ops.regionprops import regionprops
from tissue_image_processing_tpu_torch.ops.neighbors import (
    contact_length_matrix, contact_length_matrix_checked)
from tissue_image_processing_tpu_torch.ops.filters import gaussian_blur
from tissue_image_processing_tpu_torch.ops.morphology import maximum_filter

__all__ = ["Tissue", "EVENTS_INFO_SPEC", "EVENT_TYPES", "get_temp_directory",
           "pack_archive_with_progress", "unpack_archive_with_progress"]

EVENTS_INFO_SPEC = {
    "type": "TBA", "start_frame": 0, "end_frame": 0, "start_pos_x": 0,
    "start_pos_y": 0, "end_pos_x": 0, "end_pos_y": 0, "daughter_pos_x": 0,
    "daughter_pos_y": 0, "cell_id": 0, "daughter_id": 0, "significant_frame": 0,
    "source": "manual",
}

EVENT_TYPES = ["ablation", "division", "delamination", "differentiation",
               "promoted differentiation"]


def get_temp_directory(name: str) -> str:
    """Fresh scratch directory for per-frame swap files, BESIDE the data
    (swap files scale with the movie), falling back to the system temp root
    when that location is not writable. Sibling scratch directories whose
    owning process is dead are swept first; the new one carries its
    owner's pid, and ``Tissue`` registers a finalizer that removes it."""
    prefix = os.path.basename(str(name)) or "session"
    parent = os.path.dirname(os.path.abspath(str(name)))
    _sweep_orphan_temp_dirs(parent, prefix)
    try:
        wd = tempfile.mkdtemp(prefix=f"{prefix}_temp", dir=parent)
    except OSError:
        wd = tempfile.mkdtemp(prefix=f"{prefix}_temp")
    try:  # ownership marker: lets the NEXT session sweep us if we are killed
        with open(os.path.join(wd, _PID_MARKER), "w") as f:
            f.write(str(os.getpid()))
    except OSError:
        pass
    return wd


_PID_MARKER = ".owner.pid"  # never packed into .seg archives


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True
    return True


def _sweep_orphan_temp_dirs(parent: str, prefix: str) -> None:
    """Remove sibling scratch dirs whose owning process is dead; dirs
    without a pid marker are left alone."""
    try:
        entries = os.listdir(parent)
    except OSError:
        return
    for entry in entries:
        if not entry.startswith(f"{prefix}_temp"):
            continue
        d = os.path.join(parent, entry)
        try:
            with open(os.path.join(d, _PID_MARKER)) as f:
                pid = int(f.read().strip())
        except (OSError, ValueError):
            continue
        if pid != os.getpid() and not _pid_alive(pid):
            shutil.rmtree(d, ignore_errors=True)


def pack_archive_with_progress(dirname: str, zipname: str) -> Iterator[float]:
    """Zip a directory, yielding percent progress. The scratch dir's pid
    marker is never archived."""
    files = []
    total = 0
    for root, _, names in os.walk(dirname):
        for fname in names:
            if fname == _PID_MARKER:
                continue
            path = os.path.join(root, fname)
            files.append(path)
            total += os.path.getsize(path)
    current = 0
    with zipfile.ZipFile(zipname, "w", zipfile.ZIP_DEFLATED) as z:
        for path in files:
            yield 100 * current / max(total, 1)
            z.write(path, arcname=os.path.basename(path))
            current += os.path.getsize(path)


def unpack_archive_with_progress(source: str, target: str) -> Iterator[float]:
    with zipfile.ZipFile(source, "r") as zip_ref:
        names = zip_ref.namelist()
        for index, file in enumerate(names):
            zip_ref.extract(file, target)
            yield 100 * index / max(len(names), 1)


# vote-run capacity of the compacted adjacency; calculate_frame_cellinfo
# recomputes with the exact scatter when the overflow flag says a frame
# exceeds it
_NEIGHBOR_COMPACT_K = 192


class Tissue:
    """Session state for one movie's analysis. ``device``: where the
    session computes (``None``: the CUDA card, which must exist)."""

    CELL_TYPES = ["all"]
    FITTING_SHAPES = ["ellipse", "circle", "circle arc", "line", "spline"]
    EVENT_TYPES = EVENT_TYPES

    def __init__(self, number_of_frames: int, data_path: str,
                 channel_names: Optional[List[str]] = None,
                 max_cell_area: float = 10.0, min_cell_area: float = 0.1,
                 capacity: int = 4096, max_neighbors: int = 64,
                 use_working_dir: bool = False, device=None):
        self.device = resolve_device(device)
        self.number_of_frames = number_of_frames
        self.data_path = data_path
        self.channel_names = list(channel_names or [])
        self.type_names: List[str] = []
        self.fake_channels: List[int] = []
        self.max_cell_area = max_cell_area
        self.min_cell_area = min_cell_area
        self.capacity = capacity
        self.max_neighbors = max_neighbors
        self.events = pd.DataFrame(columns=list(EVENTS_INFO_SPEC.keys()))
        self.drifts = np.zeros((number_of_frames, 2))
        self.valid_frames = np.ones((number_of_frames,), int)
        self.shape_fitting_results: List[Dict] = [dict() for _ in range(number_of_frames)]
        self.cells_number = 0
        self._cells_number_dirty = True
        self._labels: List[Optional[np.ndarray]] = [None] * number_of_frames
        self._cell_types: List[Optional[np.ndarray]] = [None] * number_of_frames
        self._tables: List[Optional[CellTable]] = [None] * number_of_frames
        self._mean_intensity_cache: Dict = {}
        self.working_dir = None
        # out-of-core mode: at most ONE frame of each artifact lives in RAM;
        # frame switches flush-then-load through the working dir.
        # _mem[kind] = 0-based frame currently in memory.
        self._swap = bool(use_working_dir)
        self._mem = {"labels": -1, "types": -1, "data": -1}
        self._wd_finalizer = None
        if use_working_dir:
            self._set_working_dir(get_temp_directory(data_path))
        self.stage_locations = self.load_stage_locations()
        self.height_maps = self.load_height_map()

    def _set_working_dir(self, wd: str):
        """Adopt a scratch dir and (re)register the exit/GC sweeper for it."""
        if self._wd_finalizer is not None:
            self._wd_finalizer.detach()
        self.working_dir = wd
        self._wd_finalizer = weakref.finalize(
            self, shutil.rmtree, wd, ignore_errors=True)

    def _check(self, frame: int):
        if not (1 <= frame <= self.number_of_frames):
            raise IndexError(f"frame {frame} out of range")

    # -- out-of-core swap machinery (active when use_working_dir=True) --------

    _KIND_STORE = {"labels": "_labels", "types": "_cell_types", "data": "_tables"}
    _KIND_FILE = {"labels": "frame_{}_labels.npy", "types": "frame_{}_types.npy",
                  "data": "frame_{}_data.pkl"}

    def _artifact_path(self, kind: str, i: int) -> str:
        return os.path.join(self._ensure_working_dir(),
                            self._KIND_FILE[kind].format(i + 1))

    def _write_artifact(self, kind: str, i: int, value, retries: int = 5):
        """Write one artifact, retrying an OSError up to ``retries`` times."""
        path = self._artifact_path(kind, i)
        for attempt in range(retries):
            try:
                if kind == "data":
                    value.to_pandas().to_pickle(path)
                else:
                    np.save(path, value)
                return
            except OSError:
                if attempt == retries - 1:
                    raise
                time.sleep(1.0)

    def _read_artifact(self, kind: str, i: int):
        path = self._artifact_path(kind, i)
        if kind == "data":
            # swap only the extension: a working dir whose NAME contains "pkl"
            # must not perturb the legacy-h5 probe path
            h5_path = os.path.splitext(path)[0] + ".h5"
            if os.path.isfile(path):
                df = pd.read_pickle(path)
            elif os.path.isfile(h5_path):
                # h5-era frame data: string-encoded neighbour sets
                df = self._read_legacy_h5(h5_path)
            else:
                return None
            if len(df) and isinstance(df["type"].iloc[0], str):
                # legacy single-type format
                df = df.replace({"HC": 1, "SC": 0, "invalid": 0})
            return CellTable.from_pandas(df, capacity=self.capacity,
                                         max_neighbors=self.max_neighbors,
                                         device=self.device)
        if not os.path.isfile(path):
            return None
        # no format migration here: swap-mode round trips of our own writes
        # are the identity; legacy archives are migrated once, at load()
        return np.load(path)

    @staticmethod
    def _read_legacy_h5(path: str) -> pd.DataFrame:
        df = pd.read_hdf(path, key="df")  # needs pytables; clear error if absent

        def parse_neighbors(x):
            if not isinstance(x, str):
                return x
            if x == "set()":
                return set()
            return ast.literal_eval(
                x.replace("np.int64(", "").replace(")", ""))

        if "neighbors" in df.columns:
            df["neighbors"] = df["neighbors"].apply(parse_neighbors)
        return df

    def _swap_to(self, kind: str, i: int):
        """Make frame ``i`` the (single) in-memory frame for ``kind``."""
        store = getattr(self, self._KIND_STORE[kind])
        cur = self._mem[kind]
        if cur == i:
            return
        if cur >= 0 and store[cur] is not None:
            self._write_artifact(kind, cur, store[cur])
            store[cur] = None
        store[i] = self._read_artifact(kind, i)
        self._mem[kind] = i

    def _drop_artifact(self, kind: str, i: int):
        store = getattr(self, self._KIND_STORE[kind])
        store[i] = None
        if self._mem[kind] == i:
            self._mem[kind] = -1
        # remove any flushed copy so a later save() cannot resurrect stale data
        if self.working_dir:
            path = os.path.join(self.working_dir,
                                self._KIND_FILE[kind].format(i + 1))
            if os.path.isfile(path):
                os.remove(path)

    # -- frame artifact accessors (1-based frames) ------------------------------

    def get_labels(self, frame: int) -> Optional[np.ndarray]:
        self._check(frame)
        if self._swap:
            self._swap_to("labels", frame - 1)
        return self._labels[frame - 1]

    def set_labels(self, frame: int, labels, reset_data: bool = False):
        self._check(frame)
        if self._swap:
            self._swap_to("labels", frame - 1)
        self._labels[frame - 1] = to_numpy(labels)
        if reset_data:
            self._drop_artifact("data", frame - 1)
            self._drop_artifact("types", frame - 1)

    def get_cell_types(self, frame: int) -> Optional[np.ndarray]:
        self._check(frame)
        if self._swap:
            self._swap_to("types", frame - 1)
        return self._cell_types[frame - 1]

    def set_cell_types(self, frame: int, cell_types):
        self._check(frame)
        if self._swap:
            self._swap_to("types", frame - 1)
        self._cell_types[frame - 1] = to_numpy(cell_types)

    def get_cells_info(self, frame: int) -> Optional[CellTable]:
        self._check(frame)
        if self._swap:
            self._swap_to("data", frame - 1)
        return self._tables[frame - 1]

    def set_cells_info(self, frame: int, table: CellTable):
        self._check(frame)
        if self._swap:
            self._swap_to("data", frame - 1)
        self._tables[frame - 1] = table
        self._cells_number_dirty = True

    def is_frame_valid(self, frame: int) -> bool:
        return bool(self.valid_frames[frame - 1] == 1) if 1 <= frame <= self.number_of_frames else False

    def set_validity_of_frame(self, frame: int, valid: bool = True):
        self.valid_frames[frame - 1] = int(valid)

    def get_number_of_valid_frames(self) -> int:
        return int(np.sum(self.valid_frames))

    def is_segmented(self, frame: int) -> bool:
        return self.get_labels(frame) is not None

    def is_analyzed(self, frame: int) -> bool:
        return self.get_cells_info(frame) is not None

    def get_segmentation(self, frame: int) -> Optional[np.ndarray]:
        labels = self.get_labels(frame)
        return None if labels is None else (labels == 0).astype(int)

    # ---------------- segmentation + per-frame analysis

    def _labels_on_device(self, labels: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(labels.astype(np.int32)).to(self.device)

    def calculate_frame_cellinfo(self, frame: int) -> int:
        """Region properties and neighbours of one frame on the session's
        device: the compacted adjacency with its overflow flag (one host read
        of it), and the exact scatter when the flag is set."""
        labels = self.get_labels(frame)
        if labels is None:
            return 0
        overflow = int(labels.max()) - self.capacity
        if overflow > 0:
            import warnings
            warnings.warn(
                f"frame {frame}: {overflow} labels beyond capacity "
                f"{self.capacity} are dropped to background; re-create the "
                f"Tissue with a larger capacity")
        lab_dev = self._labels_on_device(labels)
        kw = dict(capacity=self.capacity, max_neighbors=self.max_neighbors,
                  min_cell_area=self.min_cell_area,
                  max_cell_area=self.max_cell_area)
        table, overflow = frame_cellinfo_checked(
            lab_dev, neighbor_compact_k=_NEIGHBOR_COMPACT_K, **kw)
        if bool(overflow):
            table = frame_cellinfo(lab_dev, **kw)
        old = self.get_cells_info(frame)
        if old is not None:   # a recomputed frame keeps its table's residency
            table = table.map(lambda t: t.to(old.area.device))
        self.set_cells_info(frame, table)
        return 0

    def type_name_to_index(self, type_name: str):
        if type_name in self.type_names:
            return self.type_names.index(type_name)
        if "pos" in type_name or "neg" in type_name:
            types_list = (ast.literal_eval(type_name)
                          if type_name.startswith("(") else (type_name,))
            pos, neg = [], []
            for x in types_list:
                if "pos" in x:
                    pos.append(self.type_name_to_index(x.replace("-pos", "")))
                elif "neg" in x:
                    neg.append(self.type_name_to_index(x.replace("-neg", "")))
            return pos, neg
        return -1

    def type_index_to_name(self, type_index: int) -> str:
        return self.type_names[type_index] if type_index < len(self.type_names) else ""

    def add_fake_type(self, type_name: str, type_channel: int):
        self.type_names.append(type_name)
        self.channel_names.append(type_name)
        self.fake_channels.append(type_channel)

    def calc_cell_types(self, type_marker_image, frame: int, type_name: str,
                        threshold: float = 0.1,
                        percentage_above_threshold: float = 90,
                        peak_window_size: int = 0) -> int:
        """Classify cells by marker intensity on the session's device (the
        new types written back on the table's own device): positive iff the (100-p)th percentile of the cell's marker pixels exceeds
        threshold x the image's 99th percentile, with an optional
        local-maxima gate (a sigma-7 blur equal to its ``peak_window_size``
        maximum filter within 1e-6 somewhere in the cell)."""
        table = self.get_cells_info(frame)
        labels = self.get_labels(frame)
        if table is None or labels is None:
            return 0
        if type_name not in self.type_names:
            self.type_names.append(type_name)
        type_index = self.type_names.index(type_name)

        dev = self.device
        cells = table.map(lambda t: t.to(dev))
        if isinstance(type_marker_image, torch.Tensor):
            marker = type_marker_image.to(device=dev, dtype=torch.float32)
        else:
            marker = torch.from_numpy(np.asarray(type_marker_image,
                                                 np.float32)).to(dev)
        lab = torch.from_numpy(labels.astype(np.int32)).to(dev)
        pct = segment_percentile(marker.reshape(-1), lab.reshape(-1),
                                 self.capacity + 1,
                                 100.0 - percentage_above_threshold)
        props = regionprops(lab, num_labels=self.capacity, intensity=marker)
        mean_int = props["mean_intensity"][1:]

        # revalidate (areas unchanged -> the same validity rule)
        exists = cells.empty_cell == 0
        n = torch.clamp(exists.to(torch.int32).sum(), min=1)
        mean_area = torch.where(exists, cells.area, 0.0).sum() / n
        new_valid = (exists & (cells.area < self.max_cell_area * mean_area)
                     & (cells.area > self.min_cell_area * mean_area)
                     ).to(torch.int32)

        thr = threshold * percentile(marker, 99.0)
        pos = (pct[1:] > thr) & exists
        if peak_window_size > 0:
            blurred = gaussian_blur(marker, 7.0)
            maxima = torch.abs(blurred - maximum_filter(
                blurred, peak_window_size, cval=-float("inf"))) < 1e-6
            hit = torch.where(maxima, lab, 0).reshape(-1).long()
            hit = hit[(hit > 0) & (hit <= self.capacity)]
            has_max = torch.zeros(self.capacity + 1, dtype=torch.bool,
                                  device=dev)
            has_max[hit] = True
            pos = pos & has_max[1:]
        new_types = torch.where(pos, change_type(cells.type, type_index, True),
                                change_type(cells.type, type_index, False))
        new_types = torch.where(exists, new_types, cells.type)
        self.set_cells_info(frame, replace_fields(table, type=new_types,
                                                  valid=new_valid))
        # mean intensity column for the features
        self._mean_intensity_cache[(frame, type_name)] = to_numpy(mean_int)
        self.update_cell_types_by_cells_info(frame)
        return 0

    def get_mean_intensity(self, frame: int, type_name: str) -> Optional[np.ndarray]:
        return self._mean_intensity_cache.get((frame, type_name))

    def update_cell_types_by_cells_info(self, frame: int) -> int:
        """Repaint the per-pixel type map from the table: valid cells get
        their type bits, invalid cells and boundaries 255."""
        labels = self.get_labels(frame)
        table = self.get_cells_info(frame)
        if labels is None or table is None:
            return 0
        lut = np.full((self.capacity + 1,), INVALID_TYPE_INDEX, np.uint8)
        valid = to_numpy(table.valid) == 1
        lut[1:][valid] = to_numpy(table.type)[valid]
        self.set_cell_types(frame, lut[np.clip(labels, 0, self.capacity)])
        return 0

    # ---------------- tracking

    def track_cells(self, initial_frame: int = 1, final_frame: int = -1,
                    images: Optional[np.ndarray] = None,
                    search_range: float = 100.0, memory: int = 3) -> int:
        """Track the frames on the session's device: drifts from ``images``
        (the drift chain, or the stage-prior refinement when a stage
        sidecar exists), per-cell adaptive radii, then the auction tracker;
        writes track ids into each frame's ``label``."""
        from tissue_image_processing_tpu_torch.core.tracking import (
            adaptive_radii, compute_drift_chain, track_movie)

        if final_frame == -1:
            final_frame = self.number_of_frames
        frames = list(range(initial_frame, final_frame + 1))
        tables = [self.get_cells_info(f) for f in frames]
        have = [t is not None for t in tables]
        if not any(have):
            return 0
        cap = self.capacity
        Z = np.zeros((len(frames), cap), np.float32)
        cy, cx, area = Z.copy(), Z.copy(), Z.copy()
        mask = np.zeros((len(frames), cap), bool)
        for i, t in enumerate(tables):
            if t is None:
                continue
            cy[i] = to_numpy(t.cy)
            cx[i] = to_numpy(t.cx)
            area[i] = to_numpy(t.area)
            mask[i] = to_numpy(t.valid_mask())
        valid = np.array([self.is_frame_valid(f) and have[i]
                          for i, f in enumerate(frames)])
        if images is not None:
            imgs = np.asarray(to_numpy(images)[initial_frame - 1:final_frame],
                              np.float32)
            stage = self.stage_shift_chain(initial_frame, final_frame)
            if stage is not None:
                from tissue_image_processing_tpu_torch.ops.drift import (
                    drift_chain_with_stage_priors)
                drifts = drift_chain_with_stage_priors(imgs, stage,
                                                       device=self.device)
            else:
                drifts = to_numpy(compute_drift_chain(
                    torch.from_numpy(imgs).to(self.device)))
            self.drifts[initial_frame - 1:final_frame] = drifts
        drifts_np = self.drifts[initial_frame - 1:final_frame].astype(np.float32)

        def dev(a):
            return torch.as_tensor(a).to(self.device)

        tabs = [dev(cy), dev(cx), dev(area), dev(mask)]
        # trackpy's adaptive search: per-cell effective radii
        ranges = adaptive_radii(*tabs, drifts=dev(drifts_np),
                                search_range=search_range)
        ids = to_numpy(track_movie(
            *tabs, drifts=dev(drifts_np), frame_valid=dev(valid),
            search_range=search_range, memory=memory, capacity=2 * cap,
            search_ranges=ranges))
        for i, f in enumerate(frames):
            t = tables[i]
            if t is None:
                continue
            self.apply_track_ids(f, t, ids[i], mask[i])
        return final_frame

    def apply_track_ids(self, frame: int, table: CellTable,
                        ids_row, mask_row) -> None:
        """Write one frame's track ids into its table (valid cells get their
        track id, invalid keep the segment label) and keep ``cells_number``
        monotone. The table keeps its residency: a CPU table stays on the
        CPU, so event detection reads host tables without a transfer."""
        ids_row, mask_row = to_numpy(ids_row), to_numpy(mask_row)
        new_label = np.where(mask_row, ids_row,
                             to_numpy(table.label)).astype(np.int32)
        self.set_cells_info(frame, replace_fields(table, label=new_label))
        self.cells_number = max(self.cells_number, int(ids_row.max()))

    def calc_overall_drift(self) -> np.ndarray:
        """Cumulative drift over the valid frames."""
        overall = np.zeros_like(self.drifts)
        acc = np.zeros(2)
        for frame in range(self.number_of_frames):
            if self.is_frame_valid(frame + 1):
                acc = acc + self.drifts[frame]
            overall[frame] = acc
        return overall

    # ---------------- queries used by events/features

    def detect_edge_cells(self, frame: int) -> np.ndarray:
        """Row indices of the cells touching the image border."""
        labels = self.get_labels(frame)
        edge = np.hstack([labels[0, :], labels[:, 0], labels[-1, :], labels[:, -1]])
        return np.unique(edge[edge > 0]) - 1

    def get_valid_non_edge_mask(self, frame: int) -> np.ndarray:
        table = self.get_cells_info(frame)
        mask = to_numpy(table.valid_mask()).copy()
        edge = self.detect_edge_cells(frame)
        mask[edge] = False
        return mask

    def get_cell_id_by_position(self, frame: int, pos) -> int:
        labels = self.get_labels(frame)
        table = self.get_cells_info(frame)
        if labels is None or table is None:
            return 0
        x, y = int(pos[0]), int(pos[1])
        idx = int(labels[y, x]) - 1
        if idx < 0 or idx >= self.capacity:
            return 0
        return int(table.label[idx])

    def get_cell_centroid_by_id(self, frame: int, cell_id: int):
        table = self.get_cells_info(frame)
        if table is None:
            return None
        ok = (table.label == cell_id) & table.valid_mask()
        idx = torch.nonzero(ok).flatten()
        if idx.numel() < 1:
            return None
        i = idx[0]
        return float(table.cx[i]), float(table.cy[i])

    def get_cells_number(self) -> int:
        # the all-frames scan is T disk round trips in swap mode; cache it
        # and re-scan only after a table changed
        if not self._cells_number_dirty:
            return self.cells_number
        for f in range(self.number_of_frames, 0, -1):
            t = self.get_cells_info(f)
            if t is not None:
                self.cells_number = max(self.cells_number, int(t.label.max()))
        self._cells_number_dirty = False
        return self.cells_number

    def calc_neighbors_contact_matrix(self, frame: int) -> np.ndarray:
        """The frame's (capacity+1)^2 contact-length matrix, run-length form
        with the exact one on the rare overflowing frame (one host read of
        the flag)."""
        lab_dev = self._labels_on_device(self.get_labels(frame))
        mat, overflow = contact_length_matrix_checked(
            lab_dev, num_labels=self.capacity, compact_k=_NEIGHBOR_COMPACT_K)
        if bool(overflow):
            mat = contact_length_matrix(lab_dev, num_labels=self.capacity)
        return to_numpy(mat)

    def calc_recoil_speed_from_circular_ablation(self, shape_name: str,
                                                 first_frame: int,
                                                 last_frame: int,
                                                 save_path: Optional[str] = None
                                                 ) -> Optional[pd.DataFrame]:
        """Radial recoil of the cells inside a fitted ablation circle.

        Reads the circle fit stored under ``shape_name`` in
        ``shape_fitting_results[last_frame - 1]`` (keys ``x_center`` /
        ``y_center`` / ``radius`` as (value, stderr) pairs, as produced by
        :func:`core.shape_fit.fit_a_circle`). Valid non-edge cells of
        ``last_frame`` inside the circle are matched to ``first_frame`` by
        track id; their movement is corrected by the inner-cell mean (the
        patch's rigid drift) and projected onto the direction toward the
        centre (positive = recoiling inward). Returns the rim cells — those
        touching >= 1 invalid neighbour — and pickles them to ``save_path``
        (default ``recoil_data.pkl`` beside ``data_path``; ``""`` skips the
        write)."""
        from tissue_image_processing_tpu_torch.core.features import (
            n_neighbors_from_type)
        table = self.get_cells_info(last_frame)
        first = self.get_cells_info(first_frame)
        if table is None or first is None:
            return None
        fits = self.shape_fitting_results[last_frame - 1]
        if shape_name not in fits:
            raise KeyError(f"no '{shape_name}' fit stored for frame "
                           f"{last_frame}; run shape fitting first")
        circle = fits[shape_name]
        xc, yc = float(circle["x_center"][0]), float(circle["y_center"][0])
        radius = float(circle["radius"][0])
        n_invalid = to_numpy(n_neighbors_from_type(table, count_mode="invalid"))
        cx, cy = to_numpy(table.cx).astype(float), to_numpy(table.cy).astype(float)
        to_cx, to_cy = xc - cx, yc - cy
        dist = np.hypot(to_cx, to_cy)
        inner = self.get_valid_non_edge_mask(last_frame) & (dist <= radius)
        lab = to_numpy(table.label)
        flab = to_numpy(first.label)
        order = np.argsort(flab, kind="stable")
        pos = np.clip(np.searchsorted(flab, lab, sorter=order),
                      0, max(flab.size - 1, 0))
        fidx = order[pos]
        matched = (flab[fidx] == lab) & (lab > 0) & \
            self.get_valid_non_edge_mask(first_frame)[fidx]
        sel = np.nonzero(inner & matched)[0]
        if sel.size == 0:
            return pd.DataFrame()
        mv_x = cx[sel] - to_numpy(first.cx).astype(float)[fidx[sel]]
        mv_y = cy[sel] - to_numpy(first.cy).astype(float)[fidx[sel]]
        # rigid-drift correction: the patch as a whole may translate
        mv_x -= mv_x.mean()
        mv_y -= mv_y.mean()
        radial = (mv_x * to_cx[sel] + mv_y * to_cy[sel]) / \
            np.maximum(dist[sel], 1e-9)
        df = pd.DataFrame({
            "label": lab[sel], "cx": cx[sel], "cy": cy[sel],
            "to_center_x": to_cx[sel], "to_center_y": to_cy[sel],
            "dist_to_center": dist[sel],
            "movement_x": mv_x, "movement_y": mv_y,
            "radial_movement": radial,
            "n_invalid_neighbors": n_invalid[sel],
            "type": to_numpy(table.type)[sel],
        })
        rim = df[df["n_invalid_neighbors"] > 0].reset_index(drop=True)
        if save_path is None:
            save_path = os.path.join(
                os.path.dirname(os.path.abspath(self.data_path)),
                "recoil_data.pkl")
        if save_path:
            rim.to_pickle(save_path)
        return rim

    # ---------------- events (delegates to core.events)

    def add_event(self, *args, **kwargs):
        from tissue_image_processing_tpu_torch.core import events as E
        return E.add_event(self, *args, **kwargs)

    def delete_event(self, start_frame, start_pos):
        from tissue_image_processing_tpu_torch.core import events as E
        return E.delete_event(self, start_frame, start_pos)

    def find_events(self, initial_frame: int = 1, final_frame: int = -1, **kw):
        from tissue_image_processing_tpu_torch.core import events as E
        last = initial_frame
        for frame in E.find_events_iterator(self, initial_frame, final_frame, **kw):
            last = frame
        return last

    def find_events_iterator(self, initial_frame: int = 1, final_frame: int = -1, **kw):
        from tissue_image_processing_tpu_torch.core import events as E
        return E.find_events_iterator(self, initial_frame, final_frame, **kw)

    def get_events(self) -> pd.DataFrame:
        return self.events

    def fix_cell_types_after_tracking(self, **kw):
        from tissue_image_processing_tpu_torch.core import events as E
        return E.fix_cell_types_after_tracking(self, **kw)

    def fix_one_frame_tracking_using_local_drifts(
            self, start_frame: int, end_frame: int, images=None,
            step_size: int = 100, window_size: int = 700,
            start_frame_pos=None, end_frame_pos=None) -> int:
        """Repair tracking across one bad transition: shift the start
        frame's centroids by a clicked pair of positions or by a windowed
        local drift field of ``images``, re-link the two frames with the
        auction on the session's device, and propagate the relabelling to
        every later frame."""
        from tissue_image_processing_tpu_torch.core.tracking import (
            auction_assignment, local_drift_field)

        next_frame = -1
        for frame in range(start_frame + 1, self.number_of_frames + 1):
            if self.is_frame_valid(frame):
                next_frame = frame
                break
        if next_frame < 0 or next_frame != end_frame:
            return 0
        t1 = self.get_cells_info(start_frame)
        t2 = self.get_cells_info(end_frame)
        if t1 is None or t2 is None:
            return 0
        m1 = to_numpy(t1.valid_mask())
        m2 = to_numpy(t2.valid_mask())
        cx1 = to_numpy(t1.cx).copy()
        cy1 = to_numpy(t1.cy).copy()
        if start_frame_pos is not None and end_frame_pos is not None:
            c1 = self.get_cell_centroid_by_id(
                start_frame, self.get_cell_id_by_position(start_frame, start_frame_pos))
            c2 = self.get_cell_centroid_by_id(
                end_frame, self.get_cell_id_by_position(end_frame, end_frame_pos))
            cx1 += c2[0] - c1[0]
            cy1 += c2[1] - c1[1]
        elif images is not None:
            def frame_image(f):
                return torch.from_numpy(np.asarray(to_numpy(images[f - 1]),
                                                   np.float32)).to(self.device)

            sy, sx = local_drift_field(frame_image(start_frame),
                                       frame_image(end_frame),
                                       window_size=window_size,
                                       step_size=step_size)
            sy, sx = to_numpy(sy), to_numpy(sx)
            yy = np.clip(np.round(cy1).astype(int), 0, sy.shape[0] - 1)
            xx = np.clip(np.round(cx1).astype(int), 0, sy.shape[1] - 1)
            cx1 -= sx[yy, xx]
            cy1 -= sy[yy, xx]
        # re-link the two frames (persons = end-frame cells, objects = start)
        sr2 = 100.0 ** 2
        dy = cy1[None, :] - to_numpy(t2.cy)[:, None]
        dx = cx1[None, :] - to_numpy(t2.cx)[:, None]
        da = np.sqrt(np.maximum(to_numpy(t1.area), 0))[None, :] - \
            np.sqrt(np.maximum(to_numpy(t2.area), 0))[:, None]
        cost2 = dy * dy + dx * dx + 0.5 * da * da
        benefit = np.where(cost2 < sr2, sr2 - cost2, -np.inf).astype(np.float32)
        person_obj = to_numpy(auction_assignment(
            torch.from_numpy(benefit).to(self.device),
            torch.from_numpy(m2).to(self.device),
            torch.from_numpy(m1).to(self.device)))
        ids1 = to_numpy(t1.label)
        old_labels = to_numpy(t2.label).copy()
        new_labels = old_labels.copy()
        linked = (person_obj >= 0) & m2
        new_labels[linked] = ids1[person_obj[linked]]
        # unlinked cells that reuse a first-frame label get fresh ids
        first_labels = ids1[m1]
        unlinked = m2 & (~linked) & np.isin(new_labels, first_labels)
        top = max(int(first_labels.max(initial=0)), int(new_labels.max(initial=0)))
        new_labels[unlinked] = top + 1 + np.arange(unlinked.sum())
        self.set_cells_info(end_frame, replace_fields(
            t2, label=np.where(m2, new_labels, old_labels)))
        # LUT for later frames; labels skipping end_frame keep their identity
        lut = {int(o): int(n) for o, n in zip(old_labels[m2], new_labels[m2])}
        skip = set(int(v) for v in first_labels) - set(lut.keys()) - set(lut.values())
        lut.update({s: s for s in skip})
        for frame in range(end_frame + 1, self.number_of_frames + 1):
            t = self.get_cells_info(frame)
            if t is None or not self.is_frame_valid(frame):
                continue
            ids = to_numpy(t.label).copy()
            m = to_numpy(t.valid_mask())
            used = set(lut.values())
            top = max([int(ids[m].max(initial=0))] + list(used))
            for i in np.nonzero(m)[0]:
                lab = int(ids[i])
                if lab in lut:
                    ids[i] = lut[lab]
                elif lab in used:
                    top += 1
                    lut[lab] = top
                    used.add(top)
                    ids[i] = top
                else:
                    lut[lab] = lab
                    used.add(lab)
            self.set_cells_info(frame, replace_fields(t, label=ids))
        return 0

    # ---------------- misc public API

    def get_cell_type_names(self):
        """Powerset of the pos/neg type combinations, contradictions
        filtered."""
        from itertools import chain, combinations

        pos_neg = [f"{t}-pos" for t in self.type_names] + \
                  [f"{t}-neg" for t in self.type_names]
        full = chain.from_iterable(combinations(pos_neg, r)
                                   for r in range(len(pos_neg) + 1))

        def ok(x):
            if not x:
                return False
            return not any(f"{t}-pos" in x and f"{t}-neg" in x
                           for t in self.type_names)

        return [str(x) for x in full if ok(x)] + self.CELL_TYPES

    def get_cell_by_pixel(self, x: int, y: int, frame: int):
        """Row dict of the cell under a pixel."""
        labels = self.get_labels(frame)
        table = self.get_cells_info(frame)
        if labels is None or table is None:
            return None
        idx = int(labels[int(y), int(x)]) - 1
        if idx < 0 or idx >= self.capacity:
            return {}
        return {k: to_numpy(getattr(table, k))[idx]
                for k in ["area", "perimeter", "label", "cx", "cy", "valid",
                          "type", "empty_cell"]}

    def get_cells_features(self, frame: int):
        from tissue_image_processing_tpu_torch.core.frame_data import (
            SPECIAL_FEATURES, COLUMN_FEATURES)
        if self.get_cells_info(frame) is None:
            return []
        return COLUMN_FEATURES + SPECIAL_FEATURES

    def reset_all_data(self, channel_names=None):
        self._labels = [None] * self.number_of_frames
        self._cell_types = [None] * self.number_of_frames
        self._tables = [None] * self.number_of_frames
        self.type_names = []
        if channel_names is not None:
            self.channel_names = list(channel_names)
        return 0

    def find_valid_frames(self, initial_frame: int, final_frame: int) -> np.ndarray:
        initial_frame = max(1, initial_frame)
        final_frame = min(self.number_of_frames, final_frame)
        rng = np.arange(initial_frame, final_frame) - 1
        return rng[self.valid_frames[rng] == 1] + 1

    def fix_cell_label(self, frame: int, position, new_label: int) -> int:
        """Retarget a track id at a clicked cell, swapping with any holder
        and propagating to the later frames."""
        if new_label <= 0:
            return 0
        labels = self.get_labels(frame)
        if labels is None:
            return 0
        x, y = int(position[0]), int(position[1])
        idx = int(labels[y, x]) - 1
        if idx < 0:
            return 0
        table = self.get_cells_info(frame)
        if table is None:
            return 0
        ids = to_numpy(table.label).copy()
        current = int(ids[idx])
        holders = np.nonzero((ids == new_label) & to_numpy(table.valid_mask()))[0]
        if holders.size:
            ids[holders[0]] = current
        ids[idx] = new_label
        self.set_cells_info(frame, replace_fields(table, label=ids))
        for future in range(frame + 1, self.number_of_frames + 1):
            t = self.get_cells_info(future)
            if t is None:
                continue
            fid = to_numpy(t.label).copy()
            m = to_numpy(t.valid_mask())
            rows = np.nonzero((fid == current) & m)[0]
            if not rows.size:
                break
            holders = np.nonzero((fid == new_label) & m)[0]
            if holders.size:
                fid[holders[0]] = current
            fid[rows[0]] = new_label
            self.set_cells_info(future, replace_fields(t, label=fid))
        return 0

    def fix_cell_id_in_events(self) -> int:
        """Re-resolve event cell ids from their positions after re-tracking."""
        for event_idx in self.events.index:
            ev = self.events.loc[event_idx]
            start_pos = (int(round(ev.start_pos_x)), int(round(ev.start_pos_y)))
            end_pos = (int(round(ev.end_pos_x)), int(round(ev.end_pos_y)))
            cell_id = self.get_cell_id_by_position(int(ev.start_frame), start_pos)
            end_id = self.get_cell_id_by_position(int(ev.end_frame), end_pos)
            self.events.at[event_idx, "cell_id"] = cell_id
            daughter_pos = (int(round(ev.daughter_pos_x)),
                            int(round(ev.daughter_pos_y)))
            if daughter_pos != (0, 0):
                did = self.get_cell_id_by_position(int(ev.end_frame), daughter_pos)
                if cell_id == did:
                    did = end_id
                elif cell_id != end_id:
                    self.fix_cell_label(int(ev.end_frame), end_pos, cell_id)
                self.events.at[event_idx, "daughter_id"] = did
            elif end_id != cell_id:
                self.fix_cell_label(int(ev.end_frame), end_pos, cell_id)
        return 0

    def fix_cell_pos_in_events(self) -> int:
        """Refresh event positions from the current centroids."""
        for event_idx in self.events.index:
            ev = self.events.loc[event_idx]
            start = self.get_cell_centroid_by_id(int(ev.start_frame), int(ev.cell_id))
            end = self.get_cell_centroid_by_id(int(ev.end_frame), int(ev.cell_id))
            if start:
                self.events.at[event_idx, "start_pos_x"] = start[0]
                self.events.at[event_idx, "start_pos_y"] = start[1]
            if end:
                self.events.at[event_idx, "end_pos_x"] = end[0]
                self.events.at[event_idx, "end_pos_y"] = end[1]
            if int(ev.daughter_id) > 0:
                d = self.get_cell_centroid_by_id(int(ev.end_frame),
                                                 int(ev.daughter_id))
                if d:
                    self.events.at[event_idx, "daughter_pos_x"] = d[0]
                    self.events.at[event_idx, "daughter_pos_y"] = d[1]
        return 0

    def find_events_frame(self) -> int:
        """Recompute every event's significant frame."""
        from tissue_image_processing_tpu_torch.core.events import find_event_frame
        for i in self.events.index:
            self.events.at[i, "significant_frame"] = int(
                find_event_frame(self, self.events.loc[i]))
        return 0

    def split_into_promoted_and_normal_differentiation(self, threshold: float) -> int:
        """Relabel the differentiations nearer than ``threshold`` to an
        ablation as 'promoted differentiation'."""
        from tissue_image_processing_tpu_torch.core.frame_data import (
            get_event_statistics)
        res = get_event_statistics(self, "differentiation", "Distance from ablation")
        if res is None or "Distance from ablation" not in res:
            return 0
        idx = self.events.query('type == "differentiation"').index.to_numpy()
        near = res["Distance from ablation"].to_numpy() < threshold
        self.events.loc[idx[near[:len(idx)]], "type"] = "promoted differentiation"
        return 0

    # ---------------- persistence (.seg)

    def _ensure_working_dir(self):
        if self.working_dir is None:
            self._set_working_dir(get_temp_directory(self.data_path or "session"))
        return self.working_dir

    def _flush_to_working_dir(self):
        wd = self._ensure_working_dir()
        # in swap mode every frame but the in-memory one is already on disk
        for i in range(self.number_of_frames):
            if self._labels[i] is not None:
                self._write_artifact("labels", i, self._labels[i])
            if self._cell_types[i] is not None:
                self._write_artifact("types", i, self._cell_types[i])
            if self._tables[i] is not None:
                self._write_artifact("data", i, self._tables[i])
        self.events.to_pickle(os.path.join(wd, "events_data.pkl"))
        np.save(os.path.join(wd, "drifts.npy"), self.drifts)
        np.save(os.path.join(wd, "valid_frames.npy"), self.valid_frames)
        with open(os.path.join(wd, "shape_fitting_data.json"), "w") as fp:
            json.dump(self.shape_fitting_results, fp)
        for name, obj in [("cell_type_names.pkl", self.type_names),
                          ("channel_names.pkl", self.channel_names),
                          ("fake_channels.pkl", self.fake_channels)]:
            with open(os.path.join(wd, name), "wb") as fp:
                pickle.dump(obj, fp)
        with open(os.path.join(wd, self._FORMAT_MARKER), "w") as fp:
            json.dump({"format": 1}, fp)

    def save(self, path: str) -> Iterator[float]:
        """Flush the artifacts and zip them into a .seg archive."""
        self._flush_to_working_dir()
        target = path if path.endswith(".seg") else path + ".seg"
        yield from pack_archive_with_progress(self.working_dir, target)

    # archives written by either package carry this marker; its absence
    # identifies a legacy .seg whose types maps need the pre-bitmask migration
    _FORMAT_MARKER = "tip_tpu_format.json"

    @staticmethod
    def _migrate_legacy_types_dir(wd: str) -> None:
        """One-time in-place migration of pre-bitmask cell-types maps: 0 =
        invalid -> 255, 2 -> 0, 1 stays bit 0. Only maps that look
        pre-bitmask (all values in {0, 1, 2}) are touched."""
        import glob
        for p in glob.glob(os.path.join(wd, "frame_*_types.npy")):
            arr = np.load(p)
            if arr.size and 0 <= arr.min() and arr.max() <= 2:
                arr = arr.copy()
                arr[arr == 0] = 255
                arr[arr == 2] = 0
                np.save(p, arr)

    def load(self, path: str) -> Iterator[float]:
        """Load a .seg archive (tables onto the session's device)."""
        wd = get_temp_directory(self.data_path or "session")
        yield from unpack_archive_with_progress(path, wd)
        try:  # a legacy archive may carry a stale pid marker: re-own it
            with open(os.path.join(wd, _PID_MARKER), "w") as fp:
                fp.write(str(os.getpid()))
        except OSError:
            pass
        marker = os.path.join(wd, self._FORMAT_MARKER)
        if not os.path.isfile(marker):
            self._migrate_legacy_types_dir(wd)
            with open(marker, "w") as fp:
                json.dump({"format": 1}, fp)
        if self.working_dir and os.path.isdir(self.working_dir):
            shutil.rmtree(self.working_dir, ignore_errors=True)
        self._set_working_dir(wd)
        self._labels = [None] * self.number_of_frames
        self._cell_types = [None] * self.number_of_frames
        self._tables = [None] * self.number_of_frames
        self._mem = {"labels": -1, "types": -1, "data": -1}
        self._cells_number_dirty = True
        if not self._swap:
            for i in range(self.number_of_frames):
                self._labels[i] = self._read_artifact("labels", i)
                self._cell_types[i] = self._read_artifact("types", i)
                self._tables[i] = self._read_artifact("data", i)
        p = os.path.join(wd, "events_data.pkl")
        if os.path.isfile(p):
            self.events = pd.concat([self.events, pd.read_pickle(p)],
                                    ignore_index=True).drop_duplicates(ignore_index=True)
            self.events["source"] = self.events["source"].fillna("manual")
        for name, attr in [("drifts.npy", "drifts"), ("valid_frames.npy", "valid_frames")]:
            p = os.path.join(wd, name)
            if os.path.isfile(p):
                setattr(self, attr, np.load(p))
        p = os.path.join(wd, "shape_fitting_data.json")
        if os.path.isfile(p):
            with open(p) as fp:
                self.shape_fitting_results = json.load(fp)
        for name, attr in [("cell_type_names.pkl", "type_names"),
                           ("channel_names.pkl", "channel_names"),
                           ("fake_channels.pkl", "fake_channels")]:
            p = os.path.join(wd, name)
            if os.path.isfile(p):
                with open(p, "rb") as fp:
                    setattr(self, attr, pickle.load(fp))
        return

    def clean_up(self):
        if self._wd_finalizer is not None:
            self._wd_finalizer()  # idempotent; also detaches
        if self.working_dir and os.path.isdir(self.working_dir):
            shutil.rmtree(self.working_dir, ignore_errors=True)

    def stage_shift_chain(self, initial_frame: int, final_frame: int):
        """(T, 2) coarse per-frame-pair shifts (rows, cols) in pixels from
        the stage-location sidecar, or None: row shift = stage-y delta /
        physical_y, col shift = stage-x delta / physical_x (x and y are
        swapped between the stage and the image)."""
        loc = self.stage_locations
        if loc is None:
            return None
        T = final_frame - initial_frame + 1
        shifts = np.zeros((T, 2), np.float64)
        try:
            for i in range(1, T):
                f = initial_frame + i
                d = (loc.loc[f - 1, ["y", "x"]].to_numpy(dtype=float)
                     - loc.loc[f - 2, ["y", "x"]].to_numpy(dtype=float))
                ps = loc.loc[f - 1, ["physical_size_y",
                                     "physical_size_x"]].to_numpy(dtype=float)
                shifts[i] = d / ps
        except (KeyError, IndexError):
            return None
        return shifts

    def load_stage_locations(self):
        """Sidecar stage-location pickle next to the movie."""
        if not self.data_path:
            return None
        base = os.path.basename(self.data_path).replace(".tif", "")
        path = os.path.join(os.path.dirname(self.data_path),
                            f"stage_locations_{base}.pkl")
        if os.path.isfile(path):
            return pd.DataFrame(pd.read_pickle(path))
        return None

    def load_height_map(self):
        """Sidecar z-map next to the movie."""
        if not self.data_path:
            return None
        base = os.path.basename(self.data_path).replace(".tif", "")
        path = os.path.join(os.path.dirname(self.data_path), f"zmap_{base}.npy")
        if os.path.isfile(path):
            return np.load(path, mmap_mode="r")
        return None
