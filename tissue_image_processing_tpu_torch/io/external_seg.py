"""External-segmentation ingest (EPySeg-style) — the reference's
``ExternalSegmentationThread`` (``gui.py:2081-2136``) rebuilt as a library:
a dependency-free folder poller (no watchdog) that yields files once their
size is stable, plus the loader that turns an external boundary image into
labels and refreshes the frame's cell table
(``tissue_info.py:3467-3472`` ``load_labels_from_external_file``).

External tools (EPySeg, Cellpose exports, ...) write per-frame boundary
images named ``frame_<N>_*`` into an output folder; each is connected-
component labeled (boundary value 255 = background, 4-connectivity — the
reference's ``label_image_regions(background=255, connectivity=1)``) and
installed as that frame's segmentation.

Copied from ``tissue_image_processing_tpu/io/external_seg.py``: host code,
the same functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["load_external_labels", "watch_segmentation_folder",
           "ingest_external_segmentation"]


def load_external_labels(tissue, frame: int, path: str) -> Optional[np.ndarray]:
    """Load an external boundary image as frame labels + recompute cellinfo."""
    if not os.path.isfile(path):
        return None
    if path.endswith(".npy"):
        image = np.load(path)
    else:
        from tissue_image_processing_tpu_torch.io.tiff import read_tiff
        image, _axes, _shape, _meta = read_tiff(path)
    image = np.squeeze(np.asarray(image))
    from scipy import ndimage as ndi
    labels, _n = ndi.label(image != 255,
                           structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
    tissue.set_labels(frame, labels.astype(np.int32), reset_data=True)
    tissue.calculate_frame_cellinfo(frame)
    return labels


def _frame_number(path: str) -> Optional[int]:
    name = os.path.basename(path)
    if not name.startswith("frame"):
        return None
    parts = name.split("_")
    try:
        return int(parts[1])
    except (IndexError, ValueError):
        return None


def watch_segmentation_folder(
    folder: str,
    n_frames: int,
    poll_interval: float = 1.0,
    stable_checks: int = 1,
    timeout: Optional[float] = None,
) -> Iterator[Tuple[int, str]]:
    """Yield ``(frame, path)`` for each ``frame_<N>_*`` file in ``folder``
    (recursive) once its size has been stable for ``stable_checks`` polls —
    the reference's watchdog-observer + size-stability loop as a plain
    generator. Stops after ``n_frames`` distinct frames or ``timeout``."""
    seen = {}
    done = set()
    t0 = time.time()
    while len(done) < n_frames:
        if timeout is not None and time.time() - t0 > timeout:
            return
        for root, _dirs, files in os.walk(folder):
            for name in files:
                path = os.path.join(root, name)
                frame = _frame_number(path)
                if frame is None or frame in done:
                    continue
                try:
                    size = os.path.getsize(path)
                except OSError:
                    continue
                prev_size, stable = seen.get(path, (-1, 0))
                stable = stable + 1 if size == prev_size else 0
                seen[path] = (size, stable)
                if stable >= stable_checks:
                    done.add(frame)
                    yield frame, path
        if len(done) < n_frames:
            time.sleep(poll_interval)


def ingest_external_segmentation(tissue, folder: str, n_frames: int,
                                 **watch_kwargs) -> Iterator[float]:
    """Watch ``folder`` and load every stabilized per-frame output into
    ``tissue``; yields progress in [0, 1] (the thread's "%d/%d" signal)."""
    loaded = 0
    for frame, path in watch_segmentation_folder(folder, n_frames,
                                                 **watch_kwargs):
        load_external_labels(tissue, frame, path)
        loaded += 1
        yield loaded / n_frames
