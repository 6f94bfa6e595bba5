"""Movie splitting / track-following cropping / container conversion.

Python rebuilds of the reference's external-tool glue:
- ``split_large_movies.ijm`` (Bio-Formats per-timepoint extraction of multi-position
  movies into ``positionN/timepointT.tif``);
- ``crop_atoh_section_by_track.ijm`` (crop a 2R x 2R region following a manually
  tracked point and rebuild the 5-D stack);
- ``readwrite.py:19-69`` (two-pass multi-file movie -> single chunked store
  conversion, padding to max XYZ and concatenating T — zarr/dexp replaced by a
  chunked .npy store; CZI input gated behind aicsimageio).

Copied from ``tissue_image_processing_tpu/io/movie_tools.py``: host code,
the same functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tissue_image_processing_tpu_torch.io.movie import MovieStore
from tissue_image_processing_tpu_torch.io.tiff import save_tiff

__all__ = ["split_large_movie", "crop_section_by_track", "convert_series_to_store"]


def split_large_movie(path: str, output_dir: str,
                      positions: Optional[Sequence[int]] = None) -> List[str]:
    """Split a (T, C, Z, Y, X) movie container into per-position/timepoint tiffs
    (``positionN/timepointT.tif``), like ``split_large_movies.ijm:1-54``.

    Single-scene containers write position1 only; multi-scene czi needs aicsimageio.
    """
    store = MovieStore.open(path)
    outputs = []
    pos_list = positions or [1]
    for pos in pos_list:
        pos_dir = os.path.join(output_dir, f"position{pos}")
        os.makedirs(pos_dir, exist_ok=True)
        for t in range(store.num_frames):
            out = os.path.join(pos_dir, f"timepoint{t + 1}.tif")
            save_tiff(out, store.frame(t), axes="CZYX")
            outputs.append(out)
    return outputs


def crop_section_by_track(movie: np.ndarray, track_points: Sequence[Tuple[int, int]],
                          radius: int) -> np.ndarray:
    """Crop a (2R, 2R) window following a per-frame tracked point and rebuild the
    movie stack (``crop_atoh_section_by_track.ijm:1-112``).

    movie: (T, C, Z, Y, X); track_points: per-frame (x, y) centers (the last point
    repeats if fewer points than frames). Returns (T, C, Z, 2R, 2R).
    """
    T, C, Z, Y, X = movie.shape
    out = np.zeros((T, C, Z, 2 * radius, 2 * radius), movie.dtype)
    for t in range(T):
        x, y = track_points[min(t, len(track_points) - 1)]
        y0 = int(np.clip(y - radius, 0, max(Y - 2 * radius, 0)))
        x0 = int(np.clip(x - radius, 0, max(X - 2 * radius, 0)))
        out[t] = movie[t, :, :, y0:y0 + 2 * radius, x0:x0 + 2 * radius]
    return out


def convert_series_to_store(files: Sequence[str], output_path: str,
                            chunk_frames: int = 8) -> str:
    """Two-pass conversion of a multi-file movie series into one contiguous .npy
    store: pass 1 probes shapes, pass 2 pads every file to the max C/Z/Y/X and
    concatenates along T (``readwrite.py:19-69`` semantics with zarr/dexp replaced
    by a memory-mapped npy store)."""
    shapes = []
    for f in files:
        shapes.append(MovieStore.open(f).shape)
    max_c = max(s[1] for s in shapes)
    max_z = max(s[2] for s in shapes)
    max_y = max(s[3] for s in shapes)
    max_x = max(s[4] for s in shapes)
    total_t = sum(s[0] for s in shapes)
    out = np.lib.format.open_memmap(
        output_path, mode="w+", dtype=np.float32,
        shape=(total_t, max_c, max_z, max_y, max_x))
    t0 = 0
    for f, s in zip(files, shapes):
        store = MovieStore.open(f)
        for start in range(0, s[0], chunk_frames):
            stop = min(start + chunk_frames, s[0])
            chunk = store.frames(start, stop).astype(np.float32)
            padded = np.zeros((stop - start, max_c, max_z, max_y, max_x), np.float32)
            padded[:, :s[1], :s[2], :s[3], :s[4]] = chunk
            out[t0 + start:t0 + stop] = padded
        t0 += s[0]
    out.flush()
    return output_path


def napari_make_movie(layers, z_scale: float = 5.0, fps: int = 10,
                      output: str = "movie.mp4"):  # pragma: no cover - optional dep
    """Keyframe animation over T (reference ``napari_make_movie.py:3-19``);
    requires napari + napari-animation."""
    import napari
    from napari_animation import Animation

    viewer = napari.Viewer()
    for data, kwargs in layers:
        viewer.add_image(data, scale=(1, z_scale, 1, 1), **kwargs)
    animation = Animation(viewer)
    viewer.dims.set_point(0, 0)
    animation.capture_keyframe()
    last = viewer.dims.range[0][1] - 1
    viewer.dims.set_point(0, last)
    animation.capture_keyframe(steps=int(last))
    animation.animate(output, fps=fps)
