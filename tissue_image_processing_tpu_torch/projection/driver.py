"""Movie / large-image projection drivers.

Port of ``tissue_image_processing_tpu/projection/driver.py`` (the reference's
``movie_surface_projection`` / ``large_image_projection``,
``surface_projection.py:168-423``): multi-movie, multi-position runs with
resumable per-(position, movie) ``.npy`` intermediates, z-map sidecars
(``zmap_<name>.npy``), stage-location pickles and ``StageMetrics`` lines.

Frames go to the card in batches: each batch is read from the host array or
store once, uploaded in the store's dtype (uint16 for a raw movie), converted
to float32 on the card (exactly: the values of the JAX driver's host
conversion) and projected by ``movie_projection_batch``, the unfused route
(``time_point_surface_projection`` frame by frame), as the JAX driver does
with its vmapped batch. On the card that route's three blurs of a frame
(pre-blur, the small score volume's z axis, the z-mask) are ``blur3d``
launches. Results come back as host arrays. Every entry point takes
``device=None`` (the card; raises without one) or ``device="cpu"``.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from tissue_image_processing_tpu_torch._device import resolve_device
from tissue_image_processing_tpu_torch.io.movie import (
    MovieStore, concatenate_time_points)
from tissue_image_processing_tpu_torch.io.tiff import save_tiff
from tissue_image_processing_tpu_torch.projection.surface import (
    movie_projection_batch)

__all__ = ["movie_surface_projection", "large_image_projection",
           "project_movie_array", "update_projection_metadata",
           "save_stage_positions"]


def update_projection_metadata(path: str, size_t: Optional[int] = None,
                               physical_pixel_sizes=None) -> dict:
    """Rewrite SizeT / physical pixel sizes into a saved projection TIFF
    (reference ``update_projection_metadata``, ``surface_projection.py:319-327``)
    so downstream stage-prior code has an in-TIFF fallback when the
    ``stage_locations_*.pkl`` sidecar is missing. ``physical_pixel_sizes`` is
    (Z, Y, X) in micrometers. Returns the merged metadata dict."""
    from tissue_image_processing_tpu_torch.io.tiff import read_tiff

    arr, axes, _shape, meta = read_tiff(path)
    meta = dict(meta or {})
    if size_t is not None:
        meta["SizeT"] = int(size_t)
    if physical_pixel_sizes is not None:
        z, y, x = physical_pixel_sizes
        meta["physical_size_z"] = float(z)
        meta["physical_size_y"] = float(y)
        meta["physical_size_x"] = float(x)
    meta.pop("axes", None)
    meta.pop("shape", None)
    save_tiff(path, arr, metadata=meta, axes=axes)
    return meta


def project_movie_array(
    movie: np.ndarray,
    reference_channel: int = 0,
    method: str = "max_averages",
    bin_size: int = 1,
    build_manifold: bool = False,
    min_z: int = 0,
    max_z: int = 0,
    airyscan: bool = False,
    atoh_shift: int = 0,
    batch: int = 4,
    device=None,
):
    """Project a (T, C, Z, Y, X) movie (array, memmap or lazy store view)
    in batches of ``batch`` frames on ``device``.

    Returns (projection (T, C, Y, X) float32, zmap (T, Y, X) int32), host
    arrays."""
    dev = resolve_device(device)
    T, C, Z, Y, X = movie.shape
    ref = min(reference_channel, C - 1)  # reference clamps too (surface_projection.py:203-204)
    proj_out = np.zeros((T, C, Y, X), np.float32)
    zmap_out = np.zeros((T, Y, X), np.int32)
    for t0 in range(0, T, batch):
        t1 = min(t0 + batch, T)
        host = np.ascontiguousarray(movie[t0:t1])
        with warnings.catch_warnings():
            # a read-only memory map: the tensor is only read (uploaded,
            # converted), never written
            warnings.filterwarnings("ignore", "The given NumPy array is not writable")
            stacks = torch.from_numpy(host)
        stacks = stacks.to(dev).to(torch.float32)
        proj, zmap = movie_projection_batch(
            stacks, reference_channel=ref, min_z=min_z, max_z=max_z, method=method,
            bin_size=bin_size, airyscan=airyscan, atoh_shift=atoh_shift,
            build_manifold=build_manifold)
        proj_out[t0:t1] = proj.cpu().numpy()
        zmap_out[t0:t1] = zmap.cpu().numpy()
    return proj_out, zmap_out


def movie_surface_projection(
    files: Sequence[str],
    reference_channel: int,
    position_final_movie: Sequence[int],
    initial_positions_number: int,
    output_dir: str,
    method: str = "max_averages",
    bin_size: int = 1,
    build_manifold: bool = False,
    only_position: int = 0,
    zmin: int = 0,
    zmax: int = 0,
    airyscan: bool = False,
    output_name: str = "",
    batch: int = 4,
    metrics=None,
    physical_pixel_sizes=None,
    device=None,
) -> None:
    """Project a list of movie files (one position each, or TCZYX stores) into
    per-position projection TIFFs + z-map sidecars (reference
    ``movie_surface_projection``, ``surface_projection.py:168-237``).

    Resumable: per-(position, movie) .npy intermediates already on disk are skipped
    (reference ``:199-200``). ``metrics``: optional
    :class:`~tissue_image_processing_tpu_torch.utils.runtime.StageMetrics` — every
    (position, movie) projection and every concat/save emits a structured
    JSON line (SURVEY §5.5).
    """
    from tissue_image_processing_tpu_torch.utils.runtime import StageMetrics

    dev = resolve_device(device)
    metrics = metrics or StageMetrics(stream=None)
    positions = list(range(initial_positions_number))
    projection_files: List[List[str]] = [[] for _ in range(initial_positions_number)]
    zmap_files: List[List[str]] = [[] for _ in range(initial_positions_number)]
    for file_num, file in enumerate(files):
        remove_positions = []
        for position in list(positions):
            if position_final_movie[position] == file_num + 1:
                remove_positions.append(position)
            if only_position > 0 and position != only_position - 1:
                continue
            projection_path = os.path.join(
                output_dir, "position%d_movie%d_projection.npy" % (position, file_num))
            zmap_path = os.path.join(
                output_dir, "position%d_movie%d_zmap.npy" % (position, file_num))
            projection_files[position].append(projection_path)
            zmap_files[position].append(zmap_path)
            print("Projecting position %d, movie %d" % (position + 1, file_num + 1),
                  flush=True)
            if os.path.isfile(projection_path) and os.path.isfile(zmap_path):
                metrics.emit("skip_existing", position=position + 1,
                             movie=file_num + 1)
                continue
            with metrics.stage("project", position=position + 1,
                               movie=file_num + 1, file=os.path.basename(file)):
                store = MovieStore.open(file)
                proj, zmap = project_movie_array(
                    store.data, reference_channel=reference_channel, method=method,
                    bin_size=bin_size, build_manifold=build_manifold, min_z=zmin,
                    max_z=zmax, airyscan=airyscan, batch=batch, device=dev)
                np.save(projection_path, proj)
                np.save(zmap_path, zmap.astype(np.uint16))
        for to_delete in remove_positions:
            positions.remove(to_delete)

    for position in range(initial_positions_number):
        if only_position > 0 and position != only_position - 1:
            continue
        if not projection_files[position]:
            continue
        with metrics.stage("concat_save", position=position + 1):
            movie_projection = concatenate_time_points(projection_files[position])
            # SizeT + physical pixel sizes ride in the TIFF itself (reference
            # update_projection_metadata, surface_projection.py:319-327)
            meta = {"SizeT": int(movie_projection.shape[0])}
            if physical_pixel_sizes is not None:
                z, y, x = physical_pixel_sizes
                meta.update(physical_size_z=float(z), physical_size_y=float(y),
                            physical_size_x=float(x))
            save_tiff(os.path.join(output_dir, output_name + "position%d.tif" % (position + 1)),
                      movie_projection, metadata=meta, axes="TCYX",
                      data_type="uint16")
            movie_zmap = np.concatenate(
                [np.load(f).astype("uint16") for f in zmap_files[position]], axis=0)
            np.save(os.path.join(output_dir, output_name + "zmap_position%d.npy" % (position + 1)),
                    movie_zmap)
    # cleanup intermediates (reference surface_projection.py:235-237)
    for position_files in projection_files + zmap_files:
        for f in position_files:
            if os.path.isfile(f):
                os.remove(f)


def save_stage_positions(stage_records: Sequence[dict], output_dir: str,
                         output_name: str = "") -> None:
    """Persist per-position stage-location pickles
    (``stage_locations_position<i>.pkl``, reference ``surface_projection.py:240-276``)."""
    for i, rec in enumerate(stage_records):
        out_path = os.path.join(output_dir,
                                output_name + "stage_locations_position%d.pkl" % (i + 1))
        with open(out_path, "wb") as f:
            pickle.dump(rec, f)


def large_image_projection(
    input_dir: str,
    output_dir: str,
    input_file_name: str,
    reference_channel: int = 0,
    chunk_size: int = 0,
    bin_size: int = 1,
    channels_shift: int = 0,
    min_z: int = 0,
    max_z: int = 0,
    method: str = "max_averages",
    build_manifold: bool = False,
    airyscan: bool = False,
    device=None,
) -> int:
    """Chunked projection of a huge fixed sample (reference
    ``large_image_projection``, ``surface_projection.py:279-316``): the XY plane is
    tiled into chunk_size blocks, each projected independently on ``device``."""
    dev = resolve_device(device)
    path = os.path.join(input_dir, input_file_name)
    if not os.path.exists(path):
        return 0
    store = MovieStore.open(path)
    T, C, Z, Y, X = store.shape
    cs = chunk_size or max(Y, X)
    projection = np.zeros((T, C, Y, X), np.float32)
    zmap = np.zeros((T, Y, X), np.int32)
    # frame-major tiling: decode each frame ONCE and slice tiles from the host
    # array — slicing a lazy TIFF/CZI store per XY tile (data[..., y0:, x0:])
    # would re-decode the full-resolution frame for every tile, turning the
    # huge-fixed-sample path this tiling exists for into O(n_tiles) decodes
    for t in range(T):
        # one decode per frame for lazy sources, but NO np.asarray: an
        # mmap-backed store must stay a view here so each tile slice reads
        # only tile bytes (a 15000^2 x 40z frame is ~36 GB materialized)
        frame = store.data[t]  # (C, Z, Y, X)
        for y0 in range(0, Y, cs):
            for x0 in range(0, X, cs):
                chunk = frame[None, :, :, y0:y0 + cs, x0:x0 + cs]
                proj, zm = project_movie_array(
                    chunk, reference_channel=reference_channel, method=method,
                    bin_size=bin_size, build_manifold=build_manifold, min_z=min_z,
                    max_z=max_z, airyscan=airyscan, atoh_shift=channels_shift,
                    device=dev)
                projection[t, :, y0:y0 + cs, x0:x0 + cs] = proj[0]
                zmap[t, y0:y0 + cs, x0:x0 + cs] = zm[0]
    postfix = "." + input_file_name.split(".")[-1]
    proj_name = os.path.join(output_dir, input_file_name.replace(postfix, "_projection.tif"))
    zmap_name = os.path.join(output_dir, input_file_name.replace(postfix, "_zmap.npy"))
    axes = "TCYX" if T > 1 else "CYX"
    save_tiff(proj_name, projection if T > 1 else projection[0], axes=axes,
              data_type="uint16")
    np.save(zmap_name, zmap)
    return 1
