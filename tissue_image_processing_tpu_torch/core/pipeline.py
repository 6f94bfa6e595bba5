"""Whole-movie pipeline: watershed segmentation -> cell tables -> drift ->
tracking.

Port of ``tissue_image_processing_tpu/core/pipeline.py`` (``movie_pipeline``
and ``movie_pipeline_chunked``) on the watershed branch. A Z > 1 movie is
uploaded one (C, Z, Y, X) frame at a time and surface-projected
(``project_timepoint_auto``: the two fused projection kernels on the card);
only the reference channel's (Y, X) projection is kept. A Z == 1 movie is
pre-projected and skips this. Frames flood in row-stacked batches through the
CUDA flood kernels, tables and the drift chain run as tensor code on the same
device, the adaptive radii take one host pass over the tables, and the
tracker links frame by frame on the device.

The U-Net branch belongs to a later slice of the port and raises
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tissue_image_processing_tpu_torch._device import resolve_device
from tissue_image_processing_tpu_torch.core.cell_table import (
    CellTable, frame_cellinfo_checked, stack_tables)
from tissue_image_processing_tpu_torch.core.tracking import (
    TrackingState, adaptive_effective_ranges, compute_drift_chain, track_movie)
from tissue_image_processing_tpu_torch.ops.watershed import (
    watershed_segmentation_batch)
from tissue_image_processing_tpu_torch.projection.surface import (
    project_timepoint_auto)

__all__ = ["movie_pipeline", "movie_pipeline_chunked"]


def _check_branch(shape, unet) -> None:
    if len(shape) != 5:
        raise ValueError(f"movie must be (T, C, Z, Y, X), got {tuple(shape)}")
    if unet is not None:
        raise NotImplementedError(
            "the U-Net segmentation branch is ported in a later slice")


@contextlib.contextmanager
def _span(timings: Optional[Dict[str, float]], name: str, dev: torch.device):
    """Add the host-clock seconds of the block to ``timings[name]``, the
    device synchronized on entry and exit; a no-op when ``timings`` is None."""
    if timings is None:
        yield
        return
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def _upload(x, device: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                        dtype=dtype)


def _reference_frames(movie, reference_channel: int, device: torch.device,
                      airyscan: bool = False,
                      timings: Optional[Dict[str, float]] = None
                      ) -> torch.Tensor:
    """(T, X, Y) float32 reference frames in the reference's x-major space.
    A Z > 1 movie is uploaded one frame at a time and projected; only the
    reference channel's projection is kept."""
    if movie.shape[2] == 1:
        with _span(timings, "upload", device):
            ref = _upload(movie[:, reference_channel, 0], device, torch.float32)
            return ref.transpose(1, 2).contiguous()
    refs = []
    for t in range(movie.shape[0]):
        with _span(timings, "upload", device):
            stack = _upload(movie[t], device)
        with _span(timings, "project", device):
            proj, _ = project_timepoint_auto(
                stack, reference_channel=reference_channel, airyscan=airyscan)
            refs.append(proj[reference_channel])
    return torch.stack(refs).transpose(1, 2).contiguous()


def _segment_program(refs_t: torch.Tensor, prev_ref: Optional[torch.Tensor],
                     threshold: float, std: float, block_size: int,
                     capacity: int, batch: int,
                     timings: Optional[Dict[str, float]] = None):
    """Labels, tables, drifts and neighbour-overflow flags of a run of
    frames; ``prev_ref`` (the previous chunk's last reference frame) makes
    drift[0] the chunk-boundary shift."""
    T, dev = refs_t.shape[0], refs_t.device
    B = max(1, min(batch, T))
    with _span(timings, "segment", dev):
        labels = torch.cat([watershed_segmentation_batch(
            refs_t[i:i + B], threshold, std, block_size)
            for i in range(0, T, B)])
    # compacted adjacency votes (exact for <= 192 vote runs per label row);
    # the per-frame overflow flags tell the caller which frames to recompute
    # with frame_cellinfo(..., neighbor_compact_k=None)
    with _span(timings, "tables", dev):
        per_frame = [frame_cellinfo_checked(lab, capacity=capacity,
                                            neighbor_compact_k=192)
                     for lab in labels]
        tabs = stack_tables([tab for tab, _ in per_frame])
        overflow = torch.stack([over for _, over in per_frame])
    with _span(timings, "drift", dev):
        if prev_ref is None:
            drifts = compute_drift_chain(refs_t)
        else:
            drifts = compute_drift_chain(
                torch.cat([prev_ref[None], refs_t]))[1:]
    return labels, tabs, drifts, overflow


def movie_pipeline(movie, *, reference_channel: int = 0,
                   threshold: float = 0.2, std: float = 3.0,
                   block_size: int = 101, capacity: int = 1024,
                   batch: int = 2, airyscan: bool = False,
                   search_range: float = 100.0,
                   memory: int = 3, drifts: Optional[np.ndarray] = None,
                   unet: Optional[dict] = None, device=None,
                   timings: Optional[Dict[str, float]] = None):
    """(T, C, Z, Y, X) movie (numpy array or tensor, uint16 or float) ->
    dict with per-frame ``labels`` (T, X, Y — the reference's transposed
    convention, a tensor on ``device``), stacked ``tables`` (CellTable of
    (T, capacity) tensors), ``drifts`` (T, 2), tracked ``ids`` (T, capacity;
    0 = no cell) and the per-frame ``neighbor_overflow`` flags.
    ``device=None`` runs on CUDA. Z > 1 movies are surface-projected first
    (``airyscan`` subtracts the airyscan offset there); Z == 1 skips it.

    A ``timings`` dict receives the seconds of each stage (upload, project
    when Z > 1, segment, tables, drift, adaptive_radii, track), each ending
    in a device synchronize."""
    _check_branch(movie.shape, unet)
    dev = resolve_device(device)
    refs_t = _reference_frames(movie, reference_channel, dev, airyscan, timings)
    labels, tabs, dr, overflow = _segment_program(
        refs_t, None, threshold, std, block_size, capacity, batch, timings)
    with _span(timings, "adaptive_radii", dev):
        if drifts is None:
            drifts = dr.cpu().numpy()
        host = tabs.map(lambda x: x.cpu())
        mask = host.valid_mask().numpy()
        ranges = adaptive_effective_ranges(
            host.cy.numpy(), host.cx.numpy(), host.area.numpy(), mask,
            drifts=drifts, search_range=search_range, per_cell=True)
    with _span(timings, "track", dev):
        ids = track_movie(tabs.cy, tabs.cx, tabs.area, tabs.valid_mask(),
                          drifts=torch.as_tensor(drifts, dtype=torch.float32,
                                                 device=dev),
                          search_range=search_range, memory=memory,
                          capacity=2 * capacity,
                          search_ranges=torch.as_tensor(
                              ranges, dtype=torch.float32, device=dev))
    return {"labels": labels, "tables": tabs, "drifts": drifts,
            "ids": ids.cpu().numpy(),
            "neighbor_overflow": overflow.cpu().numpy()}


def movie_pipeline_chunked(store, *, chunk_frames: int,
                           reference_channel: int = 0, threshold: float = 0.2,
                           std: float = 3.0, block_size: int = 101,
                           capacity: int = 1024, batch: int = 2,
                           airyscan: bool = False,
                           search_range: float = 100.0, memory: int = 3,
                           on_chunk=None, keep_labels: bool = True,
                           unet: Optional[dict] = None,
                           channels: Optional[Sequence[int]] = None,
                           device=None):
    """Streaming form of :func:`movie_pipeline` for movies larger than the
    card's memory: ``store`` (an object with ``.data`` or any (T, C, Z, Y, X)
    array or memmap) is read in ``chunk_frames``-frame chunks, carrying
    across boundaries the tracker state and cumulative drift, the previous
    chunk's last (projected) reference frame (so drift[0] of a chunk is the
    boundary shift) and the adaptive-radius point set — chunked ids, labels
    and tables equal the whole-movie run's exactly.

    ``on_chunk(t0, chunk_dict)`` receives each chunk's host arrays; with
    ``keep_labels=False`` (or an ``on_chunk``) labels are not kept.
    ``channels`` selects channels of each host chunk before upload. Returns
    the same dict as :func:`movie_pipeline` with host arrays (``labels`` is
    None when not kept)."""
    data = store.data if hasattr(store, "data") else store
    shape = tuple(data.shape)
    if channels is not None and len(shape) == 5:
        shape = (shape[0], len(channels)) + shape[2:]
    _check_branch(shape, unet)
    dev = resolve_device(device)
    T = shape[0]
    C = max(1, min(int(chunk_frames), T))
    state = TrackingState.empty(2 * capacity, dev)
    cum = torch.zeros(2, dtype=torch.float32, device=dev)
    prev_pts, prev_ref, ranges_cum = None, None, None
    all_ids, all_tabs, all_drifts, all_over, all_labels = [], [], [], [], []
    for t0 in range(0, T, C):
        chunk = np.asarray(data[t0:t0 + C])
        if channels is not None:
            chunk = chunk[:, list(channels)]
        refs_t = _reference_frames(chunk, reference_channel, dev, airyscan)
        labels, tabs, dr, overflow = _segment_program(
            refs_t, prev_ref, threshold, std, block_size, capacity, batch)
        prev_ref = refs_t[-1]
        host = tabs.map(lambda x: x.cpu())
        drifts = dr.cpu().numpy()
        mask = host.valid_mask().numpy()
        ranges, prev_pts, ranges_cum = adaptive_effective_ranges(
            host.cy.numpy(), host.cx.numpy(), host.area.numpy(), mask,
            drifts=drifts, search_range=search_range, prev_points=prev_pts,
            cum_drift_init=ranges_cum, return_carry=True, per_cell=True)
        ids, state, cum = track_movie(
            tabs.cy, tabs.cx, tabs.area, tabs.valid_mask(),
            drifts=dr, search_range=search_range, memory=memory,
            capacity=2 * capacity,
            search_ranges=torch.as_tensor(ranges, dtype=torch.float32,
                                          device=dev),
            init_state=state, cum_drift_init=cum, return_state=True)
        chunk_out = {"t0": t0, "labels": labels.cpu().numpy(),
                     "tables": host, "ids": ids.cpu().numpy(),
                     "drifts": drifts,
                     "neighbor_overflow": overflow.cpu().numpy()}
        if on_chunk is not None:
            on_chunk(t0, chunk_out)
        elif keep_labels:
            all_labels.append(chunk_out["labels"])
        all_ids.append(chunk_out["ids"])
        all_tabs.append(host)
        all_drifts.append(drifts)
        all_over.append(chunk_out["neighbor_overflow"])
    tables: CellTable = stack_tables(all_tabs, cat=True)
    return {"labels": np.concatenate(all_labels, 0) if all_labels else None,
            "tables": tables, "drifts": np.concatenate(all_drifts, 0),
            "ids": np.concatenate(all_ids, 0),
            "neighbor_overflow": np.concatenate(all_over, 0)}
