"""Whole-movie pipeline: segmentation -> cell tables -> drift -> tracking.

Port of ``tissue_image_processing_tpu/core/pipeline.py`` (``movie_pipeline``
and ``movie_pipeline_chunked``) with both segmenters. A Z > 1 movie is
uploaded one (C, Z, Y, X) frame at a time and surface-projected
(``project_timepoint_auto``: the two fused projection kernels on the card).
A Z == 1 movie is pre-projected and skips this.

- The watershed branch keeps only the reference channel's projection;
  frames go through threshold, blur and the row-stacked flood in batches.
- The U-Net branch (``unet=``) keeps every channel (the model input is the
  (atoh, zo) pair): per-channel 1-99 percentile normalisation, the U-Net
  forward in bfloat16 on groups of frames, the morphology post-process, and
  each group's boundary maps through ONE stacked binary flood (zero-set
  seeds by the segmented-scan kernel, no Bellman-Ford phase). Its labels
  live in x-major space while its drift chain runs on the y-major
  projection, with the two drift columns swapped to match.

Tables and the drift chain run as tensor code on the same device, the
adaptive radii take one host pass over the tables, and the tracker links
frame by frame on the device.
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
from tissue_image_processing_tpu_torch.models.predictor import (
    prepare_batch, unet_from_config, unet_postprocess_batch)
from tissue_image_processing_tpu_torch.ops.watershed import (
    watershed_segmentation_batch)
from tissue_image_processing_tpu_torch.projection.surface import (
    project_timepoint_auto)

__all__ = ["movie_pipeline", "movie_pipeline_chunked"]


def _check_movie(shape) -> None:
    if len(shape) != 5:
        raise ValueError(f"movie must be (T, C, Z, Y, X), got {tuple(shape)}")


def _flood_batch(T: int, batch: int) -> int:
    """Largest group size <= ``batch`` that divides T."""
    b = max(1, min(batch, T))
    while T % b:
        b -= 1
    return b


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


def _projections(movie, reference_channel: int, device: torch.device,
                 airyscan: bool = False,
                 timings: Optional[Dict[str, float]] = None,
                 keep: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(T, C', Y, X) float32 projections of the channels ``keep`` (None: all).
    A Z > 1 movie is uploaded one frame at a time and projected; a Z == 1
    movie uploads the kept channels' single plane."""
    if movie.shape[2] == 1:
        planes = movie[:, :, 0] if keep is None else movie[:, list(keep), 0]
        with _span(timings, "upload", device):
            return _upload(planes, device, torch.float32)
    out = []
    for t in range(movie.shape[0]):
        with _span(timings, "upload", device):
            stack = _upload(movie[t], device)
        with _span(timings, "project", device):
            proj, _ = project_timepoint_auto(
                stack, reference_channel=reference_channel, airyscan=airyscan)
            out.append(proj if keep is None else proj[list(keep)])
    return torch.stack(out)


def _reference_frames(movie, reference_channel: int, device: torch.device,
                      airyscan: bool = False,
                      timings: Optional[Dict[str, float]] = None
                      ) -> torch.Tensor:
    """(T, X, Y) float32 reference frames in the reference's x-major space:
    only the reference channel's projection is kept."""
    prj = _projections(movie, reference_channel, device, airyscan, timings,
                       keep=[reference_channel])
    return prj[:, 0].transpose(1, 2).contiguous()


def _tables(labels: torch.Tensor, capacity: int,
            timings: Optional[Dict[str, float]]):
    """Stacked cell tables and neighbour-overflow flags of (T, H, W) labels.
    The adjacency votes are compacted (exact for <= 192 vote runs per label
    row); the per-frame overflow flags tell the caller which frames to
    recompute with ``frame_cellinfo(..., neighbor_compact_k=None)``."""
    with _span(timings, "tables", labels.device):
        per_frame = [frame_cellinfo_checked(lab, capacity=capacity,
                                            neighbor_compact_k=192)
                     for lab in labels]
        tabs = stack_tables([tab for tab, _ in per_frame])
        overflow = torch.stack([over for _, over in per_frame])
    return tabs, overflow


def _drifts(refs: torch.Tensor, prev_ref: Optional[torch.Tensor],
            timings: Optional[Dict[str, float]]) -> torch.Tensor:
    """Drift chain of (T, H, W) frames; ``prev_ref`` (the previous chunk's
    last frame) makes drift[0] the chunk-boundary shift."""
    with _span(timings, "drift", refs.device):
        if prev_ref is None:
            return compute_drift_chain(refs)
        return compute_drift_chain(torch.cat([prev_ref[None], refs]))[1:]


def _segment_program(refs_t: torch.Tensor, prev_ref: Optional[torch.Tensor],
                     threshold: float, std: float, block_size: int,
                     capacity: int, batch: int,
                     timings: Optional[Dict[str, float]] = None):
    """Watershed segmenter: labels, tables, drifts, neighbour-overflow flags
    and the frame to carry of a run of x-major reference frames; ``prev_ref``
    (the previous chunk's carried frame) makes drift[0] the chunk-boundary
    shift."""
    T, dev = refs_t.shape[0], refs_t.device
    B = max(1, min(batch, T))
    with _span(timings, "segment", dev):
        labels = torch.cat([watershed_segmentation_batch(
            refs_t[i:i + B], threshold, std, block_size)
            for i in range(0, T, B)])
    tabs, overflow = _tables(labels, capacity, timings)
    drifts = _drifts(refs_t, prev_ref, timings)
    return labels, tabs, drifts, overflow, refs_t[-1]


def _segment_program_unet(prj: torch.Tensor, model,
                          prev_ref: Optional[torch.Tensor],
                          reference_channel: int, capacity: int, batch: int,
                          timings: Optional[Dict[str, float]] = None):
    """U-Net twin of :func:`_segment_program` on (T, C, Y, X) projections
    with channels ordered (atoh, zo), the model's input order. Frames go
    through the model in groups of ``_flood_batch(T, batch)`` and each
    group's boundary maps flood as one stacked image. Labels come back in
    x-major (X, Y) space; the drifts are measured on the y-major projection
    (the carried frame is y-major too) and column-swapped to match: a
    transposed image's phase shift is the swapped component pair."""
    T, dev = prj.shape[0], prj.device
    with _span(timings, "normalize", dev):
        x, (pad_x, pad_y) = prepare_batch(prj)
        x = x.to(torch.bfloat16)
    B = _flood_batch(T, batch)
    labels = []
    for i in range(0, T, B):
        with _span(timings, "unet", dev), torch.no_grad():
            preds = model(x[i:i + B])[:, pad_x:, pad_y:, :]
        with _span(timings, "postprocess", dev):
            labels.append(unet_postprocess_batch(preds)[0])
    labels = torch.cat(labels)
    tabs, overflow = _tables(labels, capacity, timings)
    refs = prj[:, reference_channel]
    drifts = _drifts(refs, prev_ref, timings).flip(1)
    return labels, tabs, drifts, overflow, refs[-1]


def _segmenter(dev: torch.device, unet: Optional[dict],
               reference_channel: int, threshold: float, std: float,
               block_size: int, capacity: int, batch: int, airyscan: bool):
    """``segment(movie, prev_ref, timings=None)`` for one run: projects a
    (T, C, Z, Y, X) run of frames and segments it with the U-Net when a
    ``unet`` configuration is given (the model is built once, here), else
    with the watershed. Returns labels, tables, drifts, overflow flags and
    the frame the next chunk's drift chain starts from."""
    if unet is None:
        def segment(movie, prev_ref, timings=None):
            refs_t = _reference_frames(movie, reference_channel, dev, airyscan,
                                       timings)
            return _segment_program(refs_t, prev_ref, threshold, std,
                                    block_size, capacity, batch, timings)
        return segment
    model = unet_from_config(unet, dev)
    unet_batch = unet.get("batch", 8)

    def segment(movie, prev_ref, timings=None):
        prj = _projections(movie, reference_channel, dev, airyscan, timings)
        return _segment_program_unet(prj, model, prev_ref, reference_channel,
                                     capacity, unet_batch, timings)
    return segment


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

    ``unet`` segments with the U-Net instead of the watershed: a dict from
    :meth:`SegmentationPredictor.pipeline_config` (``params``, a ``UNet``
    ``state_dict``, and the static model description ``depth``,
    ``base_filters``, ``norm``, plus ``batch``, the frames per forward and
    stacked flood, default 8); the movie's channels must then be
    (atoh, zo). ``{"quantized": True}`` raises ``NotImplementedError``.

    A ``timings`` dict receives the seconds of each stage (upload, project
    when Z > 1, segment — or normalize, unet and postprocess on the U-Net
    branch — tables, drift, adaptive_radii, track), each ending in a device
    synchronize."""
    _check_movie(movie.shape)
    dev = resolve_device(device)
    segment = _segmenter(dev, unet, reference_channel, threshold, std,
                         block_size, capacity, batch, airyscan)
    labels, tabs, dr, overflow, _ = segment(movie, None, timings)
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
    ``unet`` segments with the U-Net (see :func:`movie_pipeline`);
    ``channels`` selects channels of each host chunk before upload, for
    example the (atoh, zo) pair the model expects. Returns the same dict as
    :func:`movie_pipeline` with host arrays (``labels`` is None when not
    kept)."""
    data = store.data if hasattr(store, "data") else store
    _check_movie(data.shape)
    dev = resolve_device(device)
    segment = _segmenter(dev, unet, reference_channel, threshold, std,
                         block_size, capacity, batch, airyscan)
    T = data.shape[0]
    C = max(1, min(int(chunk_frames), T))
    state = TrackingState.empty(2 * capacity, dev)
    cum = torch.zeros(2, dtype=torch.float32, device=dev)
    prev_pts, prev_ref, ranges_cum = None, None, None
    all_ids, all_tabs, all_drifts, all_over, all_labels = [], [], [], [], []
    for t0 in range(0, T, C):
        chunk = np.asarray(data[t0:t0 + C])
        if channels is not None:
            chunk = chunk[:, list(channels)]
        labels, tabs, dr, overflow, prev_ref = segment(chunk, prev_ref)
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
