"""Whole-movie pipeline: segmentation -> cell tables -> drift -> tracking.

Port of ``tissue_image_processing_tpu/core/pipeline.py`` (``movie_pipeline``
and ``movie_pipeline_chunked``) with three segmenters. A Z > 1 movie is
uploaded one (C, Z, Y, X) frame at a time and surface-projected
(``project_timepoint_auto``: the two fused projection kernels on the card).
A Z == 1 movie is pre-projected and skips this.

One segment body (``_Segmenter.segment``) serves the three segmenters
(``_Watershed``, ``_UNet``, ``_Cellpose``), which give only their labels.
Tables and the drift chain run as tensor code on the same device; one
tracking tail (``_track``), for a whole movie and each chunk alike, runs
the adaptive radii, one level sweep over the tables there (on the card the
``csrc/radii.cu`` kernels), and the tracker, frame by frame on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from tissue_image_processing_tpu_torch._device import count, resolve_device
from tissue_image_processing_tpu_torch.core.cell_table import (
    CellTable, frame_cellinfo_checked, stack_tables)
from tissue_image_processing_tpu_torch.core.tracking import (
    adaptive_radii, compute_drift_chain, track_movie)
from tissue_image_processing_tpu_torch.models.cellpose import CellposeRunner
from tissue_image_processing_tpu_torch.models.predictor import (
    prepare_batch, unet_from_config, unet_postprocess_batch)
from tissue_image_processing_tpu_torch.ops.flows import follow, frame_masks
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
    device synchronized on entry and exit; a no-op when ``timings`` is None
    (no synchronisation, no profiler event).

    With ``timings`` the block is also a ``stage.<name>`` event on the
    profiler's host timeline, opened after the entry synchronisation and
    closed after the exit one: it covers the interval that ``timings``
    adds up, and every kernel and copy of the stage lies inside it. The
    event is a ``_RecordFunctionFast`` range, not ``record_function``:
    the latter's user scope also leaves a device-side copy of the range in
    the profiler's results, which a reader of device events takes for a
    kernel as long as the stage. Stages are the only such spans: a span
    around a whole call or a group of stages would become the host's one
    outermost operation, and ``benchmark/trace.py`` lays idle gaps and
    copies to outermost operations only, so it would hide the stages."""
    if timings is None:
        yield
        return
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch._C._profiler._RecordFunctionFast(f"stage.{name}"):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def _upload(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (numpy or a tensor) on ``device`` as ``dtype``; its bytes, as
    given, are added to ``COUNTS["upload_bytes"]`` unless it is already a
    tensor on a device of that kind."""
    if isinstance(x, torch.Tensor):
        if x.device.type != torch.device(device).type:
            count("upload_bytes", x.nbytes)
        return x.to(device=device, dtype=dtype)
    x = np.ascontiguousarray(x)
    count("upload_bytes", x.nbytes)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


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


@dataclasses.dataclass
class _Segmenter:
    """A run's segment body: the projections of the channels ``keep``
    (None: all), from which ``frames`` picks the frames to segment and to
    measure drift on; the subclass's ``labels(frames, timings)`` gives (T,
    X, Y) labels. The defaults are the models': the y-major projection,
    drifts column-swapped (``flip``) to the labels' x-major space, since a
    transposed image's phase shift is the swapped component pair."""

    dev: torch.device
    reference_channel: int
    airyscan: bool
    capacity: int
    keep = None
    flip = True

    def frames(self, prj: torch.Tensor):
        return prj, prj[:, self.reference_channel]

    def segment(self, movie, prev_ref: Optional[torch.Tensor],
                timings: Optional[Dict[str, float]] = None):
        """Labels, tables, drifts, neighbour-overflow flags and the frame to
        carry; ``prev_ref`` (the previous chunk's carried frame) makes
        drift[0] the chunk-boundary shift."""
        frames, refs = self.frames(_projections(
            movie, self.reference_channel, self.dev, self.airyscan, timings,
            self.keep))
        labels = self.labels(frames, timings)
        tabs, overflow = _tables(labels, self.capacity, timings)
        drifts = _drifts(refs, prev_ref, timings)
        if self.flip:
            drifts = drifts.flip(1)
        return labels, tabs, drifts, overflow, refs[-1]


@dataclasses.dataclass
class _Watershed(_Segmenter):
    """Threshold, blur and the row-stacked flood on the reference channel's
    x-major frames, ``batch`` at a time (the last group ragged); the drifts
    are measured on the same frames, unswapped."""

    threshold: float
    std: float
    block_size: int
    batch: int
    flip = False

    @property
    def keep(self):
        return [self.reference_channel]

    def frames(self, prj):
        refs_t = prj[:, 0].transpose(1, 2).contiguous()
        return refs_t, refs_t

    def labels(self, refs_t, timings):
        T, dev = refs_t.shape[0], refs_t.device
        B = max(1, min(self.batch, T))
        with _span(timings, "segment", dev):
            return torch.cat([watershed_segmentation_batch(
                refs_t[i:i + B], self.threshold, self.std, self.block_size)
                for i in range(0, T, B)])


@dataclasses.dataclass
class _UNet(_Segmenter):
    """The U-Net on (atoh, zo) projections: per-channel 1-99 percentile
    normalisation, then per group of ``_flood_batch(T, batch)`` frames the
    forward in bfloat16 (or int8, ``quantized``), the morphology
    post-process and ONE stacked binary flood of the boundary maps
    (zero-set seeds by the segmented-scan kernel). Labels are x-major."""

    model: Callable[[torch.Tensor], torch.Tensor]
    batch: int

    def labels(self, prj, timings):
        T, dev = prj.shape[0], prj.device
        with _span(timings, "normalize", dev):
            x, (pad_x, pad_y) = prepare_batch(prj)
            x = x.to(torch.bfloat16)
        B = _flood_batch(T, self.batch)
        labels = []
        for i in range(0, T, B):
            with _span(timings, "unet", dev), torch.no_grad():
                preds = self.model(x[i:i + B])[:, pad_x:, pad_y:, :]
            with _span(timings, "postprocess", dev):
                labels.append(unet_postprocess_batch(preds)[0])
        return torch.cat(labels)


@dataclasses.dataclass
class _Cellpose(_Segmenter):
    """Cellpose v2: flows from tiles of ``runner.batch`` frames at once
    (spans ``cp_tiles`` around the tiles' making and blending, ``cpnet``
    around the forward), followed in one launch a group
    (``csrc/follow_flows.cu``), then a frame at a time the histogram masks,
    the flow check and the hole filling (``ops/flows.py:frame_masks``).
    Labels are x-major."""

    runner: CellposeRunner

    def labels(self, prj, timings):
        r, dev = self.runner, prj.device
        Y, X = prj.shape[-2:]

        def span(name):
            return _span(timings, name, dev)
        labels = []
        for i in range(0, prj.shape[0], r.batch):
            with span("cp_tiles"):
                tiles = r.tiles(prj[i:i + r.batch])
            with span("cpnet"):
                y = r.forward(tiles)
            with span("cp_tiles"):
                flows = r.blend(y, Y, X)
            del tiles, y
            with span("follow"):
                p, m, followed = follow(flows[:, :2], flows[:, 2], r.niter,
                                        r.cellprob_threshold)
            labels.append(torch.stack([
                frame_masks(p[j], m[j], flows[j, :2], int(followed[j]),
                            r.flow_threshold, r.min_size, span)
                for j in range(flows.shape[0])]).transpose(1, 2).contiguous())
            del p, m, followed, flows
        return torch.cat(labels)


def _segmenter(dev: torch.device, unet: Optional[dict],
               reference_channel: int, threshold: float, std: float,
               block_size: int, capacity: int, batch: int, airyscan: bool,
               cellpose: Optional[dict] = None) -> _Segmenter:
    """The segmenter of one run: the U-Net when a ``unet`` configuration is
    given, Cellpose when a ``cellpose`` one is (either model is built once,
    here), else the watershed."""
    if unet is not None and cellpose is not None:
        raise ValueError("give unet= or cellpose=, not both")
    common = (dev, reference_channel, airyscan, capacity)
    if cellpose is not None:
        return _Cellpose(*common, CellposeRunner(cellpose, dev))
    if unet is not None:
        return _UNet(*common, unet_from_config(unet, dev),
                     unet.get("batch", 8))
    return _Watershed(*common, threshold, std, block_size, batch)


def _track(tabs: CellTable, drifts, search_range: float, memory: int,
           capacity: int, timings: Optional[Dict[str, float]] = None,
           carry: Optional[tuple] = None):
    """Adaptive radii and (T, N) track ids of stacked tables with (T, 2)
    drifts, numpy or a tensor. A chunk of a chunked run passes ``carry``,
    the previous chunk's (radii carry, tracker state, cumulative drift) or
    (None, None, None) for the first, and gets ``(ids, carry)`` for the next
    chunk; a whole movie passes none and gets the ids."""
    chunked = carry is not None
    radii_carry, state, cum = carry if chunked else (None, None, None)
    dev = tabs.cy.device
    with _span(timings, "adaptive_radii", dev):
        mask = tabs.valid_mask()
        ranges = adaptive_radii(tabs.cy, tabs.cx, tabs.area, mask,
                                drifts=drifts, search_range=search_range,
                                carry=radii_carry, return_carry=chunked)
    if chunked:
        ranges, radii_carry = ranges
    with _span(timings, "track", dev):
        ids = track_movie(
            tabs.cy, tabs.cx, tabs.area, mask,
            drifts=torch.as_tensor(drifts, dtype=torch.float32, device=dev),
            search_range=search_range, memory=memory, capacity=2 * capacity,
            search_ranges=ranges, init_state=state, cum_drift_init=cum,
            return_state=chunked)
    if not chunked:
        return ids
    ids, state, cum = ids
    return ids, (radii_carry, state, cum)


def movie_pipeline(movie, *, reference_channel: int = 0,
                   threshold: float = 0.2, std: float = 3.0,
                   block_size: int = 101, capacity: int = 1024,
                   batch: int = 2, airyscan: bool = False,
                   search_range: float = 100.0,
                   memory: int = 3, drifts: Optional[np.ndarray] = None,
                   unet: Optional[dict] = None,
                   cellpose: Optional[dict] = None, device=None,
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
    (atoh, zo). With ``"quantized": True`` ``params`` holds the int8
    parameters (``models/quant.py:quantize_unet``) and the forward is
    ``unet_int8_apply``'s, its 3x3 convs the ``conv3x3_s8`` kernel.

    ``cellpose`` segments with Cellpose v2: a dict from
    :meth:`CellposePredictor.pipeline_config` (``params``, a ``CPnet``
    ``state_dict``, and ``diameter``, ``channels`` — the frame's (membrane,
    nucleus) indices —, ``batch``, ``niter`` and the thresholds).

    A ``timings`` dict receives the seconds of each stage (upload, project
    when Z > 1, segment — or normalize, unet and postprocess on the U-Net
    branch, cp_tiles, cpnet, follow, masks and flow_qc on the Cellpose
    branch — tables, drift, adaptive_radii, track), each ending in a device
    synchronize, and makes each stage a ``stage.<name>`` event of the
    profiler (``_span``): a call with ``timings={}`` inside
    ``utils/runtime.trace()`` gives a Chrome trace in which each stage is a
    ``stage.*`` range over its kernels and copies."""
    _check_movie(movie.shape)
    seg = _segmenter(resolve_device(device), unet, reference_channel,
                     threshold, std, block_size, capacity, batch, airyscan,
                     cellpose)
    labels, tabs, dr, overflow, _ = seg.segment(movie, None, timings)
    if drifts is not None:
        dr = drifts
    ids = _track(tabs, dr, search_range, memory, capacity, timings)
    if drifts is None:
        drifts = dr.cpu().numpy()
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
                           cellpose: Optional[dict] = None,
                           channels: Optional[Sequence[int]] = None,
                           device=None):
    """Streaming form of :func:`movie_pipeline` for movies larger than the
    card's memory: ``store`` (an object with ``.data`` or any (T, C, Z, Y, X)
    array or memmap) is read in ``chunk_frames``-frame chunks, carrying
    across boundaries the tracker state and cumulative drift, the previous
    chunk's last (projected) reference frame (so drift[0] of a chunk is the
    boundary shift) and the adaptive radii's ``RadiiCarry`` — chunked ids,
    labels and tables equal the whole-movie run's exactly.

    ``on_chunk(t0, chunk_dict)`` receives each chunk's host arrays; with
    ``keep_labels=False`` (or an ``on_chunk``) labels are not kept.
    ``unet`` segments with the U-Net and ``cellpose`` with Cellpose (see
    :func:`movie_pipeline`);
    ``channels`` selects channels of each host chunk before upload, for
    example the (atoh, zo) pair the model expects. Returns the same dict as
    :func:`movie_pipeline` with host arrays (``labels`` is None when not
    kept)."""
    data = store.data if hasattr(store, "data") else store
    _check_movie(data.shape)
    seg = _segmenter(resolve_device(device), unet, reference_channel,
                     threshold, std, block_size, capacity, batch, airyscan,
                     cellpose)
    T = data.shape[0]
    C = max(1, min(int(chunk_frames), T))
    carry, prev_ref = (None, None, None), None
    all_ids, all_tabs, all_drifts, all_over, all_labels = [], [], [], [], []
    for t0 in range(0, T, C):
        chunk = np.asarray(data[t0:t0 + C])
        if channels is not None:
            chunk = chunk[:, list(channels)]
        labels, tabs, dr, overflow, prev_ref = seg.segment(chunk, prev_ref)
        ids, carry = _track(tabs, dr, search_range, memory, capacity,
                            carry=carry)
        host = tabs.map(lambda x: x.cpu())
        drifts = dr.cpu().numpy()
        # labels reach the host only for someone who keeps or receives them
        keep = on_chunk is not None or keep_labels
        chunk_out = {"t0": t0, "labels": labels.cpu().numpy() if keep else None,
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
