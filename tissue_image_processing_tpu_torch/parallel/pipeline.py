"""Frame-sharded image pipeline: proj -> seg -> cellinfo -> drift -> track.

Port of ``tissue_image_processing_tpu/parallel/pipeline.py``. The per-frame
pixel work (surface projection, segmentation, region properties) is
independent across the movie's T axis, so each shard of a 1-D ``("frame",)``
mesh takes T / n frames and runs them one after the other. On the card each
position uploads its own frames and runs them on a CUDA stream of its own
(:meth:`~.mesh.Mesh.run`), so one position's work overlaps the next one's;
on the CPU the positions run in order. Two small cross-frame exchanges
remain, after the positions have joined:

- drift needs each shard's previous frame: :func:`~.mesh.ppermute` sends
  each shard's last projected frame to the next shard (a frame halo of 1);
- tracking is a sequential pass over O(capacity) tables: the per-frame
  tables and drifts are gathered (:func:`~.mesh.all_gather`) onto the lead
  device and tracked there.

Each pipeline function returns ``fn(movie)`` taking numpy or a tensor and
returning (T, capacity) int32 ids on the lead device (the chunked form
returns a host array, as the JAX one does).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tissue_image_processing_tpu_torch.core.cell_table import frame_cellinfo
from tissue_image_processing_tpu_torch.core.tracking import (
    TrackingState, track_movie)
from tissue_image_processing_tpu_torch.models.predictor import (
    find_desired_shape, unet_postprocess)
from tissue_image_processing_tpu_torch.ops.brightness import normalize_channel
from tissue_image_processing_tpu_torch.ops.drift import phase_cross_correlation
from tissue_image_processing_tpu_torch.ops.watershed import (
    watershed_segmentation)
from tissue_image_processing_tpu_torch.parallel.mesh import (
    Mesh, _mesh_devices, _move, _object_array, all_gather, axis_index,
    ppermute, psum)
from tissue_image_processing_tpu_torch.projection.surface import (
    time_point_surface_projection)

__all__ = ["make_frame_mesh", "sharded_movie_pipeline",
           "sharded_unet_pipeline", "sharded_movie_pipeline_chunked"]


def make_frame_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh with a single ``frame`` axis over the first ``n_devices`` of
    ``devices`` (None: the visible CUDA cards)."""
    devs = _mesh_devices(n_devices, devices, "frame mesh")
    return Mesh(_object_array(devs, (len(devs),)), ("frame",))


def _map_frames(one_frame, shard: torch.Tensor):
    """``jax.lax.map``: ``one_frame`` on each frame of a shard, outputs
    stacked."""
    outs = [one_frame(frame) for frame in shard]
    return tuple(torch.stack(o) for o in zip(*outs))


def _shard_frames(one_frame, frames: torch.Tensor, device: torch.device):
    """One position's shard body: its (T / n, ...) frames uploaded to its
    device (non-blocking) and :func:`_map_frames` over them."""
    return _map_frames(one_frame, _move(frames, device))


def _map_shards(mesh: Mesh, one_frame, movie) -> list:
    """The (T, ...) movie split into T / n frames a shard, and each
    position's :func:`_shard_frames` run by :meth:`~.mesh.Mesh.run` (a
    stream each on the card). Returns the positions' outputs in order."""
    n = mesh.shape["frame"]
    if movie.shape[0] % n:
        raise ValueError(f"T={movie.shape[0]} must be divisible by the mesh's "
                         f"frame axis {n}")
    t = (movie if isinstance(movie, torch.Tensor)
         else torch.from_numpy(np.require(movie, requirements=["C", "W"])))
    return mesh.run(lambda frames, dev: _shard_frames(one_frame, frames, dev),
                    torch.chunk(t, n, 0), list(mesh.devices.reshape(-1)))


def _watershed_frame(reference_channel, threshold, std, block_size,
                     airyscan, capacity):
    def one_frame(stack):
        proj, _ = time_point_surface_projection(
            stack.to(torch.float32), reference_channel=reference_channel,
            airyscan=airyscan)
        ref = proj[reference_channel]
        labels = watershed_segmentation(ref, threshold, std, block_size)
        # tracking consumes positions/areas only; skip the adjacency
        table = frame_cellinfo(labels, capacity=capacity, with_neighbors=False)
        return ref, table.cy, table.cx, table.area, table.valid_mask()
    return one_frame


def _shifts(prev_first: Sequence[torch.Tensor], refs: Sequence[torch.Tensor],
            upsample_factor: int) -> List[torch.Tensor]:
    """Each shard's drift pairs: its frames against their predecessors, the
    first one's given by ``prev_first``."""
    return [phase_cross_correlation(torch.cat([p[None], r[:-1]]), r,
                                    upsample_factor=upsample_factor)
            for p, r in zip(prev_first, refs)]


def _drift_track_tail(ref, cy, cx, area, mask, upsample_factor, track_cap):
    """The pipeline tail over the shards' lists: a ppermute frame halo for
    drift, the O(capacity) tables gathered onto the lead device and the
    tracker run there."""
    n = len(ref)
    prev_last = ppermute([r[-1] for r in ref],
                         [(i, (i + 1) % n) for i in range(n)])
    shifts = _shifts(prev_last, ref, upsample_factor)
    cy_a, cx_a, area_a, mask_a, drifts = (
        all_gather(x)[0] for x in (cy, cx, area, mask, shifts))
    # global frame 0 has no predecessor (its ppermute input wrapped around)
    drifts = torch.cat([torch.zeros_like(drifts[:1]), drifts[1:]])
    return track_movie(cy_a, cx_a, area_a, mask_a, drifts=drifts,
                       capacity=track_cap)


def sharded_movie_pipeline(
    mesh: Mesh,
    capacity: int = 256,
    track_capacity: Optional[int] = None,
    reference_channel: int = 0,
    threshold: float = 0.2,
    std: float = 3.0,
    block_size: int = 101,
    airyscan: bool = False,
    upsample_factor: int = 100,
):
    """Build ``fn(movie) -> (T, capacity) track ids`` with the per-frame work
    sharded over the mesh's ``frame`` axis.

    ``movie``: (T, C, Z, H, W), T divisible by the mesh size. Per frame: the
    unfused ``time_point_surface_projection``, ``watershed_segmentation`` of
    the reference channel and ``frame_cellinfo`` without the neighbour
    graph; then the drift chain and ``track_movie`` on the lead device."""
    track_cap = track_capacity or 2 * capacity
    one_frame = _watershed_frame(reference_channel, threshold, std,
                                 block_size, airyscan, capacity)

    def fn(movie):
        outs = _map_shards(mesh, one_frame, movie)
        return _drift_track_tail(*map(list, zip(*outs)),
                                 upsample_factor=upsample_factor,
                                 track_cap=track_cap)
    return fn


def _sharded_segment_program(mesh, capacity, reference_channel, threshold,
                             std, block_size, airyscan, upsample_factor):
    """Frame-sharded segment stage of the chunked pipeline:
    ``fn(chunk, prev_ref) -> (cy, cx, area, mask, drifts, last_ref)`` on the
    lead device. The same per-frame work as :func:`sharded_movie_pipeline`
    with the tracker left out, so its state can carry across chunks; shard 0
    takes ``prev_ref`` (the previous chunk's last projected frame) as its
    drift predecessor instead of the ppermute wrap-around, and the chunk's
    last frame is broadcast through a psum of the last shard's frame."""
    n = mesh.shape["frame"]
    one_frame = _watershed_frame(reference_channel, threshold, std,
                                 block_size, airyscan, capacity)

    def fn(chunk, prev_ref):
        outs = _map_shards(mesh, one_frame, chunk)
        ref, cy, cx, area, mask = map(list, zip(*outs))
        prev_last = ppermute([r[-1] for r in ref],
                             [(i, (i + 1) % n) for i in range(n)])
        idx = [axis_index(mesh, "frame", pos)
               for pos in np.ndindex(mesh.devices.shape)]
        first_prev = [_move(prev_ref, p.device) if i == 0 else p
                      for i, p in zip(idx, prev_last)]
        shifts = _shifts(first_prev, ref, upsample_factor)
        gathered = [all_gather(x)[0] for x in (cy, cx, area, mask, shifts)]
        last = psum([r[-1] if i == n - 1 else torch.zeros_like(r[-1])
                     for i, r in zip(idx, ref)])[0]
        return (*gathered, last)
    return fn


def sharded_movie_pipeline_chunked(
    mesh: Mesh,
    store,
    chunk_frames: int,
    capacity: int = 256,
    track_capacity: Optional[int] = None,
    reference_channel: int = 0,
    threshold: float = 0.2,
    std: float = 3.0,
    block_size: int = 101,
    airyscan: bool = False,
    upsample_factor: int = 100,
    on_chunk=None,
):
    """Streaming form of :func:`sharded_movie_pipeline` for movies larger
    than the devices' memory: ``store`` (an object with ``.data``, such as
    ``io/movie.MovieStore``, or any (T, C, Z, Y, X) array) is read in
    ``chunk_frames``-frame chunks (a multiple of the mesh's frame axis).
    The tracker state, the cumulative drift and the boundary reference frame
    carry across chunks, so the ids equal the unchunked run's. The tail
    chunk is padded by repeating its last frame and masked out with
    ``frame_valid``. ``on_chunk(t0, ids)`` receives each chunk's real-frame
    ids. Returns the (T, capacity) ids as a host array."""
    n = mesh.shape["frame"]
    data = store.data if hasattr(store, "data") else store
    if len(data.shape) != 5:
        raise ValueError(f"movie must be (T, C, Z, Y, X), got {data.shape}")
    T = data.shape[0]
    C = max(1, min(int(chunk_frames), T))
    if C % n:
        raise ValueError(
            f"chunk_frames {C} must be a multiple of the mesh's frame axis {n}")
    track_cap = track_capacity or 2 * capacity
    seg = _sharded_segment_program(mesh, capacity, reference_channel,
                                   threshold, std, block_size, airyscan,
                                   upsample_factor)
    lead = mesh.lead
    state = TrackingState.empty(track_cap, lead)
    cum = torch.zeros(2, dtype=torch.float32, device=lead)
    prev_ref = torch.zeros((data.shape[3], data.shape[4]), dtype=torch.float32,
                           device=lead)
    ids_chunks = []
    for ci, t0 in enumerate(range(0, T, C)):
        real = min(C, T - t0)
        chunk = np.asarray(data[t0:t0 + real])
        if real < C:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], C - real, axis=0)], axis=0)
        cy, cx, area, mask, drifts, last_ref = seg(chunk, prev_ref)
        if ci == 0:   # frame 0 has no predecessor
            drifts = torch.cat([torch.zeros_like(drifts[:1]), drifts[1:]])
        valid = torch.zeros(C, dtype=torch.bool)
        valid[:real] = True
        valid = _move(valid, lead)
        mask = mask & valid[:, None]
        ids, state, cum = track_movie(
            cy, cx, area, mask, drifts=drifts, frame_valid=valid,
            capacity=track_cap, init_state=state, cum_drift_init=cum,
            return_state=True)
        prev_ref = last_ref
        ids_np = ids[:real].cpu().numpy()
        if on_chunk is not None:
            on_chunk(t0, ids_np)
        ids_chunks.append(ids_np)
    return np.concatenate(ids_chunks, axis=0)


def _replicated_models(mesh: Mesh, model, variables):
    """One inference copy of ``model`` with ``variables`` (a ``state_dict``
    or a module) on each distinct device of the mesh."""
    state = (variables.state_dict() if isinstance(variables, torch.nn.Module)
             else variables)
    nets = {}
    for dev in mesh.devices.reshape(-1):
        if dev not in nets:
            net = copy.deepcopy(model).to(dev)
            net.load_state_dict(state)
            nets[dev] = net.eval().requires_grad_(False)
    return nets


def sharded_unet_pipeline(
    mesh: Mesh,
    model,
    capacity: int = 256,
    track_capacity: Optional[int] = None,
    reference_channel: int = 0,
    airyscan: bool = False,
    upsample_factor: int = 100,
):
    """The U-Net variant of :func:`sharded_movie_pipeline`: proj ->
    normalise -> U-Net -> post-process -> cellinfo -> drift -> track,
    frame-sharded.

    ``model`` is a ``UNet`` (its architecture and dtype); the returned
    ``fn(variables, movie) -> (T, capacity) ids`` takes its weights as a
    ``state_dict`` or a module and replicates them: one copy on each
    distinct device of the mesh (a virtual mesh on one card holds one). Per
    frame, as ``SegmentationPredictor.prepare_image`` feeds the net: each
    channel normalised, the x-major transpose, a front pad to powers of
    two, the forward, the crop, ``unet_postprocess``, and the labels
    transposed back to (Y, X) for the table."""
    track_cap = track_capacity or 2 * capacity

    def one_frame(net, stack):
        proj, _ = time_point_surface_projection(
            stack.to(torch.float32), reference_channel=reference_channel,
            airyscan=airyscan)
        norm = torch.stack([normalize_channel(ch) for ch in proj])
        x_major = norm.permute(2, 1, 0)                 # (X, Y, C)
        sx, sy = x_major.shape[0], x_major.shape[1]
        px, py = find_desired_shape(sx, sy)
        padded = F.pad(x_major, (0, 0, py - sy, 0, px - sx, 0))
        with torch.no_grad():
            pred = net(padded[None])[0]
        pred = pred[px - sx:, py - sy:, :]
        labels, _hc = unet_postprocess(pred.to(torch.float32))
        labels = labels.T.contiguous()
        table = frame_cellinfo(labels, capacity=capacity, with_neighbors=False)
        return (proj[reference_channel], table.cy, table.cx, table.area,
                table.valid_mask())

    def fn(variables, movie):
        nets = _replicated_models(mesh, model, variables)
        outs = _map_shards(mesh, lambda s: one_frame(nets[s.device], s),
                           movie)
        return _drift_track_tail(*map(list, zip(*outs)),
                                 upsample_factor=upsample_factor,
                                 track_cap=track_cap)
    return fn
