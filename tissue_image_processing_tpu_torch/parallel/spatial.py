"""Space-axis sharding: the projection stencils over a ("frame", "y", "x") mesh.

Port of ``tissue_image_processing_tpu/parallel/spatial.py``. A frame's raw
(C, Z, Y, X) stack, ~50x its projected output, is split over rows (``y``)
and columns (``x``); frames split over ``frame``. A frame's space shards are
a 2-D numpy object array of tensors, ``grid[iy, ix]`` on its mesh device,
and every stage below runs over the whole grid before the next starts:

- the 95% clip is a distributed exact order statistic: the order-isomorphic
  int32 bisection of ``ops/percentile.py`` with each of the 32 compare and
  count passes summed over the shards (:func:`~.mesh.psum`), selecting the
  same global rows as the unsharded subsample above ``_EXACT_SORT_LIMIT``;
- every stencil (the sigma (0.5, 1, 1) pre-blur, the sigma (0.5, 30, 30)
  score blur, the sigma (1, 2, 2) one-hot mask blur) exchanges a row halo
  over ``y`` and a column halo over ``x`` of its own input (global edges
  replicate the edge pixels, the blurs' 'nearest' boundary). Columns go
  first, so the row exchange carries the corners;
- argmax over z, the mask product and the per-channel max are pointwise in
  (y, x).

Every per-shard step runs through :meth:`~.mesh.Mesh.run` (on the card, a
stream a mesh position); the exchanges and the clip's counts run between
those steps, on the caller's streams.

Each stage exchanges the halo of its own input — 4 px for the pre-blur,
120 px for the score blur, 8 px of the int height map. Folding them into
one raw-input exchange is wrong at global edges: blur2(blur1(x)) under
'nearest' pads blur1's output, which is not blur1 of the padded input. When
a halo exceeds the shard (tiny shapes), the exchange gathers the whole axis
and slices the window instead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from tissue_image_processing_tpu_torch.ops.filters import gaussian_blur
from tissue_image_processing_tpu_torch.ops.percentile import (
    _EXACT_SORT_LIMIT, _I32_MAX, _I32_MIN, _q_frac)
from tissue_image_processing_tpu_torch.parallel.mesh import (
    Mesh, _mesh_devices, _move, _object_array, all_gather, ppermute, psum)

__all__ = ["make_space_mesh", "sharded_projection", "masked_percentile_psum",
           "clip_percentile_sharded"]


def make_space_mesh(n_devices: Optional[int] = None,
                    frame_shards: Optional[int] = None,
                    x_shards: int = 1, devices=None) -> Mesh:
    """("frame", "y", "x") mesh over the first ``n_devices`` of ``devices``
    (None: the visible CUDA cards). ``frame_shards`` defaults to 1; the
    leftover devices split over rows, with ``x_shards`` of them on
    columns."""
    devs = _mesh_devices(n_devices, devices, "space mesh")
    n = len(devs)
    f = frame_shards or 1
    if n % (f * x_shards):
        raise ValueError(f"frame_shards {f} x x_shards {x_shards} must divide "
                         f"device count {n}")
    return Mesh(_object_array(devs, (f, n // (f * x_shards), x_shards)),
                ("frame", "y", "x"))


def masked_percentile_psum(x: Sequence[torch.Tensor],
                           mask: Sequence[torch.Tensor], q
                           ) -> List[torch.Tensor]:
    """Exact percentile ``q`` of the masked values of ALL the shards ``x``
    (each with its ``mask``), as a 0-d tensor on each shard's device.

    Float32 values map to an order-isomorphic int32 key; 32 bisection steps
    each count ``key <= mid`` on every shard and sum the counts. Both ranks
    of the interpolation are searched together; each step's decision is a
    ``torch.where`` on the first shard's device, with no host read."""
    home = x[0].device
    keys = []
    for xi, mi in zip(x, mask):
        bits = xi.to(torch.float32).reshape(-1).contiguous().view(torch.int32)
        key = torch.where(bits < 0, -1 - (bits & 0x7FFFFFFF), bits)
        keys.append(torch.where(mi.reshape(-1).to(torch.bool), key,
                                torch.full_like(key, _I32_MAX)))
    n = psum([m.reshape(-1).to(torch.bool).sum(dtype=torch.int32)
              for m in mask])[0]
    n1 = torch.clamp_min(n - 1, 0)
    pos = n1.to(torch.float32) * _q_frac(q)
    lo = torch.minimum(torch.clamp_min(torch.floor(pos).to(torch.int32), 0), n1)
    frac = pos - torch.floor(pos)
    ranks = torch.stack([lo, torch.minimum(lo + 1, n1)]).to(torch.int32)
    lo_k = torch.full((2,), _I32_MIN, dtype=torch.int32, device=home)
    hi_k = torch.full((2,), _I32_MAX, dtype=torch.int32, device=home)
    for _ in range(32):  # invariant: answer in (lo_k, hi_k]
        mid = (lo_k & hi_k) + ((lo_k ^ hi_k) >> 1)
        cnt = psum([(k[None, :] <= _move(mid, k.device)[:, None]).sum(
            dim=1, dtype=torch.int32) for k in keys])[0]
        take_lo = cnt >= ranks + 1
        lo_k, hi_k = (torch.where(take_lo, lo_k, mid),
                      torch.where(take_lo, mid, hi_k))
    b = torch.where(hi_k < 0, (-1 - hi_k) + _I32_MIN, hi_k)
    v = b.view(torch.float32)
    val = v[0] * (1.0 - frac) + v[1] * frac
    val = torch.where(n > 0, val, torch.zeros_like(val))
    return [_move(val, xi.device) for xi in x]


def clip_percentile_sharded(ref: np.ndarray, mask: np.ndarray, q
                            ) -> np.ndarray:
    """Percentile of a space-sharded (Z, Yl, Xl) volume (``ref`` and
    ``mask``: (ny, nx) grids of shards) equal to the UNSHARDED
    ``ops.percentile.masked_percentile`` at every size: above
    ``_EXACT_SORT_LIMIT`` global elements that takes a strided row
    subsample, so the same global rows (row = z * Y_global + y_global;
    whole rows when X_global >= 128, else single elements) are selected
    here before the exact distributed bisection. Returns the grid of
    per-shard values."""
    ny, nx = ref.shape
    Z, Yl, Xl = ref[0, 0].shape
    Xg = Xl * nx
    total = Z * Yl * ny * Xg
    masks = mask.copy()
    if total > _EXACT_SORT_LIMIT:
        stride = -(-total // _EXACT_SORT_LIMIT)
        for (iy, ix), r in np.ndenumerate(ref):
            ar = lambda k: torch.arange(k, device=r.device)  # noqa: E731
            grow = ar(Z)[:, None] * (Yl * ny) + iy * Yl + ar(Yl)[None, :]
            if Xg >= 128:   # whole-row subsample
                sel = ((grow % stride) == 0)[..., None]
            else:           # element-strided subsample
                gflat = grow[..., None] * Xg + ix * Xl + ar(Xl)
                sel = (gflat % stride) == 0
            masks[iy, ix] = mask[iy, ix] & sel
    vals = masked_percentile_psum(list(ref.flat), list(masks.flat), q)
    return _object_array(vals, ref.shape)


def _edge_rows(x: torch.Tensor, first: bool, halo: int) -> torch.Tensor:
    row = x[..., :1, :] if first else x[..., -1:, :]
    return row.expand(*x.shape[:-2], halo, x.shape[-1])


def _halo_exchange_rows(x: Sequence[torch.Tensor], halo: int
                        ) -> List[torch.Tensor]:
    """Extend the row axis (second to last) of the shards of one axis by
    ``halo`` on both sides with the neighbouring shards' rows; global edges
    replicate their edge row. One ppermute pair when the halo fits in a
    shard; else the whole axis is gathered and each shard's window
    sliced."""
    n = len(x)
    Yl = x[0].shape[-2]
    if n == 1:
        return [torch.cat([_edge_rows(x[0], True, halo), x[0],
                           _edge_rows(x[0], False, halo)], -2)]
    if halo <= Yl:
        top = ppermute([s[..., -halo:, :] for s in x],
                       [(i, (i + 1) % n) for i in range(n)])
        bot = ppermute([s[..., :halo, :] for s in x],
                       [(i, (i - 1) % n) for i in range(n)])
        top[0] = _edge_rows(x[0], True, halo)
        bot[-1] = _edge_rows(x[-1], False, halo)
        return [torch.cat([t, s, b], -2) for t, s, b in zip(top, x, bot)]
    full = all_gather(x, axis=-2)
    out = []
    for i, f in enumerate(full):
        padded = torch.cat([_edge_rows(f, True, halo), f,
                            _edge_rows(f, False, halo)], -2)
        out.append(padded[..., i * Yl:i * Yl + halo + Yl + halo, :])
    return out


def _halo_exchange_cols(x: Sequence[torch.Tensor], halo: int
                        ) -> List[torch.Tensor]:
    """Column twin of :func:`_halo_exchange_rows` (last axis)."""
    ext = _halo_exchange_rows([s.transpose(-1, -2) for s in x], halo)
    return [e.transpose(-1, -2) for e in ext]


def _halo_extend(grid: np.ndarray, halo: int) -> np.ndarray:
    """Extend a (ny, nx) grid of shards by ``halo`` rows over ``y`` and, when
    columns are sharded (nx > 1), columns over ``x``. Columns go first, on
    the unextended rows; the row exchange then carries the column-extended
    blocks, so the corners arrive through the neighbour's column halo."""
    out = grid.copy()
    if grid.shape[1] > 1:
        for iy in range(grid.shape[0]):
            out[iy, :] = _object_array(_halo_exchange_cols(list(out[iy, :]),
                                                           halo), -1)
    for ix in range(grid.shape[1]):
        out[:, ix] = _object_array(_halo_exchange_rows(list(out[:, ix]), halo),
                                   -1)
    return out


def _crop(grid: np.ndarray, ext: np.ndarray, halo: int) -> np.ndarray:
    """Each extended block of ``ext`` cut back to its shard of ``grid``."""
    out = ext.copy()
    for idx, e in np.ndenumerate(ext):
        Yl, Xl = grid[idx].shape[-2:]
        e = e[..., halo:halo + Yl, :]
        out[idx] = e[..., halo:halo + Xl] if grid.shape[1] > 1 else e
    return out


def _grid_map(mesh: Mesh, frame: int):
    """``map_(fn, *grids)``: ``fn`` on the shards of each position of the
    grids of frame row ``frame`` of ``mesh``, through
    :meth:`~.mesh.Mesh.run` (a stream a position on the card), as a grid."""
    def map_(fn, *grids) -> np.ndarray:
        shape = grids[0].shape
        positions = [(frame, *idx)[:mesh.devices.ndim]
                     for idx in np.ndindex(shape)]
        return _object_array(mesh.run(fn, *(list(g.flat) for g in grids),
                                      positions=positions), shape)
    return map_


def _blur_with_halo(grid: np.ndarray, sigmas, halo: int, map_) -> np.ndarray:
    """Blur each (Z, Yl, Xl) shard of ``grid`` with (z, y, x) ``sigmas``: a
    ``halo``-px halo of the CURRENT field in each sharded spatial axis
    (global edges replicate this field's edge pixels, the unsharded blur's
    'nearest' boundary), the extended block blurred (``map_``: see
    :func:`_grid_map`), then cropped."""
    ext = _halo_extend(grid, halo)
    return _crop(grid, map_(lambda e: gaussian_blur(e, sigmas), ext), halo)


def _project_block(img: np.ndarray, map_, reference_channel: int,
                   airyscan: bool, airyscan_offset: float, atoh_shift: int):
    """One frame's projection over a grid of (C, Z, Yl, Xl) space shards:
    ``time_point_surface_projection`` (method 'max_averages', precise
    blurs) stage for stage, each stencil exchanging its own halo and each
    per-shard step run by ``map_`` (:func:`_grid_map`). Returns the grids
    of (C, Yl, Xl) projections and (Yl, Xl) z-maps."""
    img = map_(lambda x: x.to(torch.float32), img)
    if airyscan:
        img = map_(lambda x: torch.clamp_min(x - airyscan_offset, 0.0), img)
    channels, z_size = img[0, 0].shape[:2]

    ref = map_(lambda x: x[reference_channel], img)
    p95 = clip_percentile_sharded(ref, map_(lambda r: r > 0, ref), 95.0)
    ref = map_(lambda r, p: torch.where((r > p) & (p > 0), p, r), ref, p95)
    # radius = int(4 * sigma + 0.5) (scipy), per stage
    ref = _blur_with_halo(ref, (0.5, 1.0, 1.0), 4, map_)
    score = _blur_with_halo(ref, (0.5, 30.0, 30.0), 120, map_)
    rel_z = map_(lambda s: torch.argmax(s, dim=0).to(torch.int32), score)

    def blur_onehot(rz):
        # the one-hot of the halo-extended height map is the halo extension
        # of the one-hot volume, so exchanging the small int map suffices
        ext = _halo_extend(map_(lambda r: r[None], rz), 8)
        zidx = torch.arange(z_size, dtype=torch.int32).reshape(z_size, 1, 1)
        m = map_(lambda e: gaussian_blur(
            (_move(zidx, e.device) == e).to(torch.float32), (1.0, 2.0, 2.0)),
            ext)
        return _crop(rz, m, 8)

    mask = blur_onehot(rel_z)
    mask_atoh = mask if atoh_shift == 0 else blur_onehot(map_(
        lambda r: torch.clamp(r + atoh_shift, 0, z_size - 1), rel_z))
    projection = map_(lambda x, m, ma: torch.stack([
        (x[c] * (m if c == reference_channel else ma)).amax(dim=0)
        for c in range(channels)]), img, mask, mask_atoh)
    return projection, rel_z


def _join(grid: np.ndarray, device: torch.device) -> torch.Tensor:
    """The whole frame of a (ny, nx) grid of shards, on ``device``."""
    return torch.cat([torch.cat([_move(s, device) for s in row], -1)
                      for row in grid], -2)


def sharded_projection(
    mesh: Mesh,
    reference_channel: int = 0,
    airyscan: bool = False,
    airyscan_offset: float = 10000.0,
    atoh_shift: int = 0,
):
    """Build ``fn(movie) -> (projections, zmaps)`` with frames sharded over
    ``frame``, rows over ``y`` and columns over ``x`` (a mesh without an
    ``x`` axis, or with one of size 1, leaves columns whole).

    ``movie``: (T, C, Z, Y, X), numpy or a tensor; T divisible by the frame
    axis, Y by the y axis, X by the x axis. Each shard is uploaded to its
    device; the (T, C, Y, X) projections and (T, Y, X) int32 z-maps are
    joined on the lead device. They equal ``time_point_surface_projection(
    ..., precise=True, airyscan=..., atoh_shift=...)``, edges included, and
    at sizes above ``_EXACT_SORT_LIMIT`` (the clip selects the unsharded
    subsample's rows)."""
    devs = mesh.devices if "x" in mesh.shape else mesh.devices[..., None]
    nf, ny, nx = devs.shape

    def fn(movie):
        T, _, _, Y, X = movie.shape
        if T % nf or Y % ny or X % nx:
            raise ValueError(f"movie {tuple(movie.shape)} does not divide over "
                             f"the mesh {dict(mesh.shape)}")
        Tl, Yl, Xl = T // nf, Y // ny, X // nx
        t = (movie if isinstance(movie, torch.Tensor)
             else torch.from_numpy(np.require(movie, requirements=["C", "W"])))
        projs, zmaps = [], []
        for f in range(nf):
            map_ = _grid_map(mesh, f)
            shard = map_(lambda dev, iy, ix: _move(
                t[f * Tl:(f + 1) * Tl, ..., iy * Yl:(iy + 1) * Yl,
                  ix * Xl:(ix + 1) * Xl], dev),
                devs[f], *np.indices((ny, nx)))
            for k in range(Tl):
                proj, zmap = _project_block(
                    map_(lambda s: s[k], shard), map_, reference_channel,
                    airyscan, airyscan_offset, atoh_shift)
                projs.append(_join(proj, mesh.lead))
                zmaps.append(_join(zmap, mesh.lead))
        return torch.stack(projs), torch.stack(zmaps)
    return fn
