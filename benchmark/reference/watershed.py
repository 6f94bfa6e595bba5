"""Watershed segmentation with watershed lines.

Frozen copy of the plain code of the port's ``ops/watershed.py``: the general flood
of the threshold + blur path, and the ``binary=True`` route for the {0, c}
boundary maps of the U-Net post-process (seeds are the components of the zero
set, found by the segmented-scan kernel with ``minima_scan=True``, and the
flood levels equal the image, so the Bellman-Ford phase drops away). The
algorithm is the JAX package's two-phase data-parallel flood:

1. seeds: regional minima plateaus, 4-connected, numbered 1..N in raster
   order (:func:`regional_minima_labels`, the kernel-branch formulation: one
   poisoned CC diffusion, exact integer ranks, a second CC diffusion);
2. flood levels lam by Bellman-Ford on the (min, max) semiring
   (:func:`~benchmark.reference.flood.bf_flood`);
3. the ascending Meyer settle with arrival stamps
   (:func:`~benchmark.reference.flood.settle`);
4. watershed lines by (lam, t, index) order (:func:`_apply_lines`).

Every step is exact, so labels equal the JAX package's bit for bit on the
same float input.
"""

from __future__ import annotations

import torch

from benchmark.reference.filters import gaussian_blur
from benchmark.reference.flood import (
    BIG_T, bf_flood, cc_diffusion, settle)
from benchmark.reference.local_threshold import (
    threshold_local_max)
from benchmark.reference.morphology import shift2d

__all__ = ["minima_candidates", "regional_minima_labels", "stack_frames",
           "watershed_batch", "watershed_segmentation_batch"]

_NBRS4 = [(1, 0), (-1, 0), (0, 1), (0, -1)]
_INF = float("inf")
# +inf rows between row-stacked frames: >= 1 isolates the 4-neighbour flood
# and the 8-neighbour minima test across frames
_STACK_SEP = 16
# stacked heights are padded to a multiple of this many rows (the TPU
# kernels' row block; kept so both ports flood the same stacked shape)
_STACK_ROWS = 64


def _nbr_val(img: torch.Tensor, dy: int, dx: int, cval) -> torch.Tensor:
    """Value of the neighbour at offset (dy, dx): out[p] = img[p + (dy, dx)]."""
    return shift2d(img, -dy, -dx, cval)


def minima_candidates(image: torch.Tensor):
    """(candidate, init) of the first minima diffusion: ``candidate`` marks
    pixels with no lower 8-neighbour (finite only); ``init`` is the flat index,
    poisoned to ``index - H*W`` on candidates 8-adjacent to an equal-valued
    escaping pixel, so a component touching one comes out negative (its min)
    while clean components keep their root index."""
    img = image.to(torch.float32)
    rm = torch.minimum(torch.minimum(_nbr_val(img, 0, -1, _INF), img),
                       _nbr_val(img, 0, 1, _INF))
    min8 = torch.minimum(
        torch.minimum(_nbr_val(rm, -1, 0, _INF), _nbr_val(rm, 1, 0, _INF)),
        torch.minimum(_nbr_val(img, 0, -1, _INF), _nbr_val(img, 0, 1, _INF)))
    candidate = (img <= min8) & (img < _INF)
    # escaping test as a separable 9-point min (see the JAX version's notes)
    h = torch.where(min8 < img, img, torch.full_like(img, _INF))
    rm_h = torch.minimum(torch.minimum(_nbr_val(h, 0, -1, _INF), h),
                         _nbr_val(h, 0, 1, _INF))
    min9_h = torch.minimum(torch.minimum(_nbr_val(rm_h, -1, 0, _INF), rm_h),
                           _nbr_val(rm_h, 1, 0, _INF))
    bad = min9_h == img
    H, W = img.shape
    idx2 = torch.arange(H * W, dtype=torch.int32, device=img.device).reshape(H, W)
    return candidate, torch.where(bad & candidate, idx2 - H * W, idx2)


def _binary_candidates(img: torch.Tensor) -> torch.Tensor:
    """Minima candidates of a {0, c} boundary map: the zero set, plus the
    whole finite region of any frame that holds no zero at all (an all-c
    frame is one regional minimum). Frames are the row segments between
    all-inf rows (the separator bands of a stacked batch); inside one
    rectangle a c-component beside zeros always touches a zero and escapes,
    so a zero-free segment is the only such case."""
    candidate = img == 0
    finite = img < _INF
    finite_row = finite.any(dim=1)
    zero_row = candidate.any(dim=1)
    seg_id = torch.cumsum((~finite_row).to(torch.int64), 0)
    seg_any = torch.zeros(img.shape[0] + 1, dtype=torch.int32,
                          device=img.device)
    seg_any.scatter_reduce_(0, seg_id, zero_row.to(torch.int32), "amax")
    return candidate | (finite & (seg_any[seg_id] == 0)[:, None])


def regional_minima_labels(image: torch.Tensor, scan: bool = False,
                           binary: bool = False) -> torch.Tensor:
    """Label regional minima plateaus 1..N in raster order (0 elsewhere).

    A plateau is a regional minimum when it has no lower 8-neighbour and no
    equal-valued 8-neighbour outside it; non-finite pixels never are.

    ``scan`` sends the two component diffusions through the segmented-scan
    kernel: the route for image-scale plateaus (binary boundary maps), where
    the sweeps need one pass per pixel of diameter. ``binary`` promises a
    {0, c} boundary map (+inf bands allowed): every zero plateau is then a
    minimum and none escapes, so the candidates are the zero set itself
    (:func:`_binary_candidates`) and nothing is poisoned."""
    H, W = image.shape
    n = H * W
    idx2 = torch.arange(n, dtype=torch.int32, device=image.device).reshape(H, W)
    if binary:
        candidate, init = _binary_candidates(image.to(torch.float32)), idx2
    else:
        candidate, init = minima_candidates(image)
    comp = cc_diffusion(candidate, init=init, scan=scan)
    ok = comp >= 0
    is_root = ok & (comp == idx2)
    # dense raster-order rank of each root (exact integer prefix count),
    # propagated over its component by a second diffusion
    rank = torch.cumsum(is_root.reshape(-1).to(torch.int32), 0,
                        dtype=torch.int32).reshape(H, W)
    init2 = torch.where(is_root, rank, n)
    seeds = cc_diffusion(ok, init=init2, scan=scan)
    return torch.where(seeds > 0, seeds, 0).to(torch.int32)


def _watershed_core(image: torch.Tensor, markers: torch.Tensor | None,
                    watershed_line: bool, minima_scan: bool = False,
                    binary: bool = False) -> torch.Tensor:
    img = image.to(torch.float32)
    if markers is None:
        seeds = regional_minima_labels(img, scan=minima_scan, binary=binary)
    else:
        seeds = markers.to(torch.int32)
    # On a {0, c} map flooded from its own minima lam == img exactly: a zero
    # pixel reaches its seed at level 0 and every path from a positive pixel
    # peaks at c. User markers need the real flood levels even then.
    lam = img if binary and markers is None else bf_flood(img, seeds)
    q_lam = [_nbr_val(lam, dy, dx, _INF) for dy, dx in _NBRS4]
    lbl_raw, t = settle(lam, seeds)
    lbl = torch.clamp(lbl_raw, min=0)
    return _apply_lines(lbl, t, lam, q_lam, watershed_line)


def _apply_lines(lbl, t, lam, q_lam, watershed_line):
    H, W = lbl.shape
    if not watershed_line:
        # fill line/void pixels from their earliest labelled neighbour
        while True:
            best = torch.zeros_like(lbl)
            bv = torch.full_like(lam, _INF)
            for (dy, dx), qv in zip(_NBRS4, q_lam):
                ql = _nbr_val(lbl, dy, dx, 0)
                take = (ql > 0) & (qv < bv)
                best = torch.where(take, ql, best)
                bv = torch.where(take, qv, bv)
            new = torch.where((lbl == 0) & (best > 0), best, lbl)
            if torch.equal(new, lbl):
                return lbl
            lbl = new
    # simultaneous equal-(lam, t) meetings leave both sides labelled — flag
    # the later one in (lam, t, index) order as line, like skimage
    n = H * W
    idx2d = torch.arange(n, dtype=torch.int32, device=lbl.device).reshape(H, W)
    line = torch.zeros_like(lbl, dtype=torch.bool)
    for (dy, dx), qv in zip(_NBRS4, q_lam):
        ql = _nbr_val(lbl, dy, dx, 0)
        qt = _nbr_val(t, dy, dx, BIG_T)
        qi = _nbr_val(idx2d, dy, dx, n)
        earlier = ((qv < lam) | ((qv == lam) & (qt < t))
                   | ((qv == lam) & (qt == t) & (qi < idx2d)))
        line = line | ((ql != lbl) & (ql > 0) & (lbl > 0) & earlier)
    return torch.where(line, 0, lbl)


def stack_frames(images: torch.Tensor) -> torch.Tensor:
    """Row-stack (B, H, W) frames into one image: ``_STACK_SEP`` +inf rows
    after each frame, +inf rows padding the height to a multiple of 64."""
    B, H, W = images.shape
    slot = H + _STACK_SEP
    tail = (-(B * slot)) % _STACK_ROWS
    stacked = torch.full((B * slot + tail, W), _INF, dtype=torch.float32,
                         device=images.device)
    stacked[:B * slot].view(B, slot, W)[:, :H] = images.to(torch.float32)
    return stacked


def watershed_batch(images: torch.Tensor, watershed_line: bool = True,
                    binary: bool = False,
                    minima_scan: bool = False) -> torch.Tensor:
    """Flood B frames as ONE row-stacked image (:func:`stack_frames`), however
    large the batch (the JAX package splits a stack that outgrows the TPU's
    VMEM; the labels do not depend on the split).

    +inf bands produce no seeds and never donate to or block a finite
    pixel, so each frame's labels equal its own flood; seeds are numbered in
    raster order, hence contiguously per frame, and subtracting each frame's
    offset restores 1..N_k. The sweep count of the flood is the max over
    frames instead of the sum."""
    B, H, W = images.shape
    slot = H + _STACK_SEP
    stacked = stack_frames(images)
    out = _watershed_core(stacked, None, watershed_line, minima_scan, binary)
    labs = out[:B * slot].reshape(B, slot, W)[:, :H]
    big = torch.iinfo(torch.int32).max
    mins = torch.where(labs > 0, labs, big).reshape(B, -1).amin(dim=1)
    off = torch.where(mins == big, 0, mins - 1)
    return torch.where(labs > 0, labs - off[:, None, None], 0).contiguous()


def _preprocess(images: torch.Tensor, imgthresh: float, std: float,
                block_size: int) -> torch.Tensor:
    """Local-max threshold (dim pixels -> 0) then the Gaussian pre-blur, for
    a (B, H, W) stack: one blur launch for the whole batch."""
    img = images.to(torch.float32)
    thr = imgthresh * threshold_local_max(img, block_size)
    seg = torch.where(img < thr, 0.0, img)
    return gaussian_blur(seg, (0.0, float(std), float(std)))


def watershed_segmentation_batch(images: torch.Tensor, imgthresh: float,
                                 std: float, block_size: int) -> torch.Tensor:
    """The reference's ``watershed_segmentation`` on a (B, H, W) batch:
    local-max threshold, dim pixels to 0, Gaussian blur, then ONE stacked
    watershed flood with lines for the whole batch."""
    return watershed_batch(_preprocess(images, imgthresh, std, block_size))
