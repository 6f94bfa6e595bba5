"""Cellpose's masks from its network's flows, on the device.

The steps of Cellpose v2's ``dynamics.py:compute_masks`` (its GPU path),
except flow following, which takes the pixel-coordinate form of its CPU
path (``steps2D_interp`` with ``map_coordinates``; the GPU path's
``grid_sample`` renormalises the coordinates):

1. :func:`follow` — every pixel with ``|d_y| > 1e-3``, where ``d = dP *
   (cellprob > threshold) / 5``, takes ``niter`` Euler steps along the
   bilinearly interpolated field in float32 (``csrc/follow_flows.cu`` on
   the card, :func:`follow_plain` elsewhere; bit for bit the same);
2. :func:`get_masks` — a histogram of where the pixels end, seeds at its
   5 x 5 maxima above 10, five rounds of 3 x 3 growth through bins above 2,
   masks over 40% of the frame dropped, labels renumbered 1..N by first
   appearance;
3. :func:`remove_bad_flow_masks` — each mask's flow rebuilt by heat
   diffusion from its centre in float64 (``masks_to_flows_gpu``), masks
   whose mean squared flow error exceeds the threshold dropped; the
   diffusion (:func:`diffusion`) runs every mask inside its own box in
   shared memory for all its iterations on the card
   (``csrc/flow_diffuse.cu``, one launch a size class of boxes), the
   whole-frame loop :func:`diffuse_plain` elsewhere; bit for bit the same;
4. :func:`fill_holes_and_remove_small_masks` — in label order, masks under
   ``min_size`` pixels dropped, the others' holes filled and relabelled
   1..K.

:func:`follow` takes a group of frames in one launch, :func:`frame_masks`
one frame through steps 2-4. No step loops over masks on the host. The host reads, each once a frame:
the number of followed pixels (:func:`follow`, one vector a batch of
frames), the number of masks found, the diffusion's iteration count (a
maximum; on the card one vector with the mask pixels and the masks per
size class of the diffusion), the masks per size class of the hole
filling, and one change flag with the masks kept (again once a round where
masks enclose masks).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Tuple

import torch
import torch.nn.functional as F

from tissue_image_processing_tpu_torch._device import count
from tissue_image_processing_tpu_torch.ops.components import _component_roots

__all__ = ["follow", "follow_plain", "get_masks", "diffuse_plain",
           "diffusion", "masks_to_flows", "flow_error", "remove_bad_flow_masks",
           "fill_holes_and_remove_small_masks", "frame_masks"]

RPAD = 20
# v2's neighbour order of masks_to_flows_gpu: the pixel, then up, down,
# left, right, then the diagonals
NEIGHBOURS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
              (-1, -1), (-1, 1), (1, -1), (1, 1))


def follow_plain(d: torch.Tensor, niter: int) -> torch.Tensor:
    """Plain version of ``csrc/follow_flows.cu``: (B, 2, Y, X) float32
    flows -> (B, 2, Y, X) float32 final positions, the followed pixels
    stepped together as separate PyTorch operations in the kernel's
    order."""
    B, _, Y, X = d.shape
    dev = d.device
    yy = torch.arange(Y, device=dev, dtype=torch.float32)[:, None].expand(Y, X)
    xx = torch.arange(X, device=dev, dtype=torch.float32)[None, :].expand(Y, X)
    p = torch.stack([yy, xx])[None].repeat(B, 1, 1, 1)
    b, iy, ix = torch.nonzero(d[:, 0].abs() > 1e-3, as_tuple=True)
    y, x = iy.to(torch.float32), ix.to(torch.float32)
    flat = d.reshape(-1)
    plane = Y * X
    base = b * (2 * plane)
    for _ in range(int(niter)):
        yc, xc = y.to(torch.int32), x.to(torch.int32)
        fy, fx = y - yc.to(torch.float32), x - xc.to(torch.float32)
        yf, xf = yc.clamp(0, Y - 1), xc.clamp(0, X - 1)
        yf1, xf1 = (yf + 1).clamp(max=Y - 1), (xf + 1).clamp(max=X - 1)
        gy, gx = 1 - fy, 1 - fx
        i00 = base + yf * X + xf
        i01 = base + yf * X + xf1
        i10 = base + yf1 * X + xf
        i11 = base + yf1 * X + xf1
        v = []
        for c in (0, plane):
            v.append(flat[i00 + c] * gy * gx + flat[i01 + c] * gy * fx
                     + flat[i10 + c] * fy * gx + flat[i11 + c] * fy * fx)
        y = torch.clamp(y + v[0], 0, Y - 1)
        x = torch.clamp(x + v[1], 0, X - 1)
    p[b, 0, iy, ix] = y
    p[b, 1, iy, ix] = x
    return p


def follow(dP: torch.Tensor, cellprob: torch.Tensor, niter: int = 200,
           cellprob_threshold: float = 0.0
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, 2, Y, X) flows and (B, Y, X) cell probabilities -> (final
    positions (B, 2, Y, X) float32, the cell mask (B, Y, X) bool, the
    number of followed pixels a frame (B,) on the host). Adds the followed
    pixels to ``COUNTS["follow_px"]``."""
    m = cellprob > cellprob_threshold
    d = (dP * m[:, None]) / 5.0
    if d.device.type == "cuda":
        from tissue_image_processing_tpu_torch.ops.flows_cuda import (
            follow_cuda)
        p = follow_cuda(d.contiguous(), niter)
    else:
        p = follow_plain(d, niter)
    followed = (d[:, 0].abs() > 1e-3).sum((1, 2)).cpu()
    count("follow_px", int(followed.sum()))
    return p, m, followed


def get_masks(p: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(2, Y, X) final positions and the (Y, X) cell mask -> (int32 (Y, X)
    labels 1..N, N), N read once on the host and added to
    ``COUNTS["cp_masks_found"]``. Pixels off the mask end
    at their own coordinates. Growing seed k's bins for five rounds and
    writing them in seed order, later seeds over earlier ones, gives each
    bin the largest seed number within five steps through bins above 2:
    five rounds of a masked 3 x 3 maximum of the seed numbers."""
    Y, X = m.shape
    dev = p.device
    HY, HX = Y + 2 * RPAD, X + 2 * RPAD
    yy = torch.arange(Y, device=dev, dtype=torch.float32)[:, None].expand(Y, X)
    xx = torch.arange(X, device=dev, dtype=torch.float32)[None, :].expand(Y, X)
    py = torch.where(m, p[0], yy).to(torch.int32) + RPAD
    px = torch.where(m, p[1], xx).to(torch.int32) + RPAD
    bins = (py * HX + px).reshape(-1).to(torch.int64)
    h = torch.zeros(HY * HX, dtype=torch.float32, device=dev)
    h.index_add_(0, bins, torch.ones_like(bins, dtype=torch.float32))
    h = h.reshape(1, 1, HY, HX)
    hmax = F.max_pool2d(h, 5, stride=1, padding=2)
    seeds = ((h - hmax) > -1e-6) & (h > 10)
    lab = torch.cumsum(seeds.reshape(-1), 0).reshape(h.shape)
    lab = torch.where(seeds, lab, 0).to(torch.float32)
    grow = h > 2
    for _ in range(5):
        lab = torch.where(grow, F.max_pool2d(lab, 3, stride=1, padding=1), 0.0)
    labels = lab.reshape(-1)[bins].to(torch.int64)
    n = labels.numel()
    sizes = torch.zeros(HY * HX + 1, dtype=torch.int64, device=dev)
    sizes.index_add_(0, labels, torch.ones_like(labels))
    big = sizes.to(torch.float64) > float(Y * X) * 0.4
    labels = torch.where(big[labels], 0, labels)
    idx = torch.arange(n, device=dev)
    first = torch.full((HY * HX + 1,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, labels, idx, "amin")
    is_first = (first[labels] == idx) & (labels > 0)
    rank = torch.cumsum(is_first, 0)
    out = torch.where(labels > 0, rank[first[labels].clamp(max=n - 1)], 0)
    found = int(is_first.sum())
    count("cp_masks_found", found)
    return out.reshape(Y, X).to(torch.int32), found


def _label_boxes(labels: torch.Tensor, N: int):
    """(count, y0, y1, x0, x1) of labels 0..N of a (Y, X) label map, each an
    (N + 1,) int64 tensor; absent labels have count 0 and an empty box."""
    Y, X = labels.shape
    dev = labels.device
    flat = labels.reshape(-1).to(torch.int64)
    idx = torch.arange(flat.numel(), device=dev)
    ys, xs = idx // X, idx % X
    cnt = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    cnt.index_add_(0, flat, torch.ones_like(flat))
    big = Y * X

    def red(v, how, init):
        out = torch.full((N + 1,), init, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, flat, v, how)
    return (cnt, red(ys, "amin", big), red(ys, "amax", -1),
            red(xs, "amin", big), red(xs, "amax", -1))


def _geometry(masks: torch.Tensor, N: int):
    """((count, y0, y1, x0, x1), centre) of (Y, X) labels 0..N: the counts
    and boxes of :func:`_label_boxes` (label 0's count 0 here) and the (N,)
    frame index of each mask's centre, its pixel nearest the (median y,
    median x) of its pixels (numpy's median: the mean of the two middle
    values for an even count), the first in row-major order on a tie (Y *
    X for an absent label). The boxes' ends and the medians come from the
    same two sorts of the mask pixels by (label, y) and (label, x): no
    reduction over the background, whose ~15% of the frame would all land
    on label 0."""
    Y, X = masks.shape
    dev = masks.device
    lab = masks.reshape(-1).to(torch.int64)
    on = lab > 0
    idx = torch.arange(lab.numel(), device=dev)[on]
    fl = lab[on]
    ys, xs = idx // X, idx % X
    cnt = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    cnt.index_add_(0, fl, torch.ones_like(fl))
    present = cnt > 0
    start = torch.cumsum(cnt, 0) - cnt
    end = max(fl.numel() - 1, 0)
    at = [(start + k).clamp(min=0, max=end) for k in
          ((cnt - 1) // 2, cnt // 2, torch.zeros_like(cnt), cnt - 1)]
    ends, med = [], []
    for coord, size in ((ys, Y), (xs, X)):
        key = torch.sort(fl * size + coord).values
        vals = key - (key // size) * size
        lo, hi, first, last = (vals[i] for i in at)
        med.append((lo.to(torch.float64) + hi.to(torch.float64)) / 2)
        ends += [torch.where(present, first, Y * X),
                 torch.where(present, last, -1)]
    dist = ((xs.to(torch.float64) - med[1][fl]) ** 2
            + (ys.to(torch.float64) - med[0][fl]) ** 2)
    near = torch.full((N + 1,), float("inf"), dtype=torch.float64, device=dev)
    near.scatter_reduce_(0, fl, dist, "amin")
    pick = torch.where(dist == near[fl], idx, Y * X)
    centre = torch.full((N + 1,), Y * X, dtype=torch.int64, device=dev)
    centre.scatter_reduce_(0, fl, pick, "amin")
    return (cnt, *ends), centre[1:]


def diffuse_plain(masks: torch.Tensor, centre: torch.Tensor,
                  n_iter: int) -> torch.Tensor:
    """Plain version of ``csrc/flow_diffuse.cu``: the (Y + 2, X + 2)
    float64 T after ``n_iter`` iterations over the whole padded frame, each
    adding 1 at every centre (``centre``: (N,) frame indices), then setting
    every pixel to the sum, in v2's neighbour order, of its 3 x 3
    neighbours in the same mask, over 9. Eleven launches an iteration on
    the card, whose division by 9 multiplies by the reciprocal; on the CPU
    it divides, as the kernel does."""
    Y, X = masks.shape
    dev = masks.device
    cflat = (centre // X + 1) * (X + 2) + centre % X + 1
    padded = F.pad(masks.to(torch.int64), (1, 1, 1, 1))
    inner = padded[1:-1, 1:-1]
    # a neighbour counts where it lies in the pixel's own mask; the bool
    # weights are read as 0.0 / 1.0, so each product is exact
    weights = torch.stack([
        (padded[1 + dy:Y + 1 + dy, 1 + dx:X + 1 + dx] == inner) & (inner > 0)
        for dy, dx in NEIGHBOURS[1:]])
    T = torch.zeros((Y + 2, X + 2), dtype=torch.float64, device=dev)
    nxt = torch.zeros_like(T)
    ones = torch.ones(cflat.numel(), dtype=torch.float64, device=dev)
    for _ in range(n_iter):
        T.view(-1).index_add_(0, cflat, ones)      # the centres are distinct
        acc = nxt[1:-1, 1:-1]
        acc.copy_(T[1:-1, 1:-1])
        for k, (dy, dx) in enumerate(NEIGHBOURS[1:]):
            acc.addcmul_(T[1 + dy:Y + 1 + dy, 1 + dx:X + 1 + dx], weights[k])
        acc.div_(9.0)
        T, nxt = nxt, T
    return T


def diffusion(masks: torch.Tensor, N: int) -> Tuple[torch.Tensor, int]:
    """Cellpose v2's ``masks_to_flows_gpu`` heat diffusion on (Y, X) labels
    1..N (all present): ((Y + 2, X + 2) float64 T, n_iter). Each mask's
    centre and box come from :func:`_geometry`; n_iter = 2 x the largest
    (ly + lx) with ly, lx the bounding-box sides + 1. On the card
    ``csrc/flow_diffuse.cu`` (one host read: n_iter with the masks per size
    class), elsewhere :func:`diffuse_plain` (the one host read: n_iter);
    the same T bit for bit. Adds n_iter to ``COUNTS["qc_iters"]`` and the
    mask pixels x n_iter to ``COUNTS["qc_px_iters"]``."""
    boxes, centre = _geometry(masks, N)
    cnt, y0, y1, x0, x1 = boxes
    if masks.device.type == "cuda":
        from tissue_image_processing_tpu_torch.ops import flow_diffuse_cuda
        p = flow_diffuse_cuda.plan(masks.to(torch.int32).contiguous(), boxes,
                                   centre)
        T, n_iter, pixels = flow_diffuse_cuda.run(p), p.n_iter, p.pixels
    else:
        ext = (y1 - y0 + 2) + (x1 - x0 + 2)
        n_iter = 2 * int(ext[1:].max())
        pixels = int(cnt[1:].sum())
        T = diffuse_plain(masks, centre, n_iter)
    count("qc_iters", n_iter)
    count("qc_px_iters", pixels * n_iter)
    return T, n_iter


def masks_to_flows(masks: torch.Tensor, N: int) -> Tuple[torch.Tensor, int]:
    """Cellpose v2's ``masks_to_flows_gpu`` on (Y, X) labels 1..N (all
    present): (2, Y, X) float64 unit flows (zero off the masks) and the
    iteration count. T from :func:`diffusion`, then log(1 + T), central
    differences and division by 1e-20 + the norm."""
    T, n_iter = diffusion(masks, N)
    T = torch.log(1.0 + T)
    dy = T[2:, 1:-1] - T[:-2, 1:-1]
    dx = T[1:-1, 2:] - T[1:-1, :-2]
    norm = torch.sqrt(dy * dy + dx * dx)
    inside = masks > 0
    mu = torch.stack([torch.where(inside, dy / (1e-20 + norm), 0.0),
                      torch.where(inside, dx / (1e-20 + norm), 0.0)])
    return mu, n_iter


def flow_error(masks: torch.Tensor, dP: torch.Tensor, N: int) -> torch.Tensor:
    """(N + 1,) float64 flow errors of labels 0..N (entry 0 unused, 0): the
    sum over the two channels of each mask's mean of (mu - dP / 5)^2, mu
    from :func:`masks_to_flows`. The per-mask sums are scatter-adds, whose
    order is free on the card: an error within ~1e-13 of the threshold may
    round either way. The background's pixels are spread over 1024 spare
    slots, so that ~15% of the frame's adds do not all wait on one
    address."""
    mu, _ = masks_to_flows(masks, N)
    lab = masks.reshape(-1).to(torch.int64)
    spare = torch.arange(lab.numel(), device=masks.device) % 1024 + N + 1
    at = torch.where(lab > 0, lab, spare)
    cnt = torch.zeros(N + 1025, dtype=torch.float64, device=masks.device)
    cnt.index_add_(0, at, torch.ones_like(at, dtype=torch.float64))
    cnt = cnt[:N + 1].clamp(min=1)
    err = torch.zeros(N + 1, dtype=torch.float64, device=masks.device)
    for c in range(2):
        sq = (mu[c] - (dP[c] / 5.0).to(torch.float64)) ** 2
        s = torch.zeros(N + 1025, dtype=torch.float64, device=masks.device)
        s.index_add_(0, at, sq.reshape(-1))
        err = err + s[:N + 1] / cnt
    return err


def remove_bad_flow_masks(masks: torch.Tensor, dP: torch.Tensor, N: int,
                          threshold: float = 0.4) -> torch.Tensor:
    """Labels of ``masks`` (1..N, all present) whose flow error exceeds
    ``threshold`` set to 0; the others keep their numbers."""
    bad = flow_error(masks, dP, N) > threshold
    bad[0] = False
    return torch.where(bad[masks.to(torch.int64)], 0, masks)


def _bucket_canvas(ks, y0, x0, h, w, s: int, Y: int, X: int):
    """The canvas of one size class: the bounding boxes of masks ``ks``
    (each at most s x s) stacked as (s + 1)-row strips of width s, the last
    row of each a separator. Returns the frame index of every canvas pixel
    (clamped), whether it lies in its mask's box, whether on the box's
    border, the mask number of its strip, all flat."""
    dev = ks.device
    ly = torch.arange(s + 1, device=dev)[None, :, None]
    lx = torch.arange(s, device=dev)[None, None, :]
    hk, wk = h[ks][:, None, None], w[ks][:, None, None]
    inbox = (ly < hk) & (lx < wk)
    border = inbox & ((ly == 0) | (ly == hk - 1) | (lx == 0) | (lx == wk - 1))
    fy = (y0[ks][:, None, None] + ly).clamp(max=Y - 1)
    fx = (x0[ks][:, None, None] + lx).clamp(max=X - 1)
    fidx = (fy * X + fx).expand(inbox.shape)
    owner = ks[:, None, None].expand(inbox.shape)
    return (fidx.reshape(-1), inbox.reshape(-1), border.reshape(-1),
            owner.reshape(-1))


def fill_holes_and_remove_small_masks(masks: torch.Tensor, N: int,
                                      min_size: int = 15
                                      ) -> Tuple[torch.Tensor, int]:
    """Cellpose v2's ``fill_holes_and_remove_small_masks`` on (Y, X) labels
    in 0..N: visiting masks in label order, a mask of fewer than
    ``min_size`` pixels (as it stands at its turn) is dropped; any other
    takes the next number 1, 2, ... and fills its holes (4-connected
    pixels of other values inside its bounding box that do not reach the
    box's border), over whatever they held. Returns (int32 labels, masks
    kept).

    All masks at once: each mask's box is cut out into a canvas of its size
    class (a power of two), and the components of "not this mask" in every
    box come from one connected-components call a class; a component that
    does not touch its box's border is a hole. A mask's pixels at its turn
    are its own less those filled by an earlier kept mask, so the pass is
    repeated on those pixels until no mask loses a pixel (once where no
    mask's holes hold another mask); the rounds are exact because a mask
    depends only on masks before it. A pixel ends with the new number of
    the last kept mask that filled it."""
    Y, X = masks.shape
    dev = masks.device
    orig = masks.reshape(-1).to(torch.int64)
    cnt, y0, y1, x0, x1 = _label_boxes(masks, N)
    present = cnt > 0
    present[0] = False
    h = torch.where(present, y1 - y0 + 1, 0)
    w = torch.where(present, x1 - x0 + 1, 0)
    side = torch.maximum(h, w)
    top = (max(Y, X) - 1).bit_length()
    # the size class: the least c with 2^c >= the box's longer side
    cls = sum((side > (1 << j)).to(torch.int64) for j in range(top + 1))
    cls = torch.where(present, cls, top + 1)
    per_class = torch.zeros(top + 2, dtype=torch.int64, device=dev)
    per_class = per_class.index_add_(0, cls, torch.ones_like(cls))
    per_class = per_class[:top + 1].tolist()
    canvases = []
    for c, n in enumerate(per_class):
        if n:
            ks = torch.nonzero(cls == c).reshape(-1)
            canvases.append((1 << c, ks, _bucket_canvas(ks, y0, x0, h, w,
                                                         1 << c, Y, X)))
    cur = orig
    big = N + 1
    while True:
        size = torch.zeros(N + 1, dtype=torch.int64, device=dev)
        size.index_add_(0, cur.clamp(min=0), torch.ones_like(cur))
        kept = present & (size >= min_size)
        lo = torch.full((Y * X,), big, dtype=torch.int64, device=dev)
        hi = torch.zeros(Y * X, dtype=torch.int64, device=dev)
        for s, ks, (fidx, inbox, border, owner) in canvases:
            val = cur[fidx]
            own = inbox & (val == owner)
            other = inbox & ~own
            roots = _component_roots(other.reshape(-1, s), 1).reshape(-1)
            safe = roots.clamp(min=0)
            touch = torch.zeros(other.numel(), dtype=torch.bool, device=dev)
            touch[safe[other & border]] = True
            fill = (own | (other & ~touch[safe])) & kept[owner]
            lo.scatter_reduce_(0, fidx[fill], owner[fill], "amin")
            hi.scatter_reduce_(0, fidx[fill], owner[fill], "amax")
        nxt = torch.where((orig > 0) & (lo < orig), -1, orig)
        changed, n_kept = torch.stack([(nxt != cur).any().to(torch.int64),
                                       kept.sum()]).tolist()
        if not changed:
            break
        cur = nxt
    rank = torch.cumsum(kept, 0)
    out = torch.where(hi > 0, rank[hi], 0)
    count("cp_masks_kept", n_kept)
    return out.reshape(Y, X).to(torch.int32), n_kept


def frame_masks(p: torch.Tensor, m: torch.Tensor, dP: torch.Tensor,
                followed: int, flow_threshold: float = 0.4,
                min_size: int = 15, span=None) -> torch.Tensor:
    """One frame's final positions (2, Y, X) and cell mask (Y, X) from
    :func:`follow`, its flows dP (2, Y, X) and its count of followed
    pixels -> (Y, X) int32 labels by steps 2-4 of the module docstring;
    fewer than 5 followed pixels give no mask, as in Cellpose.
    ``span(name)``, when given, is a context manager around each step:
    ``masks`` around ``get_masks`` and the hole filling, ``flow_qc``
    around the flow check."""
    span = span or (lambda name: nullcontext())
    if followed < 5:
        return torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    with span("masks"):
        labels, n = get_masks(p, m)
    if n and flow_threshold > 0:
        with span("flow_qc"):
            labels = remove_bad_flow_masks(labels, dP, n, flow_threshold)
    with span("masks"):
        return fill_holes_and_remove_small_masks(labels, n, min_size)[0]
