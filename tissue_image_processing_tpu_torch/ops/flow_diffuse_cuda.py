"""The Cellpose flow check's diffusion on the card: the wrapper of
``csrc/flow_diffuse.cu``. The plain version is
:func:`tissue_image_processing_tpu_torch.ops.flows.diffuse_plain`; the
kernel equals it, run on the CPU, bit for bit. The library is built at its
first call, so a pipeline that never checks flows never builds it.

The box preparation (:func:`box_plan`, :func:`neighbour_bits`) is plain
PyTorch on any device: masks are grouped into size classes by the longer
side of their bounding box rounded up to a power of two, one launch of the
shared form a class; a mask whose padded box needs more than the card's
shared memory takes the global form (one launch an iteration)."""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from tissue_image_processing_tpu_torch import _device

__all__ = ["Plan", "shared_px", "box_plan", "neighbour_bits", "plan", "run"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flow_diffuse_shared_limit": (),
    "flow_diffuse_boxes": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "flow_diffuse_global": (_P, _P, _P, _P, _P, _P, _I, _I, _I),
}
_MAX_THREADS = 512          # csrc/flow_diffuse.cu MAX_THREADS
_limits: Dict[torch.device, int] = {}


def _lib():
    return _device.load_library("flow_diffuse", _SIGNATURES)


def _threads(px: int) -> int:
    """A shared-form block's threads for boxes of up to ``px`` padded
    pixels: about 8 pixels a thread, a power of two in 32..512."""
    n = 32
    while n < _MAX_THREADS and n * 8 < px:
        n *= 2
    return n


def _smem_bytes(px: int) -> int:
    """Dynamic shared memory of a shared-form block for padded boxes of up
    to ``px`` pixels (``csrc/flow_diffuse.cu:flow_diffuse_kernel``): two
    float64 copies, a byte a pixel padded to 4, the strip count, and at
    most max(threads, box width) strips of 4 bytes; a padded box is at
    least 3 pixels high, so its width is under px / 3."""
    return 16 * px + (px + 3) // 4 * 4 + 4 + 4 * max(_threads(px), px // 3)


def shared_px(limit: int) -> int:
    """The largest padded box, in pixels, whose block fits ``limit`` bytes
    of shared memory."""
    lo, hi = 0, limit
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if _smem_bytes(mid) <= limit else (lo, mid - 1)
    return lo


def _shared_px(lib, dev: torch.device) -> int:
    """:func:`shared_px` of ``dev``'s shared memory a block."""
    if dev not in _limits:
        with torch.cuda.device(dev):
            _limits[dev] = shared_px(lib.flow_diffuse_shared_limit())
    return _limits[dev]


def neighbour_bits(masks: torch.Tensor) -> torch.Tensor:
    """(Y, X) uint8 of a (Y, X) label map: bit k set where neighbour k of
    ``ops/flows.py:NEIGHBOURS[1:]`` lies in the pixel's own mask (0 off
    the masks); the kernel's shared form makes the same bits in each block,
    the global form reads these."""
    from tissue_image_processing_tpu_torch.ops.flows import NEIGHBOURS

    Y, X = masks.shape
    padded = F.pad(masks, (1, 1, 1, 1))
    bits = torch.zeros((Y, X), dtype=torch.uint8, device=masks.device)
    for k, (dy, dx) in enumerate(NEIGHBOURS[1:]):
        same = padded[1 + dy:Y + 1 + dy, 1 + dx:X + 1 + dx] == masks
        bits |= same.to(torch.uint8) << k
    return bits * (masks > 0)


def box_plan(shape: Tuple[int, int], boxes, centre: torch.Tensor,
             shared_px: int):
    """The kernel's table from the boxes ``(count, y0, y1, x0, x1)`` of
    labels 0..N (``ops/flows.py:_geometry``) and the (N,) frame index of
    each mask's centre. Returns

    - ``table``: (N, 7) int32 rows (label, y0, x0, h, w, cy, cx), the
      shared-form masks first by size class (labels ascending within one),
      then the global form's, then absent labels;
    - ``cls``: (N,) int64 class of labels 1..N: c (box long side in
      (2^(c-1), 2^c]) for the shared form, ``top + 1`` for the global form
      (padded box over ``shared_px`` pixels), ``top + 2`` for an absent
      label, with ``top`` = ``(max(Y, X) - 1).bit_length()``;
    - ``stats``: int64 on the boxes' device, the masks of each class 0..top
      and of the global form, then the largest padded box of each class
      0..top (0 where empty), for the caller's one host read."""
    Y, X = shape
    cnt, y0, y1, x0, x1 = (t[1:] for t in boxes)
    dev = cnt.device
    present = cnt > 0
    h = torch.where(present, y1 - y0 + 1, 0)
    w = torch.where(present, x1 - x0 + 1, 0)
    area = (h + 2) * (w + 2)
    top = (max(Y, X) - 1).bit_length()
    # the least c with 2^c >= the longer side: the bit length of side - 1
    side = torch.maximum(h, w).clamp(min=1) - 1
    cls = torch.frexp(side.to(torch.float64)).exponent.to(torch.int64)
    cls = torch.where(area > shared_px, top + 1, cls)
    cls = torch.where(present, cls, top + 2)
    order = torch.argsort(cls, stable=True)
    labels = torch.arange(1, cnt.numel() + 1, device=dev)
    table = torch.stack([labels, y0, x0, h, w, centre // X, centre % X], 1)
    table = table[order].to(torch.int32).contiguous()
    per_class = torch.zeros(top + 3, dtype=torch.int64, device=dev)
    per_class.index_add_(0, cls, torch.ones_like(cls))
    largest = torch.zeros(top + 3, dtype=torch.int64, device=dev)
    largest.scatter_reduce_(0, cls, area, "amax")
    return table, cls, torch.cat([per_class[:top + 2], largest[:top + 1]])


class Plan(NamedTuple):
    """What :func:`run` launches: the labels, the box table (``box_plan``),
    the class of each label, the centres, and the numbers of the host
    read."""

    masks: torch.Tensor
    table: torch.Tensor
    cls: torch.Tensor
    centre: torch.Tensor
    n_iter: int
    pixels: int
    per_class: List[int]
    largest: List[int]
    n_global: int


def plan(masks: torch.Tensor, boxes, centre: torch.Tensor,
         form: str = "auto") -> Plan:
    """The launches of (Y, X) int32 labels 1..N on the card, with their
    boxes (``ops/flows.py:_geometry``) and the (N,) frame index of each
    centre, through one host read: n_iter, the mask pixels, the masks per
    size class and their largest boxes together. With ``form="global"``
    every mask takes the global form."""
    _device.require_cuda_tensor(masks, torch.int32, 2, "flow_diffuse")
    if form not in ("auto", "global"):
        raise ValueError(f"flow_diffuse: form must be 'auto' or 'global', "
                         f"got {form!r}")
    Y, X = masks.shape
    shared_px = 0 if form == "global" else _shared_px(_lib(), masks.device)
    table, cls, stats = box_plan((Y, X), boxes, centre, shared_px)
    cnt, y0, y1, x0, x1 = boxes
    ext = (y1[1:] - y0[1:] + 2) + (x1[1:] - x0[1:] + 2)
    head = torch.stack([ext.max(), cnt[1:].sum()])
    got = torch.cat([head, stats]).tolist()     # the stage's one host read
    top = (max(Y, X) - 1).bit_length()
    return Plan(masks, table, cls, centre, 2 * got[0], got[1],
                got[2:top + 3], got[top + 4:], got[top + 3])


def run(p: Plan) -> torch.Tensor:
    """The (Y + 2, X + 2) float64 T of plan ``p``: one launch of the shared
    form a nonempty size class, then the global form's masks, one launch an
    iteration; no host read. Adds the global form's masks to
    ``COUNTS["qc_masks_global"]``."""
    masks, n_iter = p.masks, p.n_iter
    Y, X = masks.shape
    dev = masks.device
    lib = _lib()
    T = torch.zeros((Y + 2, X + 2), dtype=torch.float64, device=dev)
    launches = at = 0
    for n, px in zip(p.per_class, p.largest):
        if n and n_iter:
            _device.launch(lib, lib.flow_diffuse_boxes, dev, "flow_diffuse",
                           _device.ptr(masks), _device.ptr(p.table[at:]), n,
                           Y, X, n_iter, _threads(px), _smem_bytes(px),
                           _device.ptr(T))
            launches += 1
        at += n
    if p.n_global and n_iter:
        top = len(p.per_class) - 1
        is_global = torch.zeros(p.cls.numel() + 1, dtype=torch.uint8,
                                device=dev)
        is_global[1:] = p.cls == top + 1
        c = p.centre
        cpad = torch.cat([c.new_zeros(1), (c // X + 1) * (X + 2) + c % X + 1])
        cpad = cpad.to(torch.int32)
        bits = neighbour_bits(masks)
        scratch = torch.zeros_like(T)
        _device.launch(lib, lib.flow_diffuse_global, dev,
                       "flow_diffuse_global", _device.ptr(masks),
                       _device.ptr(bits), _device.ptr(is_global),
                       _device.ptr(cpad), _device.ptr(T),
                       _device.ptr(scratch), Y, X, n_iter)
        _device.count_launch("flow_diffuse_global", n_iter)
    _device.count_launch("flow_diffuse", launches)
    _device.count("qc_masks_global", p.n_global)
    return T
