"""Watershed flood kernels: CUDA wrappers and their plain PyTorch versions.

Port of the flood kernels of ``tissue_image_processing_tpu/ops/flood_pallas.py``:

- :func:`bf_flood` — phase-1 flood levels, lam = minimax path elevation from
  any seed (Bellman-Ford on the (min, max) semiring; ``bf_flood_pallas``);
- :func:`cc_diffusion` — 4-connected component minimum of an initial value
  (``cc_diffusion_pallas``): by relaxation, or with ``scan=True`` by
  :func:`cc_scan` (``_cc_scan_kernel``), the route for image-scale
  components such as the background sea of a binary boundary map;
- :func:`settle_mask` — the lam-comparison bitmask (``_settle_mask``);
- :func:`settle` — the phase-2 Meyer settle with arrival stamps
  (``settle_pallas_loop``), in the unpacked label domain, so it needs neither
  the packed form's 21-bit label guard nor its 1022-sweep stamp cap.

On the card (``csrc/flood.cu``, ``csrc/cc_scan.cu``):

- the two diffusions are one kernel with two combines, a tile-resident
  relaxation: one persistent cooperative launch a call, in which blocks
  relax 64 x 64 tiles to their own fixpoint in shared memory and rounds
  repeat over the tiles whose halo changed until none did. The host reads
  nothing back;
- :func:`cc_scan` is label equivalence (union-find): tiles resolved in
  shared memory, seams united with lock-free ``atomicMin`` unions, the
  minima folded once per tile and component. Four launches whatever the
  mask, no host read;
- the settle is temporal blocking with ghost zones, again one persistent
  cooperative launch a call: a round is eight exact Jacobi sweeps on 64 x 64
  tiles held in shared memory with an eight-pixel halo, the region that is
  still exact shrinking by one ring a sweep; rounds repeat, over the tiles
  near which the round before still settled something, until a round's last
  sweep settles nothing. The arrival stamp tells a loader whether a
  neighbour's pixel was settled when the round began. The host reads
  nothing; the first round builds the initial state from the seeds.

All are exact. The diffusion fixpoints are minima (or min-max selections)
over sets and do not depend on the order of the updates, so the kernels, the
plain versions (Jacobi sweeps; row / column scans) and each other agree bit
for bit, in every run. The settle's stamps do depend on the schedule, and
both its versions compute the exact Jacobi sequence (stamp = sweep index,
seeds 0).

CPU tensors run the plain versions; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.ops.morphology import shift2d

__all__ = ["bf_flood", "bf_flood_plain", "cc_diffusion", "cc_diffusion_plain",
           "cc_scan", "cc_scan_plain", "cc_connectivity",
           "settle_mask", "settle_mask_plain", "settle", "settle_plain",
           "BIG_T"]

# Arrival stamp of pixels that never settle. The line pass only compares
# stamps of settled, labelled pixels, so the value is never read; it is the
# XLA path's ``iinfo(int32).max // 2``.
BIG_T = (1 << 30) - 1
_SCAN_BIG = (1 << 31) - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "diffusion_flag_ints": (_I, _I),
    "bf_diffusion": (_P, _P, _P, _P, _I, _I, _P),
    "cc_diffusion": (_P, _P, _P, _P, _I, _I, _P),
    "settle_mask": (_P, _P, _I, _I, _P),
    "settle_flag_ints": (_I, _I),
    "settle_sweeps": (_P, _P, _P, _P, _P, _I, _I, _P),
}
_SCAN_SIGNATURES = {"cc_scan_min": (_P, _P, _P, _P, _I, _I, _P)}
_SCAN_LAUNCHES = 4  # tiles, seams, fold, result
_INF = float("inf")
# Rounds of the last diffusion or settle call on the card, by kernel name, and
# the sweeps of the last settle call: one-element device tensors (reading one
# synchronises; the wrappers never do).
_ROUNDS = {}
_SWEEPS = {}


def _lib():
    return _device.load_library("flood", _SIGNATURES)


def _scan_lib():
    return _device.load_library("cc_scan", _SCAN_SIGNATURES)


def _min4(st: torch.Tensor, fill) -> torch.Tensor:
    return torch.minimum(
        torch.minimum(shift2d(st, 1, 0, fill), shift2d(st, -1, 0, fill)),
        torch.minimum(shift2d(st, 0, 1, fill), shift2d(st, 0, -1, fill)))


def _fixpoint(step, st: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Iterate a monotone Jacobi ``step`` to its fixpoint; returns the state
    and the number of sweeps that changed it."""
    sweeps = 0
    while True:
        new = step(st)
        if torch.equal(new, st):
            return st, sweeps
        st = new
        sweeps += 1


def _require_like(ref: torch.Tensor, other: torch.Tensor, what: str) -> None:
    """Raise unless ``other`` has ``ref``'s shape and device: the kernels size
    their grids from ``ref`` and index ``other`` with the same extents."""
    if other.shape != ref.shape or other.device != ref.device:
        raise ValueError(f"{what}: expected {tuple(ref.shape)} on {ref.device}, "
                         f"got {tuple(other.shape)} on {other.device}")


def _require_mask(mask: torch.Tensor, what: str) -> None:
    if mask.dim() != 2 or mask.dtype != torch.bool:
        raise ValueError(f"{what}: mask must be a 2-D bool tensor")
    _require_label_range(mask, what)


def _require_label_range(mask: torch.Tensor, what: str) -> None:
    H, W = mask.shape
    if 2 * H * W >= 2 ** 31:  # poisoned inits reach idx - n; all must fit int32
        raise ValueError(f"{what}: {H}x{W} image too large for int32 labels")


def _mask_and_init(mask: torch.Tensor, init, what: str):
    """The mask as one byte a pixel and ``init`` as int32 (or a null
    pointer for the flat index), both contiguous, for the kernels."""
    m = mask.contiguous().view(torch.uint8)
    _device.require_cuda_tensor(m, torch.uint8, 2, what)
    if init is None:
        return m, None, ctypes.c_void_p(None)
    init = init.to(torch.int32).contiguous()
    _device.require_cuda_tensor(init, torch.int32, 2, what)
    return m, init, _device.ptr(init)


def _diffusion_flags(lib, name: str, H: int, W: int,
                     device: torch.device) -> torch.Tensor:
    """Scratch for one diffusion launch (the tiles' dirty flags); its last
    element receives the number of rounds."""
    flags = torch.empty((lib.diffusion_flag_ints(H, W),), dtype=torch.int32,
                        device=device)
    _ROUNDS[name] = flags[-1:]
    return flags


# --- phase 1: Bellman-Ford flood levels ------------------------------------

def bf_flood_plain(img: torch.Tensor, seeds: torch.Tensor,
                   return_sweeps: bool = False):
    """Plain version of :func:`bf_flood`."""
    img = img.to(torch.float32)
    lam0 = torch.where(seeds > 0, img, torch.full_like(img, _INF))
    lam, sweeps = _fixpoint(
        lambda st: torch.minimum(st, torch.maximum(_min4(st, _INF), img)), lam0)
    return (lam, sweeps) if return_sweeps else lam


def bf_flood(img: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Flood levels lam = minimax path elevation from any seed (seeds > 0);
    +inf where no seed is reachable."""
    _require_like(img, seeds, "bf_flood seeds")
    if img.device.type == "cpu":
        return bf_flood_plain(img, seeds)
    img = img.to(torch.float32).contiguous()
    seeds = seeds.to(torch.int32).contiguous()
    _device.require_cuda_tensor(img, torch.float32, 2, "bf_flood")
    _device.require_cuda_tensor(seeds, torch.int32, 2, "bf_flood seeds")
    lib = _lib()
    H, W = img.shape
    lam = torch.empty_like(img)
    flags = _diffusion_flags(lib, "diffusion_bf", H, W, img.device)
    _device.launch(lib, lib.bf_diffusion, img.device, "bf_flood",
                   _device.ptr(img), _device.ptr(seeds), _device.ptr(lam),
                   _device.ptr(flags), H, W)
    _device.count_launch("diffusion_bf")
    return lam


# --- connected-component minimum --------------------------------------------

def _cc_init(mask: torch.Tensor, init) -> Tuple[torch.Tensor, int]:
    _require_label_range(mask, "cc_diffusion")
    H, W = mask.shape
    n = H * W
    if init is None:
        init = torch.arange(n, dtype=torch.int32,
                            device=mask.device).reshape(H, W)
    lbl0 = torch.where(mask, init.to(torch.int32),
                       torch.full((H, W), n, dtype=torch.int32,
                                  device=mask.device))
    return lbl0, n


def cc_diffusion_plain(mask: torch.Tensor, init: torch.Tensor | None = None,
                       return_sweeps: bool = False):
    """Plain version of :func:`cc_diffusion`."""
    lbl0, n = _cc_init(mask, init)
    fill = torch.full_like(lbl0, n)
    lbl, sweeps = _fixpoint(
        lambda st: torch.where(mask, torch.minimum(st, _min4(st, n)), fill), lbl0)
    out = torch.where(mask, lbl, -1)
    return (out, sweeps) if return_sweeps else out


def cc_diffusion(mask: torch.Tensor, init: torch.Tensor | None = None,
                 scan: bool = False) -> torch.Tensor:
    """4-connected components of ``mask`` by min-diffusion: each component
    gets the MIN of its pixels' ``init`` values (default: the flat pixel
    index, i.e. the component's first raster pixel); -1 outside the mask.
    ``init`` may hold negative values to poison whole components, and must
    stay below H*W. ``scan`` takes the route for image-scale components
    (:func:`cc_scan`), which returns the same array."""
    if scan:
        return cc_scan(mask, init)
    if init is not None:
        _require_like(mask, init, "cc_diffusion init")
    if mask.device.type == "cpu":
        return cc_diffusion_plain(mask, init)
    _require_mask(mask, "cc_diffusion")
    m, init, init_ptr = _mask_and_init(mask, init, "cc_diffusion")
    lib = _lib()
    H, W = mask.shape
    lbl = torch.empty((H, W), dtype=torch.int32, device=mask.device)
    flags = _diffusion_flags(lib, "diffusion_cc", H, W, mask.device)
    _device.launch(lib, lib.cc_diffusion, mask.device, "cc_diffusion",
                   _device.ptr(m), init_ptr, _device.ptr(lbl),
                   _device.ptr(flags), H, W)
    _device.count_launch("diffusion_cc")
    return lbl


# --- connected-component minimum: the scan / union-find route -----------------

def cc_connectivity(mask: torch.Tensor) -> torch.Tensor:
    """The scan's link map, uint8: bit 0 = this pixel and its left neighbour
    are both in the mask, bit 1 = this pixel and the one above are. Pixels in
    the first column / row carry no such link."""
    m = mask.to(torch.uint8)
    conn = torch.zeros_like(m)
    conn[:, 1:] = m[:, 1:] & m[:, :-1]
    conn[1:] |= (m[1:] & m[:-1]) << 1
    return conn


def _scan_line(v: torch.Tensor, g: torch.Tensor, dim: int,
               reverse: bool) -> torch.Tensor:
    """Segmented inclusive min-scan of ``v`` along ``dim`` by doubling.
    ``g[i]`` says pixel i is joined to the pixel before it in scan order;
    after the step with offset k, ``v[i]`` is the minimum over the joined run
    of the last 2k pixels ending at i."""
    n = v.shape[dim]
    sy, sx = (1, 0) if dim == 0 else (0, 1)
    if reverse:
        sy, sx = -sy, -sx
    k = 1
    while k < n:
        vs = shift2d(v, sy * k, sx * k, _SCAN_BIG)
        gs = shift2d(g, sy * k, sx * k, False)
        v = torch.where(g, torch.minimum(v, vs), v)
        g = g & gs
        k *= 2
    return v


def cc_scan_plain(mask: torch.Tensor, init: torch.Tensor | None = None,
                  return_iterations: bool = False):
    """Plain version of :func:`cc_scan`: each iteration is a row scan
    forwards and backwards, then a column scan down and up, each a
    log-doubling segmented min-scan over the whole image."""
    lbl, _ = _cc_init(mask, init)
    conn = cc_connectivity(mask)
    left, up = (conn & 1) != 0, (conn & 2) != 0
    right, down = shift2d(left, 0, -1, False), shift2d(up, -1, 0, False)
    iterations = 0
    while True:
        new = _scan_line(lbl, left, 1, False)
        new = _scan_line(new, right, 1, True)
        new = _scan_line(new, up, 0, False)
        new = _scan_line(new, down, 0, True)
        iterations += 1
        if torch.equal(new, lbl):
            break
        lbl = new
    out = torch.where(mask, lbl, -1)
    return (out, iterations) if return_iterations else out


def cc_scan(mask: torch.Tensor, init: torch.Tensor | None = None
            ) -> torch.Tensor:
    """:func:`cc_diffusion` for components of any extent and winding. On the
    card: label equivalence, a fixed number of launches whatever the mask
    (tiles resolved in shared memory, seams united by lock-free unions, one
    ``atomicMin`` per tile and component) and no host read. On the CPU
    :func:`cc_scan_plain`, iterated row / column min-scans. Both return the
    array :func:`cc_diffusion` returns."""
    if init is not None:
        _require_like(mask, init, "cc_scan init")
    _require_mask(mask, "cc_scan")
    if mask.device.type == "cpu":
        return cc_scan_plain(mask, init)
    m, init, init_ptr = _mask_and_init(mask, init, "cc_scan")
    lib = _scan_lib()
    H, W = mask.shape
    out = torch.empty((H, W), dtype=torch.int32, device=mask.device)
    parent = torch.empty_like(out)
    _device.launch(lib, lib.cc_scan_min, mask.device, "cc_scan",
                   _device.ptr(m), init_ptr, _device.ptr(parent),
                   _device.ptr(out), H, W)
    _device.count_launch("cc_scan", _SCAN_LAUNCHES)
    return out


# --- phase 2: the settle ------------------------------------------------------

def settle_mask_plain(lam: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`settle_mask`."""
    lam = lam.to(torch.float32)
    qs = [shift2d(lam, 1, 0, _INF), shift2d(lam, -1, 0, _INF),
          shift2d(lam, 0, 1, _INF), shift2d(lam, 0, -1, _INF)]
    m = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    for k, q in enumerate(qs):
        m |= (q < lam).to(torch.int32) << k
        m |= (q <= lam).to(torch.int32) << (4 + k)
    return m


def settle_mask(lam: torch.Tensor) -> torch.Tensor:
    """The settle's lam comparisons as an int32 bitmask: for 4-neighbours
    q = N, S, W, E, bit k = (lam_q < lam) and bit 4+k = (lam_q <= lam), with
    +inf outside the image."""
    if lam.device.type == "cpu":
        return settle_mask_plain(lam)
    lam = lam.to(torch.float32).contiguous()
    _device.require_cuda_tensor(lam, torch.float32, 2, "settle_mask")
    lib = _lib()
    H, W = lam.shape
    mask = torch.empty(lam.shape, dtype=torch.int32, device=lam.device)
    _device.launch(lib, lib.settle_mask, lam.device, "settle_mask",
                   _device.ptr(lam), _device.ptr(mask), H, W)
    _device.count_launch("settle_mask")
    return mask


def _settle_step(mask: torch.Tensor, lbl: torch.Tensor):
    """One Jacobi settle sweep (``_settle_math``): returns (new_lbl, can)."""
    settled = lbl != 0
    qls = [shift2d(lbl, 1, 0, 0), shift2d(lbl, -1, 0, 0),
           shift2d(lbl, 0, 1, 0), shift2d(lbl, 0, -1, 0)]
    ready = torch.ones_like(settled)
    all_eq = torch.ones_like(settled)
    minl = torch.full_like(lbl, 1 << 30)
    maxl = torch.zeros_like(lbl)
    for k, ql in enumerate(qls):
        qsettled = ql != 0
        lt = (mask & (1 << k)) != 0
        le = (mask & (1 << (4 + k))) != 0
        ready = ready & (~lt | qsettled)
        all_eq = all_eq & (~le | qsettled)
        donor = (ql > 0) & le
        minl = torch.where(donor, torch.minimum(minl, ql), minl)
        maxl = torch.where(donor, torch.maximum(maxl, ql), maxl)
    has_donor = maxl > 0
    conflict = has_donor & (minl != maxl)
    ur = ~settled & ready
    settle_lbl = ur & has_donor & ~conflict
    settle_line = ur & conflict
    settle_void = ur & ~has_donor & all_eq
    can = settle_lbl | settle_line | settle_void
    new = torch.where(settle_lbl, maxl, torch.where(
        settle_line, -1, torch.where(settle_void, -2, lbl)))
    return new, can


def _settle_init(seeds: torch.Tensor):
    lbl0 = seeds.to(torch.int32)
    t0 = torch.where(seeds > 0, 0, BIG_T).to(torch.int32)
    return lbl0, t0


def settle_plain(lam: torch.Tensor, seeds: torch.Tensor,
                 return_sweeps: bool = False):
    """Plain version of :func:`settle`."""
    mask = settle_mask_plain(lam)
    lbl, t = _settle_init(seeds)
    it = 1
    while True:
        new, can = _settle_step(mask, lbl)
        if not bool(can.any()):
            break
        t = torch.where(can, it, t)
        lbl = new
        it += 1
    return (lbl, t, it - 1) if return_sweeps else (lbl, t)


def settle(lam: torch.Tensor, seeds: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ascending Meyer settle from ``seeds`` over flood levels ``lam``.

    Returns (lbl, t): lbl > 0 the settled label, -1 a line pixel (donors
    disagree), -2 a void (nothing can ever donate), 0 never settled; t the
    Jacobi sweep at which the pixel settled (0 for seeds, ``BIG_T`` never)."""
    _require_like(lam, seeds, "settle seeds")
    if lam.device.type == "cpu":
        return settle_plain(lam, seeds)
    mask = settle_mask(lam)
    seeds = seeds.to(torch.int32).contiguous()
    _device.require_cuda_tensor(seeds, torch.int32, 2, "settle seeds")
    _require_label_range(seeds, "settle")
    lib = _lib()
    H, W = mask.shape
    lbl, t = torch.empty_like(seeds), torch.empty_like(seeds)
    flags = torch.empty((lib.settle_flag_ints(H, W),), dtype=torch.int32,
                        device=seeds.device)
    _ROUNDS["settle"], _SWEEPS["settle"] = flags[-2:-1], flags[-1:]
    _device.launch(lib, lib.settle_sweeps, seeds.device, "settle",
                   _device.ptr(mask), _device.ptr(seeds), _device.ptr(lbl),
                   _device.ptr(t), _device.ptr(flags), H, W)
    _device.count_launch("settle")
    return lbl, t
