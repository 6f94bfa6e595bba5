"""Watershed flood kernels: CUDA wrappers and their plain PyTorch versions.

Port of the flood kernels of ``tissue_image_processing_tpu/ops/flood_pallas.py``:

- :func:`bf_flood` — phase-1 flood levels, lam = minimax path elevation from
  any seed (Bellman-Ford on the (min, max) semiring; ``bf_flood_pallas``);
- :func:`cc_diffusion` — 4-connected component minimum of an initial value
  (``cc_diffusion_pallas``): by Jacobi sweeps, or with ``scan=True`` by
  :func:`cc_scan`, iterated segmented row / column min-scans
  (``_cc_scan_kernel``; ``csrc/cc_scan.cu``), the route for image-scale
  components such as the background sea of a binary boundary map;
- :func:`settle_mask` — the lam-comparison bitmask (``_settle_mask``);
- :func:`settle` — the phase-2 Meyer settle with arrival stamps
  (``settle_pallas_loop``), in the unpacked label domain, so it needs neither
  the packed form's 21-bit label guard nor its 1022-sweep stamp cap.

All are exact: the CUDA kernels (``csrc/flood.cu``) and the plain versions
compute the same Jacobi sweeps and agree bit for bit. The diffusion fixpoints
do not depend on the schedule, so the scan route returns the very array the
sweep route returns; the settle's stamps do depend on it, and both versions
keep exact Jacobi sweeps (stamp = sweep index, seeds 0).

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
           "BIG_T", "SWEEP_BATCH", "SCAN_MAX_ITERS"]

# Arrival stamp of pixels that never settle. The line pass only compares
# stamps of settled, labelled pixels, so the value is never read; it is the
# XLA path's ``iinfo(int32).max // 2``.
BIG_T = (1 << 30) - 1
# Sweeps per batch: only the last sweep of a batch reports "changed", and the
# host reads that flag once per batch (the TPU kernels' _SWEEP_BATCH).
SWEEP_BATCH = 8
# Scan iterations after which :func:`cc_scan` raises instead of returning an
# unconverged array. One iteration carries a value along a whole straight
# run in each of the four directions, so the count grows with the turns of
# the most winding component: a few on boundary maps, H / 2 on a one-pixel
# serpentine.
SCAN_MAX_ITERS = 1 << 16
_SCAN_BIG = (1 << 31) - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bf_sweeps": (_P, _P, _P, _P, _I, _I, _I, _P),
    "cc_sweeps": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "settle_mask": (_P, _P, _I, _I, _P),
    "settle_sweeps": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}
_SCAN_SIGNATURES = {"cc_scan_iteration": (_P, _P, _P, _I, _I, _P)}
_INF = float("inf")


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


def _run_batches(launch, name: str) -> None:
    """Launch SWEEP_BATCH-sweep batches until a batch's last sweep changed
    nothing. ``launch()`` returns the batch's device flag."""
    while True:
        flag = launch()
        _device.LAUNCHES[name] += SWEEP_BATCH
        if int(flag.item()) == 0:
            return


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
    _device.require_cuda_tensor(img, torch.float32, 2, "bf_flood")
    lib = _lib()
    H, W = img.shape
    a = torch.where(seeds > 0, img, torch.full_like(img, _INF)).contiguous()
    b = torch.empty_like(a)
    flag = torch.empty((1,), dtype=torch.int32, device=img.device)

    def launch():
        rc = lib.bf_sweeps(_device.ptr(img), _device.ptr(a), _device.ptr(b),
                           _device.ptr(flag), H, W, SWEEP_BATCH,
                           _device.stream_ptr())
        _device.check_cuda(lib, rc, "bf_flood")
        return flag

    _run_batches(launch, "diffusion_bf")
    return a


# --- connected-component minimum --------------------------------------------

def _cc_init(mask: torch.Tensor, init) -> Tuple[torch.Tensor, int]:
    H, W = mask.shape
    n = H * W
    if 2 * n >= 2 ** 31:  # poisoned inits reach idx - n; all must fit int32
        raise ValueError(f"cc_diffusion: {H}x{W} image too large for int32 labels")
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
    stay below H*W. ``scan`` takes the segmented-scan route
    (:func:`cc_scan`), which returns the same array."""
    if scan:
        return cc_scan(mask, init)
    if init is not None:
        _require_like(mask, init, "cc_diffusion init")
    if mask.device.type == "cpu":
        return cc_diffusion_plain(mask, init)
    if mask.dim() != 2 or mask.dtype != torch.bool:
        raise ValueError("cc_diffusion: mask must be a 2-D bool tensor")
    lib = _lib()
    H, W = mask.shape
    a, n = _cc_init(mask, init)
    a = a.contiguous()
    m = mask.to(torch.int32).contiguous()
    _device.require_cuda_tensor(m, torch.int32, 2, "cc_diffusion")
    b = torch.empty_like(a)
    flag = torch.empty((1,), dtype=torch.int32, device=mask.device)

    def launch():
        rc = lib.cc_sweeps(_device.ptr(m), _device.ptr(a), _device.ptr(b),
                           _device.ptr(flag), H, W, n, SWEEP_BATCH,
                           _device.stream_ptr())
        _device.check_cuda(lib, rc, "cc_diffusion")
        return flag

    _run_batches(launch, "diffusion_cc")
    return torch.where(mask, a, -1)


# --- connected-component minimum by segmented scans ---------------------------

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


def cc_scan(mask: torch.Tensor, init: torch.Tensor | None = None,
            return_iterations: bool = False):
    """:func:`cc_diffusion` by iterated segmented row / column min-scans: one
    iteration carries a value along every straight run of the mask, so
    image-spanning components converge in a few iterations where the sweeps
    need one per pixel of diameter. Iterates to the fixpoint (the last
    iteration changes nothing) and raises past ``SCAN_MAX_ITERS``."""
    if init is not None:
        _require_like(mask, init, "cc_scan init")
    if mask.dim() != 2 or mask.dtype != torch.bool:
        raise ValueError("cc_scan: mask must be a 2-D bool tensor")
    if mask.device.type == "cpu":
        return cc_scan_plain(mask, init, return_iterations)
    lib = _scan_lib()
    H, W = mask.shape
    lbl, _ = _cc_init(mask, init)
    lbl = lbl.contiguous()
    conn = cc_connectivity(mask).contiguous()
    _device.require_cuda_tensor(lbl, torch.int32, 2, "cc_scan")
    _device.require_cuda_tensor(conn, torch.uint8, 2, "cc_scan")
    flag = torch.empty((1,), dtype=torch.int32, device=mask.device)
    iterations = 0
    while True:
        if iterations >= SCAN_MAX_ITERS:
            raise RuntimeError(
                f"cc_scan: no fixpoint after {SCAN_MAX_ITERS} iterations")
        rc = lib.cc_scan_iteration(_device.ptr(conn), _device.ptr(lbl),
                                   _device.ptr(flag), H, W,
                                   _device.stream_ptr())
        _device.check_cuda(lib, rc, "cc_scan")
        _device.LAUNCHES["cc_scan"] += 1
        iterations += 1
        if int(flag.item()) == 0:
            break
    out = torch.where(mask, lbl, -1)
    return (out, iterations) if return_iterations else out


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
    rc = lib.settle_mask(_device.ptr(lam), _device.ptr(mask), H, W,
                         _device.stream_ptr())
    _device.check_cuda(lib, rc, "settle_mask")
    _device.LAUNCHES["settle_mask"] += 1
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
    # a copy: the kernel path updates the label state in place
    lbl0 = seeds.to(torch.int32, copy=True)
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
    lib = _lib()
    H, W = mask.shape
    a, t = _settle_init(seeds)
    a, t = a.contiguous(), t.contiguous()
    _device.require_cuda_tensor(a, torch.int32, 2, "settle")
    b = torch.empty_like(a)
    flag = torch.empty((1,), dtype=torch.int32, device=a.device)
    it0 = [1]

    def launch():
        rc = lib.settle_sweeps(_device.ptr(mask), _device.ptr(a),
                               _device.ptr(b), _device.ptr(t),
                               _device.ptr(flag), H, W, it0[0], SWEEP_BATCH,
                               _device.stream_ptr())
        _device.check_cuda(lib, rc, "settle")
        it0[0] += SWEEP_BATCH
        return flag

    _run_batches(launch, "settle")
    return a, t
