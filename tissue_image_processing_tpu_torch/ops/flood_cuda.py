"""Watershed flood kernels: CUDA wrappers and their plain PyTorch versions.

Port of the flood kernels of ``tissue_image_processing_tpu/ops/flood_pallas.py``:

- :func:`bf_flood` — phase-1 flood levels, lam = minimax path elevation from
  any seed (Bellman-Ford on the (min, max) semiring; ``bf_flood_pallas``);
- :func:`cc_diffusion` — 4-connected component minimum of an initial value
  (``cc_diffusion_pallas`` with its sweep kernels);
- :func:`settle_mask` — the lam-comparison bitmask (``_settle_mask``);
- :func:`settle` — the phase-2 Meyer settle with arrival stamps
  (``settle_pallas_loop``), in the unpacked label domain, so it needs neither
  the packed form's 21-bit label guard nor its 1022-sweep stamp cap.

All four are exact: the CUDA kernels (``csrc/flood.cu``) and the plain
versions compute the same Jacobi sweeps and agree bit for bit. The diffusion
fixpoints do not depend on the schedule; the settle's stamps do, and both
versions keep exact Jacobi sweeps (stamp = sweep index, seeds 0).

CPU tensors run the plain versions; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.ops.morphology import shift2d

__all__ = ["bf_flood", "bf_flood_plain", "cc_diffusion", "cc_diffusion_plain",
           "settle_mask", "settle_mask_plain", "settle", "settle_plain",
           "BIG_T", "SWEEP_BATCH"]

# Arrival stamp of pixels that never settle. The line pass only compares
# stamps of settled, labelled pixels, so the value is never read; it is the
# XLA path's ``iinfo(int32).max // 2``.
BIG_T = (1 << 30) - 1
# Sweeps per batch: only the last sweep of a batch reports "changed", and the
# host reads that flag once per batch (the TPU kernels' _SWEEP_BATCH).
SWEEP_BATCH = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bf_sweeps": (_P, _P, _P, _P, _I, _I, _I, _P),
    "cc_sweeps": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "settle_mask": (_P, _P, _I, _I, _P),
    "settle_sweeps": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}
_INF = float("inf")


def _lib():
    return _device.load_library("flood", _SIGNATURES)


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


def cc_diffusion(mask: torch.Tensor,
                 init: torch.Tensor | None = None) -> torch.Tensor:
    """4-connected components of ``mask`` by min-diffusion: each component
    gets the MIN of its pixels' ``init`` values (default: the flat pixel
    index, i.e. the component's first raster pixel); -1 outside the mask.
    ``init`` may hold negative values to poison whole components."""
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
