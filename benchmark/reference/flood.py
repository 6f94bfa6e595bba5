"""Watershed flood phases, plain PyTorch.

Frozen copy of the plain versions in the port's ``ops/flood_cuda.py``:
Bellman-Ford flood levels, the connected-component minimum by Jacobi
relaxation and by row / column min-scans, the settle mask and the ascending
Meyer settle with arrival stamps. All are exact, and the port's kernels
equal them bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.morphology import shift2d

__all__ = ["bf_flood", "bf_flood_plain", "cc_diffusion", "cc_diffusion_plain",
           "cc_scan", "cc_scan_plain", "cc_connectivity", "settle_mask_plain",
           "settle", "settle_plain", "BIG_T"]

# Arrival stamp of pixels that never settle. The line pass only compares
# stamps of settled, labelled pixels, so the value is never read; it is the
# XLA path's ``iinfo(int32).max // 2``.
BIG_T = (1 << 30) - 1
_SCAN_BIG = (1 << 31) - 1

_INF = float("inf")
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
    return bf_flood_plain(img, seeds)


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
    """4-connected components of ``mask``: each component gets the MIN of its
    pixels' ``init`` values (default: the flat pixel index); -1 outside the
    mask. ``scan`` takes the row / column scan route (:func:`cc_scan`),
    which returns the same array."""
    if scan:
        return cc_scan(mask, init)
    if init is not None:
        _require_like(mask, init, "cc_diffusion init")
    return cc_diffusion_plain(mask, init)


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
    """:func:`cc_diffusion` by iterated row / column min-scans."""
    if init is not None:
        _require_like(mask, init, "cc_scan init")
    _require_mask(mask, "cc_scan")
    return cc_scan_plain(mask, init)


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
    return settle_plain(lam, seeds)
