"""Connected-component labelling.

Port of ``tissue_image_processing_tpu/ops/components.py``
(``skimage.measure.label`` / ``scipy.ndimage.label`` for splitting cells and
seeding). Components are labelled 1..N in raster order of their first
(top-left-most) pixel, background 0, as scipy and skimage number them.

Routes of :func:`connected_components`:

- CPU tensors, and ``connectivity=2`` everywhere: the plain version, the JAX
  package's gather-only label propagation with pointer jumping (each round a
  min over the neighbours, then two pointer dereferences), iterated to its
  fixpoint. No kernel computes 8-connectivity, in the JAX package or here,
  so on the card this route runs as plain PyTorch and reads one flag a round.
- CUDA tensors with ``connectivity=1``: the union-find component minimum
  (:func:`~tissue_image_processing_tpu_torch.ops.flood_cuda.cc_scan`,
  ``csrc/cc_scan.cu``, four launches, no host read) with the flat index as
  the initial value. A component's minimum flat index is its raster-first
  pixel, which is exactly the root the pointer jumping converges to, so
  :func:`relabel_roots` turns either root map into the same labels. If the
  kernel fails the call raises; it never falls back to the plain version.
"""

from __future__ import annotations

import torch

from tissue_image_processing_tpu_torch.ops.flood_cuda import cc_scan
from tissue_image_processing_tpu_torch.ops.morphology import shift2d

__all__ = ["connected_components", "relabel_roots", "relabel_sequential",
           "relabel_by_raster_order"]


def _neighbor_shifts(connectivity: int):
    if connectivity == 1:
        return [(1, 0), (-1, 0), (0, 1), (0, -1)]
    return [(1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)]


def _pointer_jumping_roots(mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Plain version: each masked pixel's component root (its smallest flat
    index) by label propagation with pointer jumping; -1 off the mask."""
    H, W = mask.shape
    n = H * W
    idx = torch.arange(n, dtype=torch.int32, device=mask.device).reshape(H, W)
    inf = torch.full_like(idx, n)
    mask_f = mask.reshape(-1)
    inf_f = inf.reshape(-1)

    def body(lbl):
        m = lbl
        for dy, dx in _neighbor_shifts(connectivity):
            m = torch.minimum(m, shift2d(lbl, dy, dx, n))
        flat = torch.where(mask, m, inf).reshape(-1)
        for _ in range(2):  # follow the pointer twice (gathers only)
            safe = torch.clamp(flat, 0, n - 1).long()
            flat = torch.where(mask_f, torch.minimum(flat, flat[safe]), inf_f)
        return flat.reshape(H, W)

    lbl = body(torch.where(mask, idx, inf))
    while True:
        new = body(lbl)
        if torch.equal(new, lbl):
            break
        lbl = new
    return torch.where(mask, lbl, -1)


def connected_components(mask: torch.Tensor,
                         connectivity: int = 1) -> torch.Tensor:
    """Label the connected components of a 2-D boolean mask: int32, background
    0, components 1..N in raster order of their first pixel. ``connectivity``
    1 is 4-connected, 2 is 8-connected."""
    return relabel_roots(_component_roots(mask, connectivity))


def _component_roots(mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Root map of ``mask``'s components: every foreground pixel holds the
    flat index of its component's raster-first pixel, background -1. The
    card route for ``connectivity=1`` is :func:`cc_scan`; see the module
    docstring."""
    if mask.dim() != 2:
        raise ValueError(f"connected_components takes a 2-D mask, got "
                         f"{tuple(mask.shape)}")
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    mask = mask.to(torch.bool)
    if mask.device.type == "cuda" and connectivity == 1:
        return cc_scan(mask)
    return _pointer_jumping_roots(mask, connectivity)


def relabel_roots(roots: torch.Tensor) -> torch.Tensor:
    """Dense raster-order labels 1..N from a root-index map (-1 = background):
    roots point to themselves, so a root's rank is a prefix count of
    self-pointing pixels; one cumsum and one gather."""
    flat = roots.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=roots.device)
    rank = torch.cumsum((flat == idx).to(torch.int32), 0, dtype=torch.int32)
    out = torch.where(flat >= 0, rank[torch.clamp(flat, 0, max(n - 1, 0))], 0)
    return out.reshape(roots.shape).to(torch.int32)


def relabel_sequential(labels: torch.Tensor, background: int = 0) -> torch.Tensor:
    """Map integer labels to consecutive 1..N by value (background -> 0).

    Contract, as in the JAX package: non-background values lie in
    ``[0, labels.numel())``; a sort, one scatter and one gather."""
    flat = labels.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    is_bg = flat == background
    big = torch.where(is_bg, n, flat)  # the sentinel n sorts after every value
    s = torch.sort(big).values
    newflag = torch.ones_like(s, dtype=torch.int32)
    newflag[1:] = (s[1:] != s[:-1]).to(torch.int32)
    rank = torch.cumsum(newflag, 0, dtype=torch.int32)
    # duplicates of a value carry the same rank, so any scatter winner is
    # right; values off the table go to a trash slot (dropped)
    table = torch.zeros(n + 2, dtype=torch.int32, device=labels.device)
    table[torch.where((s >= 0) & (s <= n), s, n + 1)] = rank
    out = table[torch.clamp(big, 0, n)]
    return torch.where(is_bg, 0, out).reshape(labels.shape)


def relabel_by_raster_order(labels: torch.Tensor) -> torch.Tensor:
    """Relabel 1..N by raster order of each label's first pixel (background
    0). Reads the largest label on the host, as the JAX version does."""
    flat = labels.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=labels.device)
    num = int(flat.max()) + 1 if n else 1
    first = torch.full((num,), torch.iinfo(torch.int32).max, dtype=torch.int64,
                       device=labels.device)
    first.scatter_reduce_(0, flat, idx, reduce="amin", include_self=True)
    first[0] = -1
    return relabel_sequential(first[flat].reshape(labels.shape), background=-1)
