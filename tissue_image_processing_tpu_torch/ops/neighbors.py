"""Neighbour graph and contact lengths of a label map.

Port of ``tissue_image_processing_tpu/ops/neighbors.py``:

- adjacency: a cell's 5x5 max-filter dilation covering another cell's pixels
  makes the two neighbours (reference ``find_neighbors``). Each pixel votes
  for its (window-max, own label) pair; the votes are either scattered one
  per pixel (exact) or run-deduplicated along rows and ``top_k``-compacted
  first (exact whenever no row carries more than ``k`` vote runs, which
  :func:`adjacency_overflow` reports);
- contact lengths: every boundary pixel votes for its (plus-neighbourhood
  max, plus-neighbourhood min) label pair and one scatter-add counts the
  votes; the compacted form adds run lengths of the row-wise RLE instead.
  Counts are integers below 2^24 summed in float32, so any summation order
  gives the JAX package's matrix exactly;
- second-order neighbours as one float32 matrix product (the JAX package
  leaves it to XLA's ``jnp.dot``; here ``torch.matmul``). As in the JAX
  package, first-order neighbours reachable through a valid intermediate
  stay in (the reference's no-op ``set.difference``); self pairs do not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tissue_image_processing_tpu_torch.ops.morphology import (
    maximum_filter, plus_maximum_filter, plus_minimum_filter)

__all__ = ["adjacency_matrix", "adjacency_matrix_checked",
           "adjacency_overflow", "neighbor_lists", "contact_length_matrix",
           "contact_length_matrix_checked", "second_order_adjacency"]


def _vote_keys(labels: torch.Tensor, ns: int) -> torch.Tensor:
    """(H, W) vote keys a*ns + b with a = 5x5 window max, b = pixel label;
    0 where the vote is invalid (background pixel or interior a == b)."""
    lab = labels.to(torch.int32)
    dil = maximum_filter(lab, 5, cval=0)
    valid = (lab > 0) & (dil != lab)
    return torch.where(valid, dil * ns + lab, 0)


def _run_starts(key: torch.Tensor) -> torch.Tensor:
    """Zero every vote that repeats its left neighbour, keeping run starts."""
    rest = torch.where(key[:, 1:] != key[:, :-1], key[:, 1:], 0)
    return torch.cat([key[:, :1], rest], 1)


def _row_overflow(first: torch.Tensor, k: int) -> torch.Tensor:
    return ((first > 0).sum(dim=1) > k).any()


def adjacency_overflow(labels: torch.Tensor, num_labels: int,
                       k: int = 192) -> torch.Tensor:
    """Bool scalar: would the ``compact_k=k`` adjacency drop pairs here?"""
    return _row_overflow(_run_starts(_vote_keys(labels, num_labels + 1)), k)


def _adjacency_impl(labels, num_labels, working_mask, compact_k):
    ns = num_labels + 1
    key = _vote_keys(labels, ns)
    overflow = torch.zeros((), dtype=torch.bool, device=labels.device)
    if compact_k is not None:
        first = _run_starts(key)
        overflow = _row_overflow(first, compact_k)
        votes = torch.topk(first, min(compact_k, key.shape[1]), dim=1).values
        flat_idx = votes.reshape(-1)
    else:
        flat_idx = key.reshape(-1)
    # a label above num_labels gives a key past the table: drop the vote, as
    # the JAX package's scatter drops out-of-range indices
    flat_idx = torch.where(flat_idx < ns * ns, flat_idx, 0)
    adj = torch.zeros(ns * ns, dtype=torch.bool, device=labels.device)
    adj[flat_idx.to(torch.int64)] = True
    adj[0] = False
    adj = adj.reshape(ns, ns)
    if working_mask is not None:
        # rows of the pre-symmetrised matrix are the window-max side
        adj = adj & working_mask[:, None]
    adj = adj | adj.T
    adj[:, 0] = False
    adj[0, :] = False
    adj.fill_diagonal_(False)
    return adj, overflow


def adjacency_matrix(labels: torch.Tensor, num_labels: int,
                     working_mask: Optional[torch.Tensor] = None,
                     compact_k: Optional[int] = None) -> torch.Tensor:
    """(num_labels+1, num_labels+1) symmetric bool adjacency.

    ``working_mask`` (num_labels+1,) keeps only pairs whose larger (window
    max) label is in the mask; ``compact_k`` selects the compacted scatter
    (None: one exact vote per pixel)."""
    return _adjacency_impl(labels, num_labels, working_mask, compact_k)[0]


def adjacency_matrix_checked(labels: torch.Tensor, num_labels: int,
                             working_mask: Optional[torch.Tensor] = None,
                             compact_k: int = 192
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compacted adjacency plus its overflow flag: (adj, overflow)."""
    return _adjacency_impl(labels, num_labels, working_mask, compact_k)


def neighbor_lists(adj: torch.Tensor, max_neighbors: int = 64
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adjacency -> (neighbors (N+1, max_neighbors) int32 ascending with
    0-padding, counts (N+1,) int32)."""
    ns = adj.shape[0]
    col = torch.arange(ns, dtype=torch.int32, device=adj.device)[None, :]
    key = torch.where(adj, ns - col, 0)
    vals, order = torch.topk(key, min(max_neighbors, ns), dim=1)
    neighbors = torch.where(vals > 0, order, 0).to(torch.int32)
    if neighbors.shape[1] < max_neighbors:
        neighbors = torch.nn.functional.pad(
            neighbors, (0, max_neighbors - neighbors.shape[1]))
    counts = adj.sum(dim=1).to(torch.int32)
    return neighbors, counts


def _run_lengths(key: torch.Tensor) -> torch.Tensor:
    """(H, W) int32: at each run start the length of that run within its
    row, 0 elsewhere; with :func:`_run_starts` an exact RLE of the votes."""
    H, W = key.shape
    idx = torch.arange(W, dtype=torch.int32, device=key.device).expand(H, W)
    chg = torch.ones((H, W), dtype=torch.bool, device=key.device)
    chg[:, 1:] = key[:, 1:] != key[:, :-1]
    m = torch.where(chg, idx, W)
    # nm[j] = min over j' >= j of m[j']; the next change after j is nm[j + 1]
    nm = torch.flip(torch.cummin(torch.flip(m, [1]), dim=1).values, [1])
    nxt = torch.cat([nm[:, 1:], torch.full((H, 1), W, dtype=torch.int32,
                                           device=key.device)], 1)
    return torch.where(chg, nxt - idx, 0)


def _contact_impl(labels, num_labels, compact_k):
    lab = labels.to(torch.int32)
    mx = plus_maximum_filter(lab, cval=0)
    ns = num_labels + 1
    mn = plus_minimum_filter(torch.where(lab == 0, ns, lab), cval=0)
    valid = (mx > mn) & (mn > 0) & (mx <= num_labels)
    key = torch.where(valid, mx * ns + mn, 0)
    overflow = torch.zeros((), dtype=torch.bool, device=labels.device)
    if compact_k is not None:
        first = _run_starts(key)
        overflow = _row_overflow(first, compact_k)
        vals, pos = torch.topk(first, min(compact_k, key.shape[1]), dim=1)
        run_len = torch.gather(_run_lengths(key), 1, pos)
        flat_idx = vals.reshape(-1)
        add = torch.where(vals > 0, run_len, 0).reshape(-1).to(torch.float32)
    else:
        flat_idx = key.reshape(-1)
        add = valid.reshape(-1).to(torch.float32)
    counts = torch.zeros(ns * ns, dtype=torch.float32, device=labels.device)
    counts.index_add_(0, flat_idx.to(torch.int64), add)
    counts = counts.reshape(ns, ns)
    counts[0, 0] = 0.0
    return counts + counts.T, overflow


def contact_length_matrix(labels: torch.Tensor, num_labels: int,
                          compact_k: Optional[int] = None) -> torch.Tensor:
    """Symmetric (N+1, N+1) float32 matrix of shared-boundary pixel counts:
    boundary pixel p counts for the pair (max over its plus-neighbours, min
    over its plus-neighbours with 0 read as N+1), the reference's
    plus-filter construction. ``compact_k`` selects the run-length form
    (exact while every row has at most ``compact_k`` vote runs)."""
    return _contact_impl(labels, num_labels, compact_k)[0]


def contact_length_matrix_checked(labels: torch.Tensor, num_labels: int,
                                  compact_k: int = 192
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compacted contact matrix plus its overflow flag: (mat, overflow)."""
    return _contact_impl(labels, num_labels, compact_k)


def second_order_adjacency(adj: torch.Tensor, intermediate_valid: torch.Tensor,
                           target_ok: torch.Tensor) -> torch.Tensor:
    """adj2[i, k] = exists j: adj[i, j] & intermediate_valid[j] & adj[j, k]
    & target_ok[k]; self pairs and label 0 removed."""
    a = adj.to(torch.float32)
    mid = a * intermediate_valid.to(torch.float32)[None, :]
    reach = (torch.matmul(mid, a) > 0) & target_ok.to(torch.bool)[None, :]
    reach.fill_diagonal_(False)
    reach[:, 0] = False
    reach[0, :] = False
    return reach
