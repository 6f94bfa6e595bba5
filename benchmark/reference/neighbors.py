"""Neighbour graph and contact lengths of a label map.

Frozen copy of the plain code of the port's ``ops/neighbors.py``:

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

from benchmark.reference.morphology import maximum_filter

__all__ = ["adjacency_matrix", "adjacency_matrix_checked", "neighbor_lists"]


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
