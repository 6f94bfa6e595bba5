"""The numbers that decide ``correct``: each compares an output of the
program's timed call with the plain reference's, as a share or a gap that
is 0 where the two agree.

- ``labels_mismatch``: the share of pixels outside the best-matching label
  pairs, taken both ways (a merge or a split counts), over the movie;
  background and line pixels (0) match only 0. Invariant to how labels are
  numbered.
- ``prob_gap``: the U-Net's largest difference of the HC probability
  (softmax channel 0) at a pixel of the movie's frames, the program's
  forward (read through PyTorch's module forward hook) against the
  reference's float32 forward on the reference's own projection.
- ``tables_mismatch``: the share of cell-table entries that differ (area,
  perimeter, centroid, bounding box, validity, neighbours).
- ``drift_gap``: the largest difference of a frame's drift, in pixels.
- ``ids_mismatch``: the share of table slots, valid on either side, whose
  track ids differ.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["labels_mismatch", "prob_gap", "tables_mismatch", "drift_gap", "ids_mismatch",
           "compare_movie"]

_TABLE_FIELDS = ("area", "perimeter", "cx", "cy", "valid", "empty_cell",
                 "bbox", "n_neighbors", "neighbors")


def _matched(a: torch.Tensor, b: torch.Tensor) -> int:
    """Pixels of (H, W) label maps a and b in agreement: background (0) on
    both sides, plus, for each label of a, its pixels in the label of b
    that holds most of them (0 never matches a label)."""
    a = a.reshape(-1).to(torch.int64)
    b = b.reshape(-1).to(torch.int64)
    both = (a > 0) & (b > 0)
    agree = int(((a == 0) & (b == 0)).sum())
    if not bool(both.any()):
        return agree
    a, b = a[both], b[both]
    n = int(b.max()) + 1
    pairs, counts = torch.unique(a * n + b, return_counts=True)
    best = torch.zeros(int(a.max()) + 1, dtype=torch.int64, device=a.device)
    best.scatter_reduce_(0, pairs // n, counts, "amax")
    return agree + int(best.sum())


def labels_mismatch(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of pixels of (T, H, W) label maps outside the best-matching
    pairs, the larger of the two directions."""
    if got.shape != want.shape:
        return 1.0
    want = want.to(got.device)
    total = got.numel()
    a = sum(_matched(g, w) for g, w in zip(got, want))
    b = sum(_matched(w, g) for g, w in zip(got, want))
    return 1.0 - min(a, b) / total


def prob_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |difference| of channel 0 of two (T, X, Y, 2) softmaxes."""
    if got.shape != want.shape:
        return float("inf")
    return float((got[..., 0].float() - want[..., 0].to(got.device)).abs()
                 .max())


def tables_mismatch(got, want) -> float:
    """Share of differing entries over the table fields."""
    diff = total = 0
    for name in _TABLE_FIELDS:
        x = getattr(got, name)
        y = getattr(want, name).to(x.device)
        if x.shape != y.shape:
            return 1.0
        diff += int((x != y).sum())
        total += x.numel()
    return diff / total


def drift_gap(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max()) if got.size else 0.0


def ids_mismatch(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return 1.0
    used = (got != 0) | (want != 0)
    return float((got != want)[used].mean()) if used.any() else 0.0


def compare_movie(out: dict, ref: dict) -> dict:
    """Every number of one movie: the program's output ``out`` (the dict
    ``movie_pipeline`` returns, with the U-Net's softmax under ``probs``)
    against the reference's ``ref``."""
    numbers = {"labels_mismatch": labels_mismatch(out["labels"],
                                                  ref["labels"])}
    if "probs" in ref:
        numbers["prob_gap"] = (prob_gap(out["probs"], ref["probs"])
                               if out.get("probs") is not None
                               else float("inf"))
    numbers.update(tables_mismatch=tables_mismatch(out["tables"],
                                                   ref["tables"]),
                   drift_gap=drift_gap(out["drifts"], ref["drifts"]),
                   ids_mismatch=ids_mismatch(out["ids"], ref["ids"]))
    return numbers
