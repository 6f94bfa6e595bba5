"""Carried state from numpy leaves.

The watershed pipeline learns no weights; what it carries is the chunked
tracker's ``TrackingState`` and the per-frame ``CellTable``s. These helpers
build the port's dataclasses from numpy arrays keyed by field name — for
example the leaves of the JAX package's dataclasses of the same names — so a
run can resume from a carry produced elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from tissue_image_processing_tpu_torch._device import resolve_device
from tissue_image_processing_tpu_torch.core.cell_table import CellTable
from tissue_image_processing_tpu_torch.core.tracking import TrackingState

__all__ = ["tracking_state_from_numpy", "cell_table_from_numpy"]

_STATE_DTYPES = {"pos": torch.float32, "sqrt_area": torch.float32,
                 "track_id": torch.int32, "age": torch.int32,
                 "next_id": torch.int32}
_TABLE_DTYPES = {"area": torch.float32, "perimeter": torch.float32,
                 "label": torch.int32, "cx": torch.float32,
                 "cy": torch.float32, "valid": torch.int32,
                 "type": torch.uint8, "bbox": torch.int32,
                 "empty_cell": torch.int32, "neighbors": torch.int32,
                 "n_neighbors": torch.int32}


def _convert(cls, dtypes, leaves: Mapping[str, np.ndarray], device):
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(leaves)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{n: torch.from_numpy(np.array(leaves[n])).to(
        dtype=dtypes[n], device=dev) for n in names})


def tracking_state_from_numpy(leaves: Mapping[str, np.ndarray],
                              device=None) -> TrackingState:
    """``TrackingState`` from arrays named pos, sqrt_area, track_id, age,
    next_id."""
    return _convert(TrackingState, _STATE_DTYPES, leaves, device)


def cell_table_from_numpy(leaves: Mapping[str, np.ndarray],
                          device=None) -> CellTable:
    """``CellTable`` from arrays named like its fields (one frame or a stack
    of frames)."""
    return _convert(CellTable, _TABLE_DTYPES, leaves, device)
