"""Carried state and weights from numpy leaves.

The pipeline carries the chunked tracker's ``TrackingState`` and the
per-frame ``CellTable``s; ``tracking_state_from_numpy`` and
``cell_table_from_numpy`` build the port's dataclasses from numpy arrays
keyed by field name — for example the leaves of the JAX package's dataclasses
of the same names — so a run can resume from a carry produced elsewhere.
``unet_state_from_flax`` carries the U-Net's weights across: the Flax
variable tree of the JAX package's ``UNet`` as numpy arrays in, the
``state_dict`` of the port's ``UNet`` out.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from tissue_image_processing_tpu_torch._device import resolve_device
from tissue_image_processing_tpu_torch.core.cell_table import CellTable
from tissue_image_processing_tpu_torch.core.tracking import TrackingState

__all__ = ["tracking_state_from_numpy", "cell_table_from_numpy",
           "unet_state_from_flax"]

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


def unet_state_from_flax(variables: Mapping) -> dict:
    """``state_dict`` of the port's ``UNet`` from the Flax variable tree of
    the JAX package's ``UNet`` (numpy leaves), in either form: ``norm="bn"``
    (``params`` with ``BatchNorm_i/{scale,bias}`` and ``batch_stats`` with
    ``mean`` / ``var``) or the folded ``norm="shift"`` (``Shift_i``); a tree
    with neither loads into ``norm="none"``.

    Conv kernels go from HWIO to OIHW. A transposed-conv kernel
    ``(kh, kw, in, out)`` places its tap k at output 2i + 2 - k, where
    ``F.conv_transpose2d`` places tap k at 2i + k, so it is flipped in both
    spatial axes on its way to ``(in, out, kh, kw)``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {}
    n_blocks = sum(1 for k in params if k.startswith("DoubleConv_"))
    for k in range(n_blocks):
        block = params[f"DoubleConv_{k}"]
        for i in range(2):
            conv = block[f"Conv_{i}"]
            state[f"blocks.{k}.conv{i}.weight"] = t(
                np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
            state[f"blocks.{k}.conv{i}.bias"] = t(conv["bias"])
            if f"BatchNorm_{i}" in block:
                bn = block[f"BatchNorm_{i}"]
                bs = stats[f"DoubleConv_{k}"][f"BatchNorm_{i}"]
                pre = f"blocks.{k}.bn{i}."
                state[pre + "weight"] = t(bn["scale"])
                state[pre + "bias"] = t(bn["bias"])
                state[pre + "running_mean"] = t(bs["mean"])
                state[pre + "running_var"] = t(bs["var"])
                state[pre + "num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.int64)
            elif f"Shift_{i}" in block:
                state[f"blocks.{k}.shift{i}"] = t(block[f"Shift_{i}"])
    for j in range((n_blocks - 1) // 2):
        up = params[f"ConvTranspose_{j}"]
        kernel = np.asarray(up["kernel"])[::-1, ::-1]
        state[f"ups.{j}.weight"] = t(np.transpose(kernel, (2, 3, 0, 1)))
        state[f"ups.{j}.bias"] = t(up["bias"])
    head = params["Conv_0"]
    state["head.weight"] = t(np.transpose(np.asarray(head["kernel"]),
                                          (3, 2, 0, 1)))
    state["head.bias"] = t(head["bias"])
    return state
