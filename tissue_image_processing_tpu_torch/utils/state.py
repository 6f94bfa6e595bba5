"""Carried state and weights from numpy leaves.

The pipeline carries the chunked tracker's ``TrackingState`` and the
per-frame ``CellTable``s; ``tracking_state_from_numpy`` and
``cell_table_from_numpy`` build the port's dataclasses from numpy arrays
keyed by field name — for example the leaves of the JAX package's dataclasses
of the same names — so a run can resume from a carry produced elsewhere.
``tissue_from_numpy`` builds a ``Tissue`` session from the plain contents of
another one (per-frame label maps, type maps and table leaves, drifts, valid
frames, events and names). ``unet_state_from_flax`` carries the U-Net's
weights across: the Flax
variable tree of the JAX package's ``UNet`` as numpy arrays in, the
``state_dict`` of the port's ``UNet`` out (either up-sampling form: the
transposed convs or the subpixel ``packed`` convs), and
``quant_params_from_jax`` the int8 parameters of ``models/quant.py``.
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
           "tissue_from_numpy", "unet_state_from_flax", "quant_params_from_jax"]

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


def tissue_from_numpy(arrays: Mapping, meta: Mapping, device=None):
    """A ``Tissue`` on ``device`` (None: the card) from plain contents.

    ``arrays``: ``labels`` and ``cell_types`` (lists of per-frame numpy maps
    or None), ``tables`` (a list of per-frame dicts of numpy arrays named
    like the ``CellTable`` fields, or None), ``drifts`` (T, 2) and
    ``valid_frames`` (T,). ``meta``: ``number_of_frames``, ``data_path``,
    ``capacity``, ``max_neighbors``, ``min_cell_area``, ``max_cell_area``,
    ``type_names``, ``channel_names``, ``fake_channels``, ``events`` (a
    DataFrame of the events schema) and, optionally,
    ``shape_fitting_results``. Everything is copied."""
    import copy

    from tissue_image_processing_tpu_torch.core.tissue import Tissue

    tissue = Tissue(int(meta["number_of_frames"]), meta["data_path"],
                    channel_names=list(meta["channel_names"]),
                    max_cell_area=meta["max_cell_area"],
                    min_cell_area=meta["min_cell_area"],
                    capacity=int(meta["capacity"]),
                    max_neighbors=int(meta["max_neighbors"]), device=device)
    tissue.type_names = list(meta["type_names"])
    tissue.fake_channels = list(meta["fake_channels"])
    tissue.events = meta["events"].copy()
    if "shape_fitting_results" in meta:
        tissue.shape_fitting_results = copy.deepcopy(
            list(meta["shape_fitting_results"]))
    tissue.drifts = np.array(arrays["drifts"], np.float64)
    tissue.valid_frames = np.array(arrays["valid_frames"])
    for f in range(1, tissue.number_of_frames + 1):
        labels = arrays["labels"][f - 1]
        if labels is not None:
            tissue.set_labels(f, np.array(labels))
        types = arrays["cell_types"][f - 1]
        if types is not None:
            tissue.set_cell_types(f, np.array(types))
        leaves = arrays["tables"][f - 1]
        if leaves is not None:
            tissue.set_cells_info(f, cell_table_from_numpy(leaves, tissue.device))
    return tissue


def unet_state_from_flax(variables: Mapping) -> dict:
    """``state_dict`` of the port's ``UNet`` from the Flax variable tree of
    the JAX package's ``UNet`` (numpy leaves; ``up_kind`` "convt" or, with
    ``_SubpixelUp_j/packed``, "subpixel"), in either form: ``norm="bn"``
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
            state[f"blocks.{k}.conv{i}.weight"] = t(_oihw(conv["kernel"]))
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
        if f"_SubpixelUp_{j}" in params:   # UNet(up_kind="subpixel")
            packed = params[f"_SubpixelUp_{j}"]["packed"]
            state[f"ups.{j}.packed.weight"] = t(_oihw(packed["kernel"]))
            state[f"ups.{j}.packed.bias"] = t(packed["bias"])
            continue
        up = params[f"ConvTranspose_{j}"]
        state[f"ups.{j}.weight"] = t(_convt_weight(up["kernel"]))
        state[f"ups.{j}.bias"] = t(up["bias"])
    head = params["Conv_0"]
    state["head.weight"] = t(_oihw(head["kernel"]))
    state["head.bias"] = t(head["bias"])
    return state


def _oihw(kernel) -> np.ndarray:
    """A Flax conv kernel (HWIO) as PyTorch's (O, I, H, W)."""
    return np.transpose(np.asarray(kernel), (3, 2, 0, 1))


def _convt_weight(kernel) -> np.ndarray:
    """A Flax transposed-conv kernel (kh, kw, in, out), tap k landing at
    output 2i + 2 - k, as ``F.conv_transpose2d``'s (in, out, kh, kw), tap k
    landing at 2i + k: flipped in both spatial axes."""
    return np.transpose(np.asarray(kernel)[::-1, ::-1], (2, 3, 0, 1))


def quant_params_from_jax(qparams: Mapping) -> dict:
    """The int8 parameters of ``models/quant.py:quantize_unet`` from the JAX
    package's qparams tree (numpy leaves), so both packages can run on
    identical scales: ``in_scale``; for double conv k ``blocks.k.out_scale``
    and, for conv i, ``blocks.k.conv{i}.wq`` (int8, HWIO -> OIHW),
    ``.wscale``, ``.bias``, ``.shift`` and (i = 1) ``.in_scale``; for
    transposed conv j ``ups.j.weight`` (flipped as in
    :func:`unet_state_from_flax`), ``.bias``, ``.out_scale``; ``head.weight``,
    ``head.bias``. Float leaves are float32, scales 0-d."""
    params = qparams["params"]

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {"in_scale": f32(params["in_scale"])}
    n_blocks = sum(1 for k in params if k.startswith("DoubleConv_"))
    for k in range(n_blocks):
        block = params[f"DoubleConv_{k}"]
        out[f"blocks.{k}.out_scale"] = f32(block["out_scale"])
        for i in range(2):
            conv, pre = block[f"Conv_{i}"], f"blocks.{k}.conv{i}."
            out[pre + "wq"] = torch.from_numpy(
                np.ascontiguousarray(_oihw(conv["wq"]), dtype=np.int8))
            for name in ("wscale", "bias", "shift", "in_scale"):
                if name in conv:
                    out[pre + name] = f32(conv[name])
    for j in range((n_blocks - 1) // 2):
        up = params[f"ConvTranspose_{j}"]
        out[f"ups.{j}.weight"] = f32(_convt_weight(up["kernel"]))
        out[f"ups.{j}.bias"] = f32(up["bias"])
        out[f"ups.{j}.out_scale"] = f32(up["out_scale"])
    out["head.weight"] = f32(_oihw(params["Conv_0"]["kernel"]))
    out["head.bias"] = f32(params["Conv_0"]["bias"])
    return out
