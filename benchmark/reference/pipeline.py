"""The movie chain, plain: projection, segmentation, cell tables, drift,
adaptive radii and tracking, in the order and with the arguments of the
port's ``core/pipeline.py:movie_pipeline``, on the frozen plain modules
beside this file. It runs on any device, one frame (or one group of frames)
at a time, and keeps nothing but its outputs.

``lower`` rounds each float32 stage output (the projections and the
U-Net's input) through bfloat16: the chain computed a step of precision
below the configuration's float32, the control that the comparison must
fail.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from benchmark.reference.cell_table import frame_cellinfo_checked, stack_tables
from benchmark.reference.predictor import prepare_batch, unet_postprocess_batch
from benchmark.reference.projection import time_point_surface_projection
from benchmark.reference.tracking import (
    adaptive_effective_ranges, compute_drift_chain, track_movie)
from benchmark.reference.unet import UNet
from benchmark.reference.watershed import watershed_segmentation_batch

__all__ = ["reference_movie", "reference_unet", "projections"]


def _lower(x: torch.Tensor, lower: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if lower else x


def _flood_batch(T: int, batch: int) -> int:
    b = max(1, min(batch, T))
    while T % b:
        b -= 1
    return b


def projections(movie: np.ndarray, reference_channel: int,
                device: torch.device, keep=None,
                lower: bool = False) -> torch.Tensor:
    """(T, C', Y, X) float32 projections of the kept channels of a host
    (T, C, Z, Y, X) movie (Z == 1: the single plane)."""
    if movie.shape[2] == 1:
        planes = movie[:, :, 0] if keep is None else movie[:, list(keep), 0]
        return _lower(torch.from_numpy(np.ascontiguousarray(planes)).to(
            device=device, dtype=torch.float32), lower)
    out = []
    for t in range(movie.shape[0]):
        stack = torch.from_numpy(np.ascontiguousarray(movie[t])).to(device)
        proj, _ = time_point_surface_projection(
            stack, reference_channel=reference_channel, airyscan=False)
        out.append(proj if keep is None else proj[list(keep)])
        del stack
    return _lower(torch.stack(out), lower)


def reference_unet(state: Mapping, unet: Mapping, device: torch.device
                   ) -> UNet:
    """The U-Net of ``unet`` (depth, base_filters, in_channels) in float32
    with its BatchNorm as given (not folded), from the benchmark's weights
    ``state``."""
    with torch.device(device):
        model = UNet(depth=unet["depth"], base_filters=unet["base_filters"],
                     dtype=torch.float32, norm="bn",
                     in_channels=unet["in_channels"])
    model.load_state_dict(state)
    return model.eval().requires_grad_(False)


def _unet_probs(prj: torch.Tensor, model: UNet, lower: bool) -> torch.Tensor:
    """(T, X, Y, 2) softmax of (T, C, Y, X) projections in x-major space:
    normalised and forwarded one frame at a time in float32 (TF32 off)."""
    out = []
    for t in range(prj.shape[0]):
        x, (px, py) = prepare_batch(prj[t:t + 1])
        with torch.no_grad():
            out.append(model(_lower(x, lower))[:, px:, py:, :])
    return torch.cat(out)


def reference_movie(movie: np.ndarray, config: Mapping,
                    device: torch.device, state: Optional[Mapping] = None,
                    probs: Optional[torch.Tensor] = None,
                    lower: bool = False) -> dict:
    """The chain of ``movie_pipeline`` on a host movie with the
    configuration's parameters: ``labels`` (T, X, Y), ``tables``,
    ``drifts`` and ``ids``, and for the U-Net its own ``probs`` (T, X, Y,
    2). The U-Net's labels are post-processed from ``probs`` when given (the
    program's softmax, which a float32 forward cannot match bit for bit)
    and from its own otherwise, in the program's groups of frames."""
    ref = int(config["reference_channel"])
    own_probs = None
    if config["segmenter"] == "unet":
        prj = projections(movie, ref, device, lower=lower)
        model = reference_unet(state, config["unet"], device)
        own_probs = _unet_probs(prj, model, lower)
        del model
        source = own_probs if probs is None else probs.to(device)
        T = source.shape[0]
        B = _flood_batch(T, int(config["unet"]["batch"]))
        labels = torch.cat([unet_postprocess_batch(source[i:i + B])[0]
                            for i in range(0, T, B)])
        refs = prj[:, ref]
        flip = True
    else:
        prj = projections(movie, ref, device, keep=[ref], lower=lower)
        refs = prj[:, 0].transpose(1, 2).contiguous()
        B = max(1, min(int(config["batch"]), refs.shape[0]))
        labels = torch.cat([watershed_segmentation_batch(
            refs[i:i + B], config["threshold"], config["std"],
            config["block_size"]) for i in range(0, refs.shape[0], B)])
        flip = False
    del prj
    cap = int(config["capacity"])
    tabs = stack_tables([frame_cellinfo_checked(f, capacity=cap,
                                                neighbor_compact_k=192)[0]
                         for f in labels])
    dr = compute_drift_chain(refs)
    if flip:
        dr = dr.flip(1)
    drifts = dr.cpu().numpy()
    host = tabs.map(lambda x: x.cpu())
    mask = host.valid_mask().numpy()
    ranges = adaptive_effective_ranges(
        host.cy.numpy(), host.cx.numpy(), host.area.numpy(), mask,
        drifts=drifts, search_range=config["search_range"], per_cell=True)
    ids = track_movie(tabs.cy, tabs.cx, tabs.area, tabs.valid_mask(),
                      drifts=torch.as_tensor(drifts, dtype=torch.float32,
                                             device=device),
                      search_range=config["search_range"],
                      memory=config["memory"], capacity=2 * cap,
                      search_ranges=torch.as_tensor(
                          ranges, dtype=torch.float32, device=device))
    out = {"labels": labels, "tables": tabs, "drifts": drifts,
           "ids": ids.cpu().numpy()}
    if own_probs is not None:
        out["probs"] = own_probs
    return out
