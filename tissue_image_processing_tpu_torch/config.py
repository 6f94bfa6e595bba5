"""Unified configuration for the pipeline.

The reference scatters configuration over CLI flags, GUI widget state and hard-coded
constants (reference ``gui.py:31,38``, ``tissue_info.py:78``, ``surface_projection.py:28``
— pixel size 0.1 um, airyscan offset 10000, frame interval 15 min). Here every physical
constant and pipeline knob is an explicit field of one dataclass that can be overridden
from the CLI or from Python.

Copied from ``tissue_image_processing_tpu/config.py``: host code, the same
functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    """Surface-projection parameters (reference ``surface_projection.py:17-85``)."""

    reference_channel: int = 0
    method: str = "max_averages"  # max_averages | max_std | multi_channel
    bin_size: int = 1
    min_z: int = 0
    max_z: int = 0  # 0 => use all planes
    airyscan: bool = False
    airyscan_offset: float = 10000.0  # subtracted before clamping at 0
    atoh_shift: int = 0
    build_manifold: bool = False
    # Gaussian stds used by the reference scoring pipeline.
    pre_blur_std: Tuple[float, float, float] = (0.5, 1.0, 1.0)
    score_blur_std: Tuple[float, float, float] = (0.5, 30.0, 30.0)
    mask_blur_std: Tuple[float, float, float] = (1.0, 2.0, 2.0)
    clip_percentile: float = 95.0


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Watershed segmentation parameters (reference
    ``basic_image_manipulations.py:446-476``, GUI defaults ``gui.py:1352-1355``)."""

    threshold: float = 0.2          # fraction of local max
    block_size: int = 101           # local-threshold window (odd)
    std: float = 3.0                # Gaussian std before flooding
    connectivity: int = 1           # 4-connectivity, like skimage watershed default


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """U-Net inference/training parameters (reference
    ``Segmentation/prediction_local.py:60-72``, ``train.py:167-195``)."""

    depth: int = 3                  # number of down blocks (inference net)
    base_filters: int = 128
    num_classes: int = 2
    in_channels: int = 2
    dropout_rate: float = 0.3
    hc_threshold: float = 0.1       # channel-0 probability -> HC mask
    closing_kernel: int = 5
    erosion_kernel: int = 7
    learning_rate: float = 1e-5
    batch_size: int = 32
    crop_size: int = 256
    max_boundary_fraction: float = 0.3
    dtype: str = "bfloat16"         # compute dtype on the card


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking parameters (reference ``tissue_info.py:1924-1926,1935-1938``)."""

    search_range: float = 100.0
    memory: int = 3
    area_weight: float = 0.5        # weight of (sqrt(a1)-sqrt(a2))^2 in the metric
    max_cells: int = 4096           # fixed capacity per frame (padded)
    drift_upsample: int = 100       # phase-correlation sub-pixel factor


@dataclasses.dataclass(frozen=True)
class CellTableConfig:
    """Cell-table capacities and validity rules (reference ``tissue_info.py:218,880-909``)."""

    max_cells: int = 4096
    max_neighbors: int = 64
    max_cell_area: float = 10.0     # x mean area
    min_cell_area: float = 0.1      # x mean area


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration."""

    pixel_length_um: float = 0.1        # reference tissue_info.py:78
    frame_interval_min: float = 15.0    # reference tissue_info.py:923
    projection: ProjectionConfig = dataclasses.field(default_factory=ProjectionConfig)
    segmentation: SegmentationConfig = dataclasses.field(default_factory=SegmentationConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    cells: CellTableConfig = dataclasses.field(default_factory=CellTableConfig)

    def replace(self, **kwargs) -> "PipelineConfig":
        return dataclasses.replace(self, **kwargs)

    # -- (de)serialization: one JSON file holds every knob ---------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        import json

        with open(path, "w") as fp:
            json.dump(self.to_dict(), fp, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        sub = {"projection": ProjectionConfig, "segmentation": SegmentationConfig,
               "unet": UNetConfig, "tracking": TrackingConfig,
               "cells": CellTableConfig}
        kwargs = {}
        for k, v in d.items():
            if k in sub and isinstance(v, dict):
                v = {kk: tuple(vv) if isinstance(vv, list) else vv
                     for kk, vv in v.items()}
                kwargs[k] = sub[k](**v)
            else:
                kwargs[k] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str) -> "PipelineConfig":
        import json

        with open(path) as fp:
            return cls.from_dict(json.load(fp))
