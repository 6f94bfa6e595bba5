"""Small versions of the benchmark's cells for the CPU tests: the same
files, with frames, sizes and the network cut so that a run takes seconds."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def spec() -> dict:
    return load("BENCHMARK.json")


def small_cell(name: str, side: int = 128):
    """(spec, config, traffic) of cell ``name`` at ``side`` x ``side``, 4
    frames, at most 4 planes, a depth-2 U-Net of 8 filters."""
    s = spec()
    cell = next(c for c in s["workloads"] if c["name"] == name)
    entry = next(c for c in s["configs"] if c["name"] == cell["config"])
    config = copy.deepcopy(load(entry["file"]))
    traffic = load(f"benchmark/traffic/{cell['traffic']}.json")
    config.update(frames=4, capacity=512, block_size=31)
    if "unet" in config:
        config["unet"].update(depth=2, base_filters=8)
    traffic.update(height=side, width=side, z=min(traffic["z"], 4),
                   cell_area_px=200)
    return s, config, traffic
