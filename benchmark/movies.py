"""The benchmark's movie generator: one general recipe that every traffic
file parameterises.

A movie is the repository's synthetic tissue (``utils/synthetic.py:
make_movie`` of the port, here rewritten in PyTorch so that it runs on the
card): membrane ridges between drifting Voronoi seeds, lit at a smooth
z-surface, with Gaussian noise, clipped to the uint16 range. Everything is
drawn from one ``torch.Generator`` on the device that makes the movie, so a
seed gives the same movie on a given device. The ridge needs each pixel's
two nearest seeds; they are found tile by tile among the seeds within
``_MARGIN`` pixels of the tile, which holds the second-nearest seed of every
pixel unless fewer than two of ~2,200 uniform seeds lie within 128 px of it
(about 1e-11 a pixel at ~1,800 px a cell).

The movie goes to the host as a (T, C, Z, Y, X) uint16 numpy array, as a
movie read from a file would arrive.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["make_movie", "two_nearest"]

_TILE = 64
_MARGIN = 128
_TILES_A_CHUNK = 128


def two_nearest(points: torch.Tensor, height: int, width: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Distances from every pixel centre (y, x) of a height x width grid to
    its nearest and second-nearest point of ``points`` ((n, 2) float32, y
    then x): two (height, width) float32 maps."""
    dev = points.device
    ny, nx = -(-height // _TILE), -(-width // _TILE)
    y0 = (torch.arange(ny, device=dev) * _TILE).repeat_interleave(nx)
    x0 = (torch.arange(nx, device=dev) * _TILE).repeat(ny)
    py, px = points[:, 0], points[:, 1]
    member = ((py[None] >= y0[:, None] - _MARGIN)
              & (py[None] < y0[:, None] + _TILE + _MARGIN)
              & (px[None] >= x0[:, None] - _MARGIN)
              & (px[None] < x0[:, None] + _TILE + _MARGIN))
    k = max(2, int(member.sum(1).max()))
    order = torch.argsort((~member).to(torch.int8), dim=1, stable=True)[:, :k]
    inside = member.gather(1, order)
    inf = torch.tensor(float("inf"), device=dev)
    cy = torch.where(inside, py[order], inf)
    cx = torch.where(inside, px[order], inf)
    off = torch.arange(_TILE, device=dev, dtype=torch.float32)
    oy = off.repeat_interleave(_TILE)
    ox = off.repeat(_TILE)
    near = torch.empty((ny * nx, _TILE * _TILE, 2), dtype=torch.float32,
                       device=dev)
    for s in range(0, ny * nx, _TILES_A_CHUNK):
        e = min(s + _TILES_A_CHUNK, ny * nx)
        gy = y0[s:e, None].to(torch.float32) + oy[None]
        gx = x0[s:e, None].to(torch.float32) + ox[None]
        dy = gy[:, :, None] - cy[s:e, None, :]
        dx = gx[:, :, None] - cx[s:e, None, :]
        d2 = dy * dy + dx * dx
        near[s:e] = torch.topk(d2, 2, dim=2, largest=False).values
    near = near.sqrt().reshape(ny, nx, _TILE, _TILE, 2).permute(0, 2, 1, 3, 4)
    near = near.reshape(ny * _TILE, nx * _TILE, 2)[:height, :width]
    return near[..., 0].contiguous(), near[..., 1].contiguous()


def make_movie(traffic: Mapping, frames: int, seed: int,
               device: torch.device) -> np.ndarray:
    """A (frames, C, Z, Y, X) uint16 host movie of the traffic file's
    recipe, drawn from ``seed`` on ``device``."""
    if traffic["generator"] != "voronoi_membranes":
        raise ValueError(f"no generator {traffic['generator']!r}")
    C, Z = int(traffic["channels"]), int(traffic["z"])
    H, W = int(traffic["height"]), int(traffic["width"])
    if C != 2:
        raise ValueError("the membrane recipe makes two channels")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = max(H * W // int(traffic["cell_area_px"]), 16)
    scale = torch.tensor([float(H), float(W)], device=device)
    pts = torch.rand((n, 2), generator=g, device=device) * scale
    py_, px_ = (float(v) for v in traffic["surface_periods_px"])
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    depth = Z / 2 + (Z / 4) * torch.sin(yy / py_) * torch.cos(xx / px_)
    zz = torch.arange(Z, device=device, dtype=torch.float32)[:, None, None]
    zprofile = torch.exp(-((zz - depth[None]) ** 2) / 2.0)
    step = torch.tensor([float(v) for v in traffic["drift_px_per_frame"]],
                        device=device)
    jitter = float(traffic["jitter_px"])
    noise = float(traffic["noise_sd"])
    peaks = [float(v) for v in traffic["channel_peaks"]]
    width2 = float(traffic["ridge_width2"])
    out = np.empty((frames, C, Z, H, W), np.uint16)
    for t in range(frames):
        p = pts + t * step + jitter * torch.randn((n, 2), generator=g,
                                                  device=device)
        d1, d2 = two_nearest(p, H, W)
        ridge = torch.exp(-((d2 - d1) ** 2) / width2)
        for c, lit in enumerate((ridge, 1.0 - ridge)):
            v = lit[None] * zprofile * peaks[c] + noise * torch.randn(
                (Z, H, W), generator=g, device=device)
            # truncation toward zero, as numpy's astype(uint16) of the clip
            v = v.clamp_(0.0, 65535.0).to(torch.int32).to(torch.int16)
            torch.from_numpy(out[t, c].view(np.int16)).copy_(v)
    return out

