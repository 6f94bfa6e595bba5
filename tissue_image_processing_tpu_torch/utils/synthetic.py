"""Synthetic movies and masks for tests and the on-card smoke run.

``make_movie`` is the recipe of the repository's frames/s benchmark
(``bench.py:make_movie``): membrane ridges between drifting Voronoi seeds
(~40 px cells), lit at a smooth z-surface, with Gaussian noise, made from a
numpy seed. A Z == 1 movie is a pre-projected one. ``coil_mask`` is the hard
case of a connected-component search: one thin component that winds through
the whole image.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["make_movie", "coil_mask"]


def make_movie(T: int, Z: int, H: int, W: int, n_cells: Optional[int] = None,
               seed: int = 0) -> np.ndarray:
    """(T, 2, Z, H, W) float32 movie in the uint16 range: channel 0 the
    membrane ridges, channel 1 their complement."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    n_cells = n_cells or max((H * W) // 1800, 16)
    pts = np.stack([rng.uniform(0, H, n_cells), rng.uniform(0, W, n_cells)], 1)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (Z / 2 + (Z / 4) * np.sin(yy / 301.0) * np.cos(xx / 407.0)
             ).astype(np.float32)
    zz = np.arange(Z, dtype=np.float32).reshape(Z, 1, 1)
    zprofile = np.exp(-((zz - depth) ** 2) / 2.0)
    frames = np.empty((T, 2, Z, H, W), np.float32)
    for t in range(T):
        p = pts + t * np.array([1.5, -1.0]) + rng.normal(0, 0.2, pts.shape)
        d, _ = cKDTree(p).query(np.stack([yy.ravel(), xx.ravel()], 1), k=2)
        ridge = np.exp(-((d[:, 1] - d[:, 0]) ** 2) / 8.0).reshape(H, W
                                                                  ).astype(np.float32)
        frames[t, 0] = ridge[None] * zprofile * 50000 + rng.normal(0, 200, (Z, H, W))
        frames[t, 1] = (1 - ridge)[None] * zprofile * 20000 + rng.normal(
            0, 200, (Z, H, W))
    return np.clip(frames, 0, 65535)


def coil_mask(H: int, W: int, pitch: int) -> np.ndarray:
    """(H, W) bool: a one-pixel square spiral from the top-left corner to the
    centre, neighbouring turns ``pitch`` (>= 2) pixels apart — a single
    4-connected component about H * W / pitch pixels long."""
    m = np.zeros((H, W), bool)
    r0, c0, r1, c1, start = 0, 0, H - 1, W - 1, 0
    while r0 <= r1 and start <= c1:
        m[r0, start:c1 + 1] = True
        m[r0:r1 + 1, c1] = True
        if r1 - r0 < pitch or c1 - c0 < pitch:
            break
        m[r1, c0:c1 + 1] = True
        m[r0 + pitch:r1 + 1, c0] = True
        start, r0, c0, r1, c1 = c0, r0 + pitch, c0 + pitch, r1 - pitch, c1 - pitch
    return m
