"""Synthetic movies for tests and the on-card smoke run.

``make_movie`` is the recipe of the repository's frames/s benchmark
(``bench.py:make_movie``): membrane ridges between drifting Voronoi seeds
(~40 px cells), lit at a smooth z-surface, with Gaussian noise, made from a
numpy seed. A Z == 1 movie is a pre-projected one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["make_movie"]


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
