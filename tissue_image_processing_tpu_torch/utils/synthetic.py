"""Synthetic movies and masks for tests and the on-card smoke run.

``make_movie`` is the recipe of the repository's frames/s benchmark
(``bench.py:make_movie``): membrane ridges between drifting Voronoi seeds
(~40 px cells), lit at a smooth z-surface, with Gaussian noise, made from a
numpy seed. A Z == 1 movie is a pre-projected one. ``coil_mask`` is the hard
case of a connected-component search: one thin component that winds through
the whole image. ``settle_cases`` are the inputs on which a tiled schedule of
the Meyer settle is most likely to go wrong.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["make_movie", "coil_mask", "settle_cases", "random_settle_case"]


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


def random_settle_case(h: int, w: int, seed: int = 0):
    """(lam, seeds) of shape (h, w): smoothed noise quantised to eight levels
    (plateaus and ties everywhere), +inf patches (voids, some on the border)
    and about one pixel in eighty a seed with a label of its own."""
    from scipy import ndimage as ndi

    rng = np.random.default_rng(seed)
    field = ndi.gaussian_filter(rng.random((h, w)), 2.0, mode="nearest")
    lo, hi = float(field.min()), float(field.max())
    lam = (np.floor(8 * (field - lo) / max(hi - lo, 1e-9)) / 8).astype(np.float32)
    for _ in range(3):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        lam[y:y + max(h // 6, 1), x:x + max(w // 5, 1)] = np.inf
    lam[0, : w // 3] = np.inf
    pick = rng.random((h, w)) < 1 / 80
    pick[h // 2, w // 2] = True
    seeds = np.where(pick, np.cumsum(pick).reshape(h, w), 0).astype(np.int32)
    lam[pick] = np.minimum(lam[pick], 0.5)
    return lam, seeds


def settle_cases(tile: int, ragged=()):
    """Name -> (lam float32, seeds int32): hard inputs for a settle that works
    on ``tile`` x ``tile`` tiles. One corner seed on a flat image (a single
    plateau over every tile), a one-pixel serpentine corridor between walls,
    the same between +inf walls, seeds on tile borders and corners, two
    basins whose line runs along a tile seam, four whose lines cross in a
    tile corner, negative seeds, an image smaller than a tile, and a random
    case (``random_settle_case``) at every shape of ``ragged``."""
    T = tile
    cases = {}

    flat = np.full((3 * T + T // 2, 4 * T + 3), 0.25, np.float32)
    seeds = np.zeros(flat.shape, np.int32)
    seeds[-1, -1] = 1
    cases["plateau_corner_seed"] = (flat, seeds)

    h, w = 2 * T + T // 2, 2 * T + T // 4
    for name, wall in (("serpentine", 1.0), ("serpentine_inf_walls", np.inf)):
        lam = np.full((h, w), wall, np.float32)
        lam[::2] = 0.0
        lam[1::4, -1] = 0.0
        lam[3::4, 0] = 0.0
        seeds = np.zeros((h, w), np.int32)
        seeds[0, 0] = 7
        cases[name] = (lam, seeds)

    yy, xx = np.mgrid[0:3 * T, 0:3 * T]
    lam = (0.1 * ((yy // 3 + xx // 5) % 4)).astype(np.float32)
    seeds = np.zeros(lam.shape, np.int32)
    spots = [(0, 0), (T - 1, T - 1), (T - 1, T), (T, T - 1), (T, T),
             (2 * T - 1, T), (2 * T, 2 * T - 1), (T, 0), (0, 2 * T),
             (3 * T - 1, 3 * T - 1), (T + T // 2, 2 * T)]
    for k, (y, x) in enumerate(spots):
        seeds[y, x] = k + 1
        lam[y, x] = 0.0
    cases["seeds_on_tile_borders"] = (lam, seeds)

    flat = np.full((3 * T, 2 * T), 0.5, np.float32)
    seeds = np.zeros(flat.shape, np.int32)
    seeds[:, T - 4] = 1
    seeds[:, T + 4] = 2
    cases["line_along_seam"] = (flat, seeds)

    flat = np.full((2 * T, 2 * T), 0.5, np.float32)
    seeds = np.zeros(flat.shape, np.int32)
    for k, (y, x) in enumerate(((T - 4, T - 4), (T - 4, T + 4),
                                (T + 4, T - 4), (T + 4, T + 4))):
        seeds[y, x] = k + 1
    cases["lines_cross_in_corner"] = (flat, seeds)

    lam, seeds = random_settle_case(2 * T + 3, 2 * T + 5, seed=3)
    seeds[seeds % 3 == 1] *= -1  # settled from the start, never a donor
    cases["negative_seeds"] = (lam, seeds)

    cases["below_one_tile"] = random_settle_case(max(T // 2 - 1, 2),
                                                 max(T // 2 + 1, 2), seed=4)
    for k, (h, w) in enumerate(ragged):
        cases[f"ragged_{h}x{w}"] = random_settle_case(h, w, seed=10 + k)
    return cases
