"""Synthetic movies and masks for tests and the on-card smoke run.

``make_movie`` is the recipe of the repository's frames/s benchmark
(``bench.py:make_movie``): membrane ridges between drifting Voronoi seeds
(~40 px cells), lit at a smooth z-surface, with Gaussian noise, made from a
numpy seed. A Z == 1 movie is a pre-projected one. ``coil_mask`` is the hard
case of a connected-component search: one thin component that winds through
the whole image. ``settle_cases`` are the inputs on which a tiled schedule of
the Meyer settle is most likely to go wrong. ``keras_unet_arrays`` and
``write_keras_h5`` make a Keras U-Net weights file from a seed (no trained
checkpoint ships with the repository); ``training_frames`` makes annotated
(image, label) frames for the training loop. ``random_unet`` and
``head_bias_for_share`` make the on-card smoke run's random U-Net, whose
head bias puts a chosen share of a frame's pixels past the HC threshold.
``voronoi_labels`` and ``make_tracked_tissue`` build tracked ``Tissue``
sessions at a chosen cell density with planted events (a seed removed = a
delamination, a seed inserted inside a mother cell = a division, a type bit
set = a differentiation), so event detection is scored against known truth.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["make_movie", "coil_mask", "settle_cases", "random_settle_case",
           "keras_unet_arrays", "write_keras_h5", "training_frames",
           "random_unet", "head_bias_for_share", "voronoi_labels",
           "make_tracked_tissue"]


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


def keras_unet_arrays(depth: int, base_filters: int, in_channels: int = 2,
                      seed: int = 0) -> dict:
    """Seeded random weights of the reference U-Net in Keras' shapes, by
    layer name in Keras' creation order: ``conv2d*`` (h, w, in, out; the
    double convs down, bottleneck, up, then the 1x1 head; he-normal scale),
    ``conv2d_transpose*`` (h, w, out, in), ``batch_normalization*`` (gamma,
    beta, moving mean, moving variance)."""
    rng = np.random.default_rng(seed)
    filters = [base_filters * 2 ** i for i in range(depth)]
    blocks, cin = [], in_channels
    for f in filters:
        blocks.append((cin, f))
        cin = f
    blocks.append((cin, 2 * cin))
    ups = [(2 * f, f) for f in reversed(filters)]
    blocks += [(2 * f, f) for f in reversed(filters)]
    convs, bns = [], []
    for cin, cout in blocks:
        convs += [(cin, cout), (cout, cout)]
        bns += [cout, cout]
    convs.append((filters[0], 2))

    def name(base, i):
        return base if i == 0 else f"{base}_{i}"

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    layers = {}
    for i, (cin, cout) in enumerate(convs):
        k = 1 if i == len(convs) - 1 else 3
        layers[name("conv2d", i)] = {
            "kernel": normal((k, k, cin, cout), (2.0 / (k * k * cin)) ** 0.5),
            "bias": normal((cout,), 0.1)}
    for i, (cin, cout) in enumerate(ups):
        layers[name("conv2d_transpose", i)] = {
            "kernel": normal((3, 3, cout, cin), (1.0 / (9 * cin)) ** 0.5),
            "bias": normal((cout,), 0.1)}
    for i, c in enumerate(bns):
        layers[name("batch_normalization", i)] = {
            "gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "beta": normal((c,), 1.0), "moving_mean": normal((c,), 1.0),
            "moving_variance": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return layers


def write_keras_h5(path: str, layers: dict, layout: str) -> None:
    """Write ``layers`` (name -> {weight name -> array}) as a Keras weights
    file: ``layout="keras2"`` names ``model_weights/<layer>/<layer>/<name>:0``,
    ``"keras3"`` ``layers/<layer>/vars/<index>`` beside a top-level
    ``vars``."""
    import h5py

    order = {"conv": ("kernel", "bias"),
             "bn": ("gamma", "beta", "moving_mean", "moving_variance")}
    with h5py.File(path, "w") as f:
        if layout == "keras2":
            root = f.create_group("model_weights")
            for lname, arrays in layers.items():
                g = root.create_group(lname).create_group(lname)
                for k, v in arrays.items():
                    g.create_dataset(f"{k}:0", data=v)
        elif layout == "keras3":
            f.create_group("vars")
            root = f.create_group("layers")
            for lname, arrays in layers.items():
                names = order["bn" if lname.startswith("batch") else "conv"]
                g = root.create_group(lname).create_group("vars")
                for i, k in enumerate(names):
                    g.create_dataset(str(i), data=arrays[k])
        else:
            raise ValueError(f"layout must be keras2 or keras3, got {layout!r}")


def training_frames(n: int, H: int, W: int, seed: int = 0):
    """``n`` annotated frames for ``models/train.py``: (2, H, W) float32
    images of ``make_movie`` (membrane ridges, their complement) and (H, W)
    int32 labels with 0 on the membranes (~10% of the pixels), 1 (HC) or 2
    (SC) in the cells, HC where the cell's seed row is even."""
    from scipy.spatial import cKDTree

    movie = make_movie(T=n, Z=1, H=H, W=W, seed=seed)[:, :, 0]
    rng = np.random.default_rng(seed + 1)
    pts = np.stack([rng.uniform(0, H, 64), rng.uniform(0, W, 64)], 1)
    yy, xx = np.mgrid[0:H, 0:W]
    _, owner = cKDTree(pts).query(np.stack([yy.ravel(), xx.ravel()], 1))
    cell_type = np.where(np.arange(64) % 2 == 0, 1, 2)
    labels = []
    for t in range(n):
        ridge = movie[t, 0]
        lab = cell_type[owner].reshape(H, W).astype(np.int32)
        lab[ridge > np.quantile(ridge, 0.9)] = 0
        labels.append(lab)
    return [movie[t] for t in range(n)], labels


def random_unet(depth: int, base_filters: int, seed: int = 0, dtype=None):
    """``models/unet.py:build_unet`` weights (he / lecun-normal convs) from a
    CPU generator seeded with ``seed``, with every BatchNorm's scale, bias
    and running statistics then drawn from the same generator away from the
    identity (scales in [0.5, 1.5], so the fold to shifts succeeds). The
    weights do not depend on the input's size."""
    import torch

    from tissue_image_processing_tpu_torch.models.unet import build_unet

    gen = torch.Generator().manual_seed(seed)
    model = build_unet((8, 8, 2), depth=depth, base_filters=base_filters,
                       dtype=dtype or torch.float32, generator=gen)
    ranges = {"weight": (0.5, 1.5), "bias": (-0.2, 0.2),
              "running_mean": (0.0, 0.5), "running_var": (0.5, 1.5)}
    with torch.no_grad():
        for name, buf in model.state_dict().items():
            leaf = name.rsplit(".", 1)[1]
            if ".bn" in name and leaf in ranges:
                lo, hi = ranges[leaf]
                buf.copy_(lo + (hi - lo) * torch.rand(buf.shape, generator=gen))
    return model


def head_bias_for_share(probs, share: float, threshold: float = 0.1) -> float:
    """What to add to the head's channel-0 bias so that ``share`` of the
    pixels of the softmax ``probs`` (..., 2) pass p0 > ``threshold``: the
    log-odds cut minus the (1 - share) quantile of log p0 - log p1."""
    import torch

    p = probs.float().clamp_min(1e-30)
    gap = (torch.log(p[..., 0]) - torch.log(p[..., 1])).reshape(-1)
    kth = max(1, int(round((1.0 - share) * gap.numel())))
    cut = float(np.log(threshold / (1.0 - threshold)))
    return float(cut - torch.kthvalue(gap.cpu(), kth).values)


def voronoi_labels(size: int, pts: np.ndarray) -> np.ndarray:
    """(size, size) int32 label map: pixel -> nearest seed index + 1, with
    0-valued 1-px watershed-style lines where 4-neighbour regions meet."""
    from scipy.spatial import cKDTree

    yy, xx = np.mgrid[0:size, 0:size]
    _, idx = cKDTree(pts).query(np.stack([yy.ravel(), xx.ravel()], 1), k=1)
    lab = (idx + 1).astype(np.int32).reshape(size, size)
    lines = np.zeros_like(lab, dtype=bool)
    lines[1:] |= lab[1:] != lab[:-1]
    lines[:, 1:] |= lab[:, 1:] != lab[:, :-1]
    return np.where(lines, 0, lab)


def make_tracked_tissue(
    n_frames: int = 6,
    size: int = 1024,
    n_cells: int = 2000,
    seed: int = 0,
    delaminate: Sequence[Tuple[int, int]] = (),
    divide: Sequence[Tuple[int, int]] = (),
    differentiate: Sequence[Tuple[int, int]] = (),
    capacity: Optional[int] = None,
    jitter: float = 0.3,
    device=None,
):
    """A fully tracked :class:`~..core.tissue.Tissue` on ``device`` (None:
    the card) at the given cell density with planted events.

    ``delaminate`` / ``divide`` / ``differentiate``: lists of
    ``(seed_index, frame_from)`` — the 1-based frame at which the seed
    disappears / a daughter seed appears just beside it / its type-0 bit
    turns on. Seed ``i`` tracks as id ``i + 1``; daughters get fresh ids
    ``n_cells + 1, ...`` in ``divide`` order. Returns ``(tissue, info)``,
    ``info`` mapping event kinds to the planted ``(cell_id, frame)`` lists.
    """
    from tissue_image_processing_tpu_torch.core.cell_table import (
        replace_fields, to_numpy)
    from tissue_image_processing_tpu_torch.core.tissue import Tissue

    rng = np.random.default_rng(seed)
    # jittered grid seeds: near-uniform density like an epithelium
    g = int(np.ceil(np.sqrt(n_cells)))
    step = size / g
    base = np.stack(np.meshgrid(np.arange(g), np.arange(g)), -1).reshape(-1, 2)
    pts0 = (base + 0.5) * step + rng.normal(0, jitter * step, (g * g, 2))
    pts0 = np.clip(pts0[:n_cells], 1, size - 2)

    cap = capacity or int(2 ** np.ceil(np.log2(n_cells + len(divide) + 8)))
    tissue = Tissue(n_frames, "synthetic", capacity=cap,
                    min_cell_area=0.01, max_cell_area=100.0, device=device)
    daughters = {}  # divide order -> (daughter_pos, frame_from, mother_idx)
    for j, (mi, ff) in enumerate(divide):
        off = rng.normal(0, 0.15 * step, 2)
        daughters[j] = (np.clip(pts0[mi] + off, 1, size - 2), ff, mi)

    info = {"delamination": [(mi + 1, ff) for mi, ff in delaminate],
            "division": [(n_cells + 1 + j, ff)
                         for j, (_, ff, _) in daughters.items()],
            "differentiation": [(mi + 1, ff) for mi, ff in differentiate]}

    for f in range(1, n_frames + 1):
        keep = np.ones(n_cells, bool)
        for mi, ff in delaminate:
            if f >= ff:
                keep[mi] = False
        pts = [pts0[keep]]
        ids = [np.nonzero(keep)[0] + 1]
        for j, (dpos, ff, _mi) in daughters.items():
            if f >= ff:
                pts.append(dpos[None])
                ids.append(np.array([n_cells + 1 + j]))
        pts = np.concatenate(pts, 0)
        ids = np.concatenate(ids, 0).astype(np.int32)
        labels = voronoi_labels(size, pts)
        tissue.set_labels(f, labels, reset_data=True)
        tissue.calculate_frame_cellinfo(f)
        table = tissue.get_cells_info(f)
        mask = to_numpy(table.valid_mask())
        ids_row = np.zeros(cap, np.int32)
        ids_row[:ids.size] = ids
        types = np.zeros(cap, np.uint8)
        for mi, ff in differentiate:
            if f >= ff:
                row = np.nonzero(ids == mi + 1)[0]
                if row.size:
                    types[row[0]] = 1
        table = replace_fields(table, type=types)
        tissue.apply_track_ids(f, table, ids_row, mask)
    return tissue, info
