"""Pure numpy/scipy reference implementations used as test oracles.

These re-implement the algorithms the reference delegates to skimage (which is not
installed in this environment) from their published definitions: Meyer's flooding
watershed with watershed lines, the weighted-border perimeter estimator, and the
reference's own neighbor-graph construction.
"""

import heapq

import numpy as np
from scipy import ndimage as ndi


def regional_minima(img):
    """Boolean mask of regional minima (8-connected plateaus with no lower neighbor)."""
    img = np.asarray(img, dtype=np.float64)
    H, W = img.shape
    padded = np.pad(img, 1, mode="constant", constant_values=np.inf)
    min8 = np.full_like(img, np.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            min8 = np.minimum(min8, padded[1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    candidate = img <= min8
    # drop escaping plateaus: flood equal-valued non-candidates into candidates
    structure = np.ones((3, 3), bool)
    lbl, n = ndi.label(candidate, structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
    bad = np.zeros(n + 1, bool)
    padc = np.pad(candidate, 1, mode="constant", constant_values=True)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb_val = padded[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            nb_c = padc[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            esc = candidate & (nb_val == img) & (~nb_c)
            bad[np.unique(lbl[esc])] = True
    bad[0] = True
    return candidate & ~bad[lbl]


def meyer_watershed(img, watershed_line=True):
    """Meyer's flooding watershed from regional minima, 4-connectivity, FIFO
    tie-breaking, with watershed lines. Mirrors skimage.segmentation.watershed
    semantics for markers=None."""
    img = np.asarray(img, dtype=np.float64)
    H, W = img.shape
    seeds_mask = regional_minima(img)
    markers, n = ndi.label(seeds_mask, structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
    out = markers.astype(np.int64)
    WSL = -1
    heap = []
    order = 0
    visited = markers > 0
    nbrs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    ys, xs = np.nonzero(markers)
    for y, x in zip(ys, xs):
        for dy, dx in nbrs:
            qy, qx = y + dy, x + dx
            if 0 <= qy < H and 0 <= qx < W and not visited[qy, qx]:
                heapq.heappush(heap, (img[qy, qx], order, qy, qx))
                order += 1
                visited[qy, qx] = True
    while heap:
        _, _, y, x = heapq.heappop(heap)
        lbls = set()
        for dy, dx in nbrs:
            qy, qx = y + dy, x + dx
            if 0 <= qy < H and 0 <= qx < W and out[qy, qx] > 0:
                lbls.add(out[qy, qx])
        if len(lbls) == 1:
            out[y, x] = lbls.pop()
        else:
            out[y, x] = WSL if watershed_line else (min(lbls) if lbls else 0)
        for dy, dx in nbrs:
            qy, qx = y + dy, x + dx
            if 0 <= qy < H and 0 <= qx < W and not visited[qy, qx]:
                heapq.heappush(heap, (img[qy, qx], order, qy, qx))
                order += 1
                visited[qy, qx] = True
    out[out == WSL] = 0
    return out.astype(np.int32)


def perimeter_oracle(mask):
    """skimage.measure.perimeter algorithm (weighted border patterns) via scipy."""
    mask = np.asarray(mask, bool)
    strel = ndi.generate_binary_structure(2, 1)
    eroded = ndi.binary_erosion(mask, strel, border_value=0)
    border = mask ^ eroded
    kernel = np.array([[10, 2, 10], [2, 1, 2], [10, 2, 10]])
    conv = ndi.convolve(border.astype(np.int32), kernel, mode="constant", cval=0)
    weights = np.zeros(50)
    weights[[5, 7, 15, 17, 25, 27]] = 1
    weights[[21, 33]] = np.sqrt(2)
    weights[[13, 23]] = (1 + np.sqrt(2)) / 2
    hist = np.bincount(conv[border].ravel(), minlength=50)
    return (hist * weights).sum()


def reference_find_neighbors(labels, working_labels=None):
    """Numpy port of the reference's find_neighbors (tissue_info.py:1815-1842):
    5x5 constant-padded max filter; for each working cell, labels under its dilated
    footprint are neighbors (inserted symmetrically). Returns a set of frozensets."""
    labels = np.asarray(labels)
    dil = ndi.maximum_filter(labels, size=(5, 5), mode="constant")
    n = labels.max()
    if working_labels is None:
        working_labels = range(1, n + 1)
    pairs = set()
    for lab in working_labels:
        neighborhood = labels[dil == lab]
        neighborhood = neighborhood[(neighborhood > 0) & (neighborhood != lab)]
        for other in np.unique(neighborhood):
            pairs.add(frozenset((int(lab), int(other))))
    return pairs


def reference_contact_matrix(labels):
    """Numpy port of calc_neighbors_contact_matrix (tissue_info.py:4073-4094)."""
    labels = np.asarray(labels)
    fp = np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]])
    mx = ndi.maximum_filter(labels, footprint=fp, mode="constant")
    lc = labels.copy()
    lc[lc == 0] = labels.max() + 1
    mn = ndi.minimum_filter(lc, footprint=fp, mode="constant")
    n = labels.max()
    out = np.zeros((n + 1, n + 1))
    for a in range(1, n + 1):
        for b in range(1, a):
            c = np.logical_and(mx == a, mn == b).sum()
            out[a, b] = c
            out[b, a] = c
    return out


def crocker_grier_link(frames, search_range=100.0, memory=3, area_weight=0.5,
                       subnet_limit=30, adaptive_step=0.95, adaptive_stop=10.0):
    """Crocker-Grier frame-to-frame linker with trackpy's ADAPTIVE subnet
    handling (reference config ``tissue_info.py:1924-1926``: search_range=100,
    adaptive_stop=10, memory=3; metric sqrt(dy^2+dx^2+0.5(sqrt a1-sqrt a2)^2)
    at :1935-1938).

    ``frames``: list of (cy, cx, area) float arrays (one per frame; already
    drift-corrected). Per frame pair: candidate links gated at search_range;
    connected subnets up to ``subnet_limit`` destination cells are solved
    EXACTLY (Hungarian with per-cell null options costing the subnet's
    effective search_range^2 — Crocker & Grier 1996 eq. 6). Oversized subnets
    get their search_range multiplied by ``adaptive_step`` and re-split,
    recursively — trackpy's adaptive search. trackpy raises
    SubnetOversizeException once the radius falls below ``adaptive_stop``; an
    oracle cannot crash, so the floor-radius subnet is solved exactly instead.
    Unmatched tracks persist for ``memory`` frames at their last position.

    Returns: list of int arrays of track ids (1-based) per frame.
    """
    from scipy.optimize import linear_sum_assignment
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as cc

    sr2 = search_range * search_range
    next_id = 1
    # live tracks: list of dicts(pos=(y,x), sa=sqrt_area, id, age)
    live = []
    out = []
    for (cy, cx, area) in frames:
        cy = np.asarray(cy, float)
        cx = np.asarray(cx, float)
        sa = np.sqrt(np.maximum(np.asarray(area, float), 0.0))
        m = len(cy)
        ids = np.zeros(m, np.int64)
        k = len(live)
        if k and m:
            ty = np.array([t["pos"][0] for t in live])
            tx = np.array([t["pos"][1] for t in live])
            tsa = np.array([t["sa"] for t in live])
            d2 = ((cy[:, None] - ty[None, :]) ** 2
                  + (cx[:, None] - tx[None, :]) ** 2
                  + area_weight * (sa[:, None] - tsa[None, :]) ** 2)
        else:
            d2 = np.zeros((m, k))
        taken = np.zeros(k, bool)

        def solve(cells, tracks, sr):
            """Match cells x tracks within radius sr; adaptive re-split."""
            sr2l = sr * sr
            ok = d2[np.ix_(cells, tracks)] < sr2l
            ci, ti = np.nonzero(ok)
            nc_all, nt_all = len(cells), len(tracks)
            g = coo_matrix((np.ones(len(ci)), (ci, nc_all + ti)),
                           shape=(nc_all + nt_all, nc_all + nt_all))
            ncomp, comp = cc(g, directed=False)
            for c in range(ncomp):
                sub_c = [cells[i] for i in np.nonzero(comp[:nc_all] == c)[0]]
                sub_t = [tracks[i] for i in np.nonzero(comp[nc_all:] == c)[0]]
                if not sub_c or not sub_t:
                    continue
                if (len(sub_c) > subnet_limit
                        and sr * adaptive_step >= adaptive_stop):
                    solve(sub_c, sub_t, sr * adaptive_step)
                    continue
                nc, nt = len(sub_c), len(sub_t)
                cost = np.full((nc, nt + nc), sr2l, float)
                sub = d2[np.ix_(sub_c, sub_t)]
                sub_ok = sub < sr2l
                cost[:nc, :nt] = np.where(sub_ok, sub, 1e18)
                rows, cols = linear_sum_assignment(cost)
                for r, cc_ in zip(rows, cols):
                    if cc_ < nt and cost[r, cc_] < 1e17:
                        tr = sub_t[cc_]
                        ids[sub_c[r]] = live[tr]["id"]
                        taken[tr] = True

        if k and m:
            solve(list(range(m)), list(range(k)), search_range)
        # fresh ids in order
        for i in range(m):
            if ids[i] == 0:
                ids[i] = next_id
                next_id += 1
        # rebuild live set
        new_live = [dict(pos=(cy[i], cx[i]), sa=sa[i], id=int(ids[i]), age=0)
                    for i in range(m)]
        for j, t in enumerate(live):
            if not taken[j] and t["age"] + 1 <= memory:
                t2 = dict(t)
                t2["age"] = t["age"] + 1
                new_live.append(t2)
        live = new_live
        out.append(ids)
    return out


def radii_tables(seed, T, cells, capacity, side=2000.0):
    """(T, capacity) cell tables of ~``cells`` cells drifting over a side^2
    frame (the benchmark's cell density at side 2000), on rows drawn at
    random, and (T, 2) float32 drifts: inputs of the adaptive radii."""
    rng = np.random.default_rng(seed)
    base = rng.random((cells, 2)) * side
    cy, cx, area = (np.zeros((T, capacity), np.float32) for _ in range(3))
    mask = np.zeros((T, capacity), bool)
    for t in range(T):
        n = cells - int(rng.integers(0, 60))
        p = base[:n] + rng.normal(0, 3, (n, 2)) + t * np.array([1.5, -1.0])
        rows = rng.permutation(capacity)[:n]
        cy[t, rows], cx[t, rows] = p[:, 0], p[:, 1]
        area[t, rows] = rng.normal(1500.0, 300.0, n)
        mask[t, rows] = True
    drifts = rng.normal(0, 1, (T, 2)).astype(np.float32)
    return cy, cx, area, mask, drifts
