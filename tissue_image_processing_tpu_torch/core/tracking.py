"""Drift-corrected frame-to-frame cell tracking.

Port of ``tissue_image_processing_tpu/core/tracking.py``: trackpy's linking
(metric sqrt(dy^2 + dx^2 + 0.5 (sqrt a1 - sqrt a2)^2), search_range gate,
memory) resolved per frame by a forward auction with top-k candidate pruning
and per-person eps escalation; the drift chain by phase correlation; and the
host-side adaptive per-cell radii (trackpy's subnet shrinking).

The JAX ``lax.while_loop``/``lax.scan`` become Python loops and the
``segment_*`` reductions ``scatter_reduce``. The arithmetic follows the JAX
version's float32 operations one for one, including the fused multiply-adds
its compiler forms in the link cost, so ids agree exactly on the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tissue_image_processing_tpu_torch._numerics import fma_f32
from tissue_image_processing_tpu_torch.ops.drift import phase_cross_correlation

__all__ = ["TrackingState", "auction_assignment", "link_frames", "track_movie",
           "compute_drift_chain", "adaptive_effective_ranges"]

_NEG = float("-inf")


def _seg_reduce(vals: torch.Tensor, seg: torch.Tensor, n: int, reduce: str,
                init) -> torch.Tensor:
    out = torch.full((n,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, reduce=reduce, include_self=False)


def auction_assignment(benefit: torch.Tensor, person_mask: torch.Tensor,
                       object_mask: torch.Tensor, eps: torch.Tensor | float = 1e-3,
                       max_rounds: int = 512,
                       cand_k: Optional[int] = None) -> torch.Tensor:
    """Forward auction for the assignment problem.

    ``benefit`` (M, K): value of assigning person m to object k (-inf = not
    allowed); staying unassigned has value 0. Each person bids only on its
    ``cand_k`` (default 8) best objects; each eviction doubles that person's
    eps (capped at 1024 eps). Returns (M,) object index per person, -1 if
    unassigned. See the JAX version's docstring for the design record."""
    M, K = benefit.shape
    dev = benefit.device
    C = min(cand_k or 8, K)
    neg = torch.full_like(benefit, _NEG)
    bb = torch.where(person_mask[:, None] & object_mask[None, :], benefit, neg)
    person_idx = torch.arange(M, device=dev)
    bs, idxs = [], []
    for _ in range(C):
        j = bb.argmax(dim=1)
        bs.append(bb[person_idx, j])
        idxs.append(j)
        bb = bb.index_put((person_idx, j), torch.tensor(_NEG, device=dev))
    b = torch.stack(bs, 1)           # (M, C) best benefits, descending
    cand = torch.stack(idxs, 1)      # (M, C) object indices
    eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)

    price = torch.zeros(K, dtype=torch.float32, device=dev)
    owner = torch.full((K,), -1, dtype=torch.int64, device=dev)
    person_obj = torch.full((M,), -1, dtype=torch.int64, device=dev)
    evictions = torch.zeros(M, dtype=torch.int64, device=dev)
    for _ in range(max_rounds):
        cur_eps = eps * torch.exp2(torch.clamp(evictions, max=10).to(torch.float32))
        active = person_mask & (person_obj < 0)
        vals = b - price[cand]
        v1 = vals.amax(dim=1)
        j1 = vals.argmax(dim=1)
        v2 = vals.index_put((person_idx, j1), torch.tensor(_NEG, device=dev)
                            ).amax(dim=1)
        bidding = active & (v1 >= 0.0)
        if not bool(bidding.any()):
            break
        obj = cand[person_idx, j1]
        incr = v1 - torch.clamp(v2, min=0.0) + cur_eps
        bid_price = price[obj] + incr
        # one winner per object: max bid, ties to the lowest person index
        key = torch.where(bidding, bid_price, torch.full_like(bid_price, _NEG))
        seg = torch.where(bidding, obj, K)
        obj_best = _seg_reduce(key, seg, K + 1, "amax", _NEG)[:K]
        is_best = bidding & (key == obj_best[obj])
        first = _seg_reduce(torch.where(is_best, person_idx, M), seg, K + 1,
                            "amin", M)[:K]
        winner = is_best & (person_idx == first[obj])
        newly_won = _seg_reduce(winner.to(torch.int64), seg, K + 1, "sum",
                                0)[:K] > 0
        evicted = (owner >= 0) & newly_won
        ev_idx = owner[evicted]
        person_obj[ev_idx] = -1
        evictions.index_add_(0, ev_idx, torch.ones_like(ev_idx))
        person_obj = torch.where(winner, obj, person_obj)
        owner[obj[winner]] = person_idx[winner]
        price = torch.where(newly_won, obj_best, price)
    return person_obj


@dataclasses.dataclass(frozen=True)
class TrackingState:
    """Live track set of fixed capacity K."""

    pos: torch.Tensor        # (K, 2) drift-corrected (cy, cx) f32
    sqrt_area: torch.Tensor  # (K,) f32
    track_id: torch.Tensor   # (K,) i32, 0 = empty slot
    age: torch.Tensor        # (K,) i32 frames since last seen
    next_id: torch.Tensor    # () i32 next fresh track id

    @classmethod
    def empty(cls, capacity: int, device=None) -> "TrackingState":
        z = torch.zeros(capacity, dtype=torch.float32, device=device)
        zi = torch.zeros(capacity, dtype=torch.int32, device=device)
        return cls(pos=torch.zeros(capacity, 2, dtype=torch.float32,
                                   device=device),
                   sqrt_area=z, track_id=zi, age=zi.clone(),
                   next_id=torch.tensor(1, dtype=torch.int32, device=device))


def _tracking_cost2(pos_p, sa_p, pos_c, sa_c, area_weight):
    """Squared link metric between tracks (K) and cells (M), as the fused
    multiply-adds fma(w*da, da, fma(dy, dy, dx*dx))."""
    dy = pos_p[None, :, 0] - pos_c[:, None, 0]
    dx = pos_p[None, :, 1] - pos_c[:, None, 1]
    da = sa_p[None, :] - sa_c[:, None]
    return fma_f32(area_weight * da, da, fma_f32(dy, dy, dx * dx))


def link_frames(state: TrackingState, cy: torch.Tensor, cx: torch.Tensor,
                area: torch.Tensor, mask: torch.Tensor,
                search_range: torch.Tensor | float = 100.0, memory: int = 3,
                area_weight: float = 0.5, eps_factor: float = 1e-5,
                max_rounds: int = 256, cand_k: int = 8
                ) -> Tuple[TrackingState, torch.Tensor]:
    """Link one frame's cells (padded arrays of size M) to the live track
    set; ``search_range`` is a scalar or an (M,) per-cell radius. Returns
    (new_state, track_ids (M,)), ids 0 where ``mask`` is False."""
    M = cy.shape[0]
    K = state.pos.shape[0]
    dev = cy.device
    alive = (state.track_id > 0) & (state.age <= memory)
    sa = torch.sqrt(torch.clamp(area, min=0.0))
    pos_c = torch.stack([cy, cx], 1)
    cost2 = _tracking_cost2(state.pos, state.sqrt_area, pos_c, sa, area_weight)
    sr = torch.as_tensor(search_range, dtype=torch.float32, device=dev)
    sr2 = sr * sr
    sr2_col = sr2[..., None] if sr.dim() else sr2
    benefit = torch.where(cost2 < sr2_col, sr2_col - cost2,
                          torch.full_like(cost2, _NEG))
    eps = torch.tensor(eps_factor, dtype=torch.float32, device=dev) * sr2.max()
    person_obj = auction_assignment(benefit, mask, alive, eps=eps,
                                    max_rounds=max_rounds, cand_k=cand_k)

    matched = person_obj >= 0
    safe_obj = torch.clamp(person_obj, 0, K - 1)
    ids = torch.where(matched, state.track_id[safe_obj], 0)
    fresh_needed = mask & ~matched
    fresh_rank = torch.cumsum(fresh_needed.to(torch.int32), 0) - 1
    ids = torch.where(fresh_needed, state.next_id + fresh_rank, ids).to(torch.int32)
    new_next = (state.next_id + fresh_needed.sum()).to(torch.int32)

    # rebuild the track set: current cells first (age 0), then unmatched live
    taken = torch.zeros(K + 1, dtype=torch.bool, device=dev)
    taken[torch.where(matched, safe_obj, K)] = True
    leftover = alive & ~taken[:K]
    cand_pos = torch.cat([pos_c, state.pos], 0)
    cand_sa = torch.cat([sa, state.sqrt_area], 0)
    cand_id = torch.cat([ids, torch.where(leftover, state.track_id, 0)], 0)
    cand_age = torch.cat([torch.zeros(M, dtype=torch.int32, device=dev),
                          state.age + 1], 0)
    cand_live = torch.cat([mask, leftover & (state.age + 1 <= memory)], 0)
    order = torch.argsort(torch.where(cand_live, cand_age, 1 << 30),
                          stable=True)[:K]
    keep = cand_live[order]
    new_state = TrackingState(
        pos=torch.where(keep[:, None], cand_pos[order], 0.0),
        sqrt_area=torch.where(keep, cand_sa[order], 0.0),
        track_id=torch.where(keep, cand_id[order], 0).to(torch.int32),
        age=torch.where(keep, cand_age[order], 0).to(torch.int32),
        next_id=new_next,
    )
    return new_state, ids


def track_movie(cy: torch.Tensor, cx: torch.Tensor, area: torch.Tensor,
                mask: torch.Tensor, drifts: Optional[torch.Tensor] = None,
                frame_valid: Optional[torch.Tensor] = None,
                search_range: float = 100.0, memory: int = 3,
                area_weight: float = 0.5, capacity: Optional[int] = None,
                eps_factor: float = 1e-5, max_rounds: int = 256,
                cand_k: int = 8, search_ranges: Optional[torch.Tensor] = None,
                init_state: Optional[TrackingState] = None,
                cum_drift_init: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Track a movie (or one T-chunk of it): (T, N) per-frame cell arrays ->
    (T, N) int32 track ids, plus ``(final_state, cum_drift)`` when
    ``return_state``. ``drifts`` (T, 2) are accumulated and added to the
    centroids; ``search_ranges`` (T,) or (T, N) override ``search_range``;
    invalid frames are skipped while track ages advance. Chunked calls pass
    the previous chunk's state and cumulative drift (``drifts[0]`` then being
    the boundary drift) and reproduce the whole-movie ids exactly."""
    T, N = cy.shape
    dev = cy.device
    K = capacity or 2 * N
    if drifts is None:
        drifts = torch.zeros(T, 2, dtype=torch.float32, device=dev)
    if frame_valid is None:
        frame_valid = torch.ones(T, dtype=torch.bool, device=dev)
    # sequential float32 running sum seeded with the carry, on the host: a
    # chunked run then accumulates exactly like the whole-movie run
    d = torch.where(frame_valid[:, None], drifts, 0.0).cpu().numpy()
    init = (np.zeros((1, 2), np.float32) if cum_drift_init is None
            else cum_drift_init.cpu().numpy().reshape(1, 2).astype(np.float32))
    cum = torch.from_numpy(np.cumsum(np.concatenate([init, d], 0), axis=0,
                                     dtype=np.float32)[1:]).to(dev)
    cy_c = cy + cum[:, 0:1]
    cx_c = cx + cum[:, 1:2]
    if search_ranges is None:
        search_ranges = torch.full((T,), search_range, dtype=torch.float32,
                                   device=dev)
    state = init_state if init_state is not None else TrackingState.empty(K, dev)
    valid_host = frame_valid.cpu().tolist()
    ids = []
    for t in range(T):
        if not valid_host[t]:
            state = dataclasses.replace(state, age=state.age + 1)
            ids.append(torch.zeros(N, dtype=torch.int32, device=dev))
            continue
        state, fid = link_frames(state, cy_c[t], cx_c[t], area[t], mask[t],
                                 search_range=search_ranges[t], memory=memory,
                                 area_weight=area_weight, eps_factor=eps_factor,
                                 max_rounds=max_rounds, cand_k=cand_k)
        ids.append(fid)
    ids = torch.where(mask & frame_valid[:, None], torch.stack(ids, 0), 0)
    if return_state:
        return ids, state, cum[-1]
    return ids


def compute_drift_chain(images: torch.Tensor,
                        upsample_factor: int = 100) -> torch.Tensor:
    """(T, H, W) frames -> (T, 2) drifts, drift[0] = 0; drift[t] is the shift
    that aligns frame t with frame t-1."""
    shifts = phase_cross_correlation(images[:-1], images[1:],
                                     upsample_factor=upsample_factor)
    return torch.cat([torch.zeros(1, 2, dtype=torch.float32,
                                  device=images.device), shifts], 0)


def adaptive_effective_ranges(cy: np.ndarray, cx: np.ndarray, area: np.ndarray,
                              mask: np.ndarray, drifts: Optional[np.ndarray] = None,
                              search_range: float = 100.0,
                              subnet_limit: int = 30,
                              adaptive_step: float = 0.95,
                              adaptive_stop: float = 10.0,
                              area_weight: float = 0.5,
                              prev_points: Optional[np.ndarray] = None,
                              cum_drift_init: Optional[np.ndarray] = None,
                              return_carry: bool = False,
                              per_cell: bool = False):
    """Per-frame (or, with ``per_cell``, per-cell) effective search radii
    replicating trackpy's adaptive subnet shrinking (reference
    ``adaptive_stop=10``): candidate subnets larger than ``subnet_limit``
    cells shrink their radius by ``adaptive_step`` until they split, floored
    at ``adaptive_stop``. Host numpy, a copy of the JAX package's function.

    T-chunked streaming passes the previous chunk's carry as ``prev_points``
    / ``cum_drift_init`` and gets ``(ranges, last_points, cum_drift)`` back
    with ``return_carry=True``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as _cc
    from scipy.spatial import cKDTree

    T, N = cy.shape
    if drifts is None:
        drifts = np.zeros((T, 2))
    # running sum seeded with the carry, so chunked sums equal whole-movie ones
    init = (np.zeros((1, 2)) if cum_drift_init is None
            else np.asarray(cum_drift_init, np.float64).reshape(1, 2))
    cum = np.cumsum(np.concatenate([init, drifts], 0), axis=0)[1:]
    out = (np.full((T, N), float(search_range)) if per_cell
           else np.full((T,), float(search_range)))
    prev = prev_points
    for t in range(T):
        rows = np.nonzero(mask[t])[0]
        # the link metric is plain Euclidean in (y, x, sqrt(w) sqrt(area))
        cur = np.stack([cy[t, rows] + cum[t, 0], cx[t, rows] + cum[t, 1],
                        np.sqrt(area_weight)
                        * np.sqrt(np.maximum(area[t, rows], 0.0))], axis=1)
        if prev is not None and len(cur) and len(prev):
            m, k = len(cur), len(prev)
            d_coo = cKDTree(cur).sparse_distance_matrix(
                cKDTree(prev), float(search_range), output_type="coo_matrix")
            ci, ti, dist = d_coo.row, d_coo.col, d_coo.data
            if per_cell:
                r_cells = np.full(m, float(search_range))

                def assign_radii(pair_idx, cells_scope, r):
                    r_cells[cells_scope] = r
                    sel = pair_idx[dist[pair_idx] < r]
                    if sel.size == 0:
                        return
                    cells_in = np.unique(ci[sel])
                    tracks_in = np.unique(ti[sel])
                    nc, nt = cells_in.size, tracks_in.size
                    cl = np.searchsorted(cells_in, ci[sel])
                    tl = np.searchsorted(tracks_in, ti[sel])
                    g = coo_matrix((np.ones(sel.size), (cl, nc + tl)),
                                   shape=(nc + nt, nc + nt))
                    ncomp, comp = _cc(g, directed=False)
                    sizes = np.bincount(comp[:nc], minlength=ncomp)
                    for c in np.nonzero(sizes > subnet_limit)[0]:
                        if r * adaptive_step < adaptive_stop:
                            continue
                        cells_c = cells_in[comp[:nc] == c]
                        sub = sel[np.isin(ci[sel], cells_c)]
                        assign_radii(sub, cells_c, r * adaptive_step)

                assign_radii(np.arange(dist.size), np.arange(m),
                             float(search_range))
                out[t, rows] = r_cells
            else:
                r = float(search_range)
                while r * adaptive_step >= adaptive_stop:
                    sel = dist < r
                    g = coo_matrix((np.ones(sel.sum()), (ci[sel], m + ti[sel])),
                                   shape=(m + k, m + k))
                    ncomp, comp = _cc(g, directed=False)
                    sizes = np.bincount(comp[:m], minlength=ncomp)
                    if sizes.max(initial=0) <= subnet_limit:
                        break
                    r *= adaptive_step
                out[t] = r
        prev = cur
    if return_carry:
        return out, prev, cum[-1] if T else (cum_drift_init
                                             if cum_drift_init is not None
                                             else np.zeros(2))
    return out
