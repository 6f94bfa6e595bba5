"""Drift-corrected frame-to-frame cell tracking.

Port of ``tissue_image_processing_tpu/core/tracking.py``: trackpy's linking
(metric sqrt(dy^2 + dx^2 + 0.5 (sqrt a1 - sqrt a2)^2), search_range gate,
memory) resolved per frame by a forward auction with top-k candidate pruning
and per-person eps escalation (on the card every round of a frame's auction
in one ``csrc/auction.cu`` launch); the drift chain and the windowed local
drift field by phase correlation; the adaptive per-cell radii (trackpy's
subnet shrinking: the JAX package's host recursion, and
:func:`adaptive_radii`, the same radii as one level sweep of a union-find,
on the card the ``csrc/radii.cu`` kernels); and the legacy nearest-pixel
tracker (host numpy and scipy, as in the JAX package).

The JAX ``lax.while_loop``/``lax.scan`` become Python loops (the auction's
rounds, on the card, a kernel) and the ``segment_*`` reductions
``scatter_reduce``. The arithmetic follows the JAX version's float32
operations one for one, including the fused multiply-adds its compiler forms
in the link cost, so ids agree exactly on the same inputs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch._device import (
    count, resolve_device, to_host)
from tissue_image_processing_tpu_torch._numerics import fma_f32
from tissue_image_processing_tpu_torch.ops.drift import phase_cross_correlation

__all__ = ["TrackingState", "auction_assignment", "link_frames", "track_movie",
           "track_movie_nearest_pixel", "compute_drift_chain",
           "local_drift_field", "adaptive_effective_ranges",
           "RadiiCarry", "adaptive_radii"]

_NEG = float("-inf")
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


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
    unassigned. See the JAX version's docstring for the design record.

    A CPU tensor runs the rounds as a Python loop (:func:`_rounds_plain`),
    a CUDA tensor (float32 benefits) in one launch of ``csrc/auction.cu``
    with no host read between rounds. Each call adds its rounds, the last
    one (no bidder left, or the ``max_rounds``-th) included, to
    ``COUNTS["auction_rounds"]``: on the card one host read a call."""
    rounds = torch.zeros(1, dtype=torch.int32, device=benefit.device)
    person_obj = _auction(benefit, person_mask, object_mask, eps, max_rounds,
                          cand_k, rounds)
    count("auction_rounds", int(rounds))
    return person_obj


def _auction(benefit, person_mask, object_mask, eps, max_rounds, cand_k,
             rounds: torch.Tensor) -> torch.Tensor:
    """:func:`auction_assignment` with its round count written to
    ``rounds`` (one int32 on ``benefit``'s device), not counted: the
    candidate pruning, then the rounds on the tensors' device."""
    K = benefit.shape[1]
    dev = benefit.device
    b, cand = _candidates(benefit, person_mask, object_mask,
                          min(cand_k or 8, K))
    eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        person_obj, n = _rounds_plain(b, cand, person_mask, eps, K, max_rounds)
        rounds.fill_(n)
        return person_obj
    return _rounds_card(b, cand, person_mask, eps, K, max_rounds, rounds)


def _candidates(benefit, person_mask, object_mask, C: int):
    """Each person's C best objects by C argmax passes over the masked
    (M, K) benefits: (b (M, C) descending, cand (M, C) int64)."""
    M = benefit.shape[0]
    dev = benefit.device
    neg = torch.full_like(benefit, _NEG)
    bb = torch.where(person_mask[:, None] & object_mask[None, :], benefit, neg)
    person_idx = torch.arange(M, device=dev)
    bs, idxs = [], []
    for _ in range(C):
        j = bb.argmax(dim=1)
        bs.append(bb[person_idx, j])
        idxs.append(j)
        bb = bb.index_put((person_idx, j), torch.tensor(_NEG, device=dev))
    return torch.stack(bs, 1), torch.stack(idxs, 1)


def _rounds_plain(b: torch.Tensor, cand: torch.Tensor,
                  person_mask: torch.Tensor, eps: torch.Tensor, K: int,
                  max_rounds: int) -> Tuple[torch.Tensor, int]:
    """The auction's rounds on the (M, C) candidates as a Python loop, on
    any device; each round waits for the host to read its flag. Returns
    (person_obj, rounds)."""
    M = b.shape[0]
    dev = b.device
    person_idx = torch.arange(M, device=dev)
    price = torch.zeros(K, dtype=torch.float32, device=dev)
    owner = torch.full((K,), -1, dtype=torch.int64, device=dev)
    person_obj = torch.full((M,), -1, dtype=torch.int64, device=dev)
    evictions = torch.zeros(M, dtype=torch.int64, device=dev)
    rounds = 0
    for rounds in range(1, max_rounds + 1):
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
    return person_obj, rounds


_AUCTION_SIGNATURES = {
    "auction_shared_limit": (),
    "auction_solve": (_P,) * 4 + (_I,) * 4 + (_P,) * 3,
}


def _auction_shared_limit(lib, dev: torch.device) -> int:
    """State bytes of one auction that ``dev``'s shared memory holds."""
    with torch.cuda.device(dev):
        return lib.auction_shared_limit()


def _rounds_card(b: torch.Tensor, cand: torch.Tensor,
                 person_mask: torch.Tensor, eps: torch.Tensor, K: int,
                 max_rounds: int, rounds: torch.Tensor) -> torch.Tensor:
    """:func:`_rounds_plain` in one launch of ``csrc/auction.cu``: the same
    person_obj, the round count written to ``rounds``, nothing read back.
    The state lives in shared memory up to the card's limit, else in a
    device-memory workspace (``COUNTS["auction_global"]``)."""
    M, C = b.shape
    dev = b.device
    b, cand = b.contiguous(), cand.contiguous()
    _device.require_cuda_tensor(b, torch.float32, 2, "auction benefits")
    _device.require_cuda_tensor(cand, torch.int64, 2, "auction candidates")
    person = person_mask.to(torch.bool).contiguous().view(torch.uint8)
    person_obj = torch.empty(M, dtype=torch.int64, device=dev)
    lib = _device.load_library("auction", _AUCTION_SIGNATURES)
    # best bid, price and owner an object, the round's list of objects bid
    # on, object and evictions a person (csrc/auction.cu state_bytes)
    nbytes = 16 * K + 4 * min(M, K) + 8 * M
    ws = (None if nbytes <= _auction_shared_limit(lib, dev) else
          torch.empty(nbytes, dtype=torch.uint8, device=dev))
    _device.launch(lib, lib.auction_solve, dev, "auction_solve",
                   _device.ptr(b), _device.ptr(cand), _device.ptr(person),
                   _device.ptr(eps), M, K, C, max_rounds,
                   _device.ptr(person_obj), _device.ptr(rounds),
                   None if ws is None else _device.ptr(ws))
    _device.count_launch("auction")
    count("auction_card", 1)
    if ws is not None:
        count("auction_global", 1)
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
    (new_state, track_ids (M,)), ids 0 where ``mask`` is False. Adds the
    auction's rounds to ``COUNTS["auction_rounds"]``."""
    rounds = torch.zeros(1, dtype=torch.int32, device=cy.device)
    out = _link(state, cy, cx, area, mask, search_range, memory, area_weight,
                eps_factor, max_rounds, cand_k, rounds)
    count("auction_rounds", int(rounds))
    return out


def _link(state: TrackingState, cy, cx, area, mask, search_range, memory,
          area_weight, eps_factor, max_rounds, cand_k, rounds: torch.Tensor
          ) -> Tuple[TrackingState, torch.Tensor]:
    """:func:`link_frames` with the auction's round count written to
    ``rounds`` (one int32 on the tables' device)."""
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
    person_obj = _auction(benefit, mask, alive, eps, max_rounds, cand_k,
                          rounds)

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
    the boundary drift) and reproduce the whole-movie ids exactly. Each
    frame's auction writes its rounds to a slot of its own; the call adds
    them to ``COUNTS["auction_rounds"]`` with one read."""
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
    rounds = torch.zeros(T, dtype=torch.int32, device=dev)
    ids = []
    for t in range(T):
        if not valid_host[t]:
            state = dataclasses.replace(state, age=state.age + 1)
            ids.append(torch.zeros(N, dtype=torch.int32, device=dev))
            continue
        state, fid = _link(state, cy_c[t], cx_c[t], area[t], mask[t],
                           search_ranges[t], memory, area_weight, eps_factor,
                           max_rounds, cand_k, rounds[t:t + 1])
        ids.append(fid)
    count("auction_rounds", int(rounds.sum()))
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


def local_drift_field(first: torch.Tensor, second: torch.Tensor,
                      window_size: int = 700, step_size: int = 100,
                      upsample_factor: int = 100
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed drift field: overlapping ``window_size`` windows on a
    ``step_size`` grid, one batched sub-pixel phase correlation over all of
    them, and each pixel the mean of the shifts of the windows covering it
    (reference ``fix_one_frame_tracking_using_local_drifts``). The sums are
    taken window by window in the JAX version's order, so equal shifts give
    equal maps. Returns (shift_y_map, shift_x_map), float32 of the input
    shape."""
    H, W = first.shape
    ys = list(range(0, max(H - window_size, 0) + 1, step_size)) or [0]
    xs = list(range(0, max(W - window_size, 0) + 1, step_size)) or [0]
    wy, wx = min(window_size, H), min(window_size, W)
    corners = [(y, x) for y in ys for x in xs]
    tiles1 = torch.stack([first[y:y + wy, x:x + wx] for y, x in corners])
    tiles2 = torch.stack([second[y:y + wy, x:x + wx] for y, x in corners])
    shifts = phase_cross_correlation(tiles1, tiles2,
                                     upsample_factor=upsample_factor)
    sy = torch.zeros((H, W), dtype=torch.float32, device=first.device)
    sx = torch.zeros_like(sy)
    cnt = torch.zeros_like(sy)
    for i, (y, x) in enumerate(corners):
        sy[y:y + wy, x:x + wx] += shifts[i, 0]
        sx[y:y + wy, x:x + wx] += shifts[i, 1]
        cnt[y:y + wy, x:x + wx] += 1.0
    cnt = torch.clamp(cnt, min=1.0)
    return sy / cnt, sx / cnt


def track_movie_nearest_pixel(labels_stack: np.ndarray, cy: np.ndarray,
                              cx: np.ndarray, mask: np.ndarray,
                              drifts: Optional[np.ndarray] = None,
                              frame_valid: Optional[np.ndarray] = None,
                              images: Optional[np.ndarray] = None,
                              use_flow: bool = False,
                              device=None) -> np.ndarray:
    """Legacy nearest-pixel tracker (reference ``track_cells_iterator``), on
    the host: each previous-frame centroid, shifted by the drift, samples
    the 3x3-dilated current label map; a row claimed twice keeps its first
    claimant, unmatched cells get fresh ids. Arrays: labels_stack (T, H, W)
    int; cy / cx / mask (T, N) padded per-frame tables. Returns (T, N)
    int64 track ids.

    With ``use_flow=True`` and ``images`` (T, H, W), the global drift is
    replaced by a dense TV-L1 flow map (``ops/optical_flow.py``) computed on
    ``device`` (``None``: the card) for each pair of frames and sampled at
    the previous centroids (clipped and rounded): the reference's
    ``use_piv`` branch. The flow is ``optical_flow_tvl1(cur, prev)``, so the
    cell at previous position ``y`` is looked up at ``y - flow(y)``; only
    the N sampled values of each pair are read back to the host."""
    from scipy.ndimage import maximum_filter as ndi_max

    T, N = cy.shape
    if drifts is None:
        drifts = np.zeros((T, 2))
    if frame_valid is None:
        frame_valid = np.ones((T,), bool)
    if use_flow and images is None:
        raise ValueError("use_flow=True requires images")
    if use_flow:
        from tissue_image_processing_tpu_torch.ops.optical_flow import (
            optical_flow_tvl1)
        dev = resolve_device(device)
    ids = np.zeros((T, N), np.int64)
    first = next((t for t in range(T) if frame_valid[t]), None)
    if first is None:
        return ids
    n0 = int(mask[first].sum())
    ids[first, mask[first]] = np.arange(1, n0 + 1)
    next_id = n0 + 1
    prev = first
    for t in range(first + 1, T):
        if not frame_valid[t]:
            continue
        dil = ndi_max(labels_stack[t], size=(3, 3), mode="constant")
        H, W = dil.shape
        if use_flow:
            flow = optical_flow_tvl1(images[t], images[prev], device=dev)
            iy = np.clip(np.round(cy[prev]).astype(int), 0, flow.shape[1] - 1)
            ix = np.clip(np.round(cx[prev]).astype(int), 0, flow.shape[2] - 1)
            fy, fx = to_host(flow[:, torch.from_numpy(iy).to(dev),
                                  torch.from_numpy(ix).to(dev)])[0]
            py = np.round(cy[prev] - fy).astype(int)
            px = np.round(cx[prev] - fx).astype(int)
        else:
            py = np.round(cy[prev] - drifts[t, 0]).astype(int)
            px = np.round(cx[prev] - drifts[t, 1]).astype(int)
        ok = mask[prev] & (py >= 0) & (py < H) & (px >= 0) & (px < W)
        cur_rows = np.full(N, -1)
        cur_rows[ok] = dil[py[ok], px[ok]] - 1
        taken_rows = set()
        for i in np.nonzero(ok & (cur_rows >= 0))[0]:
            r = int(cur_rows[i])
            if r in taken_rows or r >= N or not mask[t, r] or ids[t, r] != 0:
                continue
            taken_rows.add(r)
            ids[t, r] = ids[prev, i]
        fresh = mask[t] & (ids[t] == 0)
        k = int(fresh.sum())
        ids[t, fresh] = np.arange(next_id, next_id + k)
        next_id += k
        prev = t
    return ids


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
    The pipelines and ``Tissue`` take per-cell radii from
    :func:`adaptive_radii`; the tests hold it to this recursion.

    T-chunked streaming passes the previous chunk's carry as ``prev_points``
    / ``cum_drift_init`` and gets ``(ranges, last_points, cum_drift)`` back
    with ``return_carry=True``. Each call adds its connected-component
    solves to ``COUNTS["radii_solves"]``."""
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
    solves = 0
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
                    nonlocal solves
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
                    solves += 1
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
                    solves += 1
                    sizes = np.bincount(comp[:m], minlength=ncomp)
                    if sizes.max(initial=0) <= subnet_limit:
                        break
                    r *= adaptive_step
                out[t] = r
        prev = cur
    count("radii_solves", solves)
    if return_carry:
        return out, prev, cum[-1] if T else (cum_drift_init
                                             if cum_drift_init is not None
                                             else np.zeros(2))
    return out


# --- adaptive radii as one level sweep ----------------------------------------

_TABLES = (_P,) * 10 + (_I,) * 4 + (_D,) * 4
_RADII_SIGNATURES = {
    "radii_shared_limit": (),
    "radii_count": _TABLES + (_P, _P, _P),
    "radii_sweep": _TABLES + (_P, _P, _P, _P, _I, _P, _P, _P, _P),
}
_RADII_LAUNCHES = 3  # count, emit, sweep
_MAX_LEVELS = 512    # csrc/radii.cu MAX_LEVELS
# adaptive_effective_ranges' defaults, which every caller runs: subnets of
# more than _SUBNET_LIMIT cells shrink their radius by _ADAPTIVE_STEP while
# it stays >= _ADAPTIVE_STOP; the area term is weighted by 0.5
_SUBNET_LIMIT, _ADAPTIVE_STEP, _ADAPTIVE_STOP = 30, 0.95, 10.0
_SQRT_AREA_WEIGHT = math.sqrt(0.5)


@dataclasses.dataclass(frozen=True)
class RadiiCarry:
    """What :func:`adaptive_radii` carries from one T-chunk to the next:
    the last frame's rows (cells link to them) and the float64 running
    drift sum after it."""

    cy: torch.Tensor     # (K,) f32
    cx: torch.Tensor     # (K,) f32
    area: torch.Tensor   # (K,) f32
    valid: torch.Tensor  # (K,) bool
    cum: torch.Tensor    # (2,) f64


def _radii_levels(search_range: float) -> list:
    """The recursion's radii r_0 = search_range, r_{i+1} = r_i *
    ``_ADAPTIVE_STEP`` (float64 products in that order) while r_{i+1} >=
    ``_ADAPTIVE_STOP``."""
    radii = [float(search_range)]
    while radii[-1] * _ADAPTIVE_STEP >= _ADAPTIVE_STOP:
        if len(radii) == _MAX_LEVELS:
            raise ValueError(
                f"adaptive radii: more than {_MAX_LEVELS} levels from "
                f"{search_range} by {_ADAPTIVE_STEP} down to {_ADAPTIVE_STOP}")
        radii.append(radii[-1] * _ADAPTIVE_STEP)
    return radii


def adaptive_radii(cy: torch.Tensor, cx: torch.Tensor, area: torch.Tensor,
                   mask: torch.Tensor, drifts=None, search_range: float = 100.0,
                   carry: Optional[RadiiCarry] = None,
                   return_carry: bool = False):
    """:func:`adaptive_effective_ranges` with ``per_cell=True`` and its
    default subnet limit, step, stop and area weight, on the (T, N) tables'
    device: the same radii as float32 (T, N) on that device (with
    ``return_carry``, ``(radii, RadiiCarry)``), and the same solves added to
    ``COUNTS["radii_solves"]``.

    The recursion's re-solve of a subnet at a shrunk radius equals the
    global components one level down restricted to it, since the
    components of the radii r_0 > r_1 > ... nest. So one sweep of a
    union-find from the deepest level to r_0 gives every cell the deepest
    level at which its component is oversized, and the radius one level
    below it. A card tensor runs ``csrc/radii.cu`` (three launches, two
    small host reads: the pair total and the solves); a CPU tensor the plain
    form of the same sweep (:func:`_radii_plain`). ``drifts`` (T, 2), numpy
    or a tensor, are summed in float64 as the host does; ``carry`` (the
    previous chunk's) makes chunked radii equal the whole movie's."""
    dev = cy.device
    T, N = cy.shape
    levels = _radii_levels(search_range)
    if T == 0:
        radii = torch.empty((0, N), dtype=torch.float32, device=dev)
        return (radii, carry) if return_carry else radii
    if drifts is None:
        drift = torch.zeros((T, 2), dtype=torch.float64, device=dev)
    else:
        drift = torch.as_tensor(drifts).to(device=dev, dtype=torch.float64)
    cum0 = (torch.zeros(2, dtype=torch.float64, device=dev) if carry is None
            else carry.cum.to(device=dev, dtype=torch.float64))
    if dev.type == "cpu":
        radii, cum, solves = _radii_plain(cy, cx, area, mask, drift, cum0,
                                          carry, levels)
    else:
        radii, cum, solves = _radii_card(cy, cx, area, mask, drift, cum0,
                                         carry, levels)
    count("radii_solves", solves)
    if not return_carry:
        return radii
    return radii, RadiiCarry(cy[-1], cx[-1], area[-1], mask[-1], cum)


def _radii_lib():
    return _device.load_library("radii", _RADII_SIGNATURES)


def _radii_shared_limit(lib, dev: torch.device) -> int:
    """Union-find bytes a frame that the sweep can keep in ``dev``'s shared
    memory."""
    with torch.cuda.device(dev):
        return lib.radii_shared_limit()


def _radii_card(cy, cx, area, mask, drift, cum0, carry, levels):
    """The sweep in ``csrc/radii.cu`` (the kernels rebuild ``levels`` as
    r_{i+1} = r_i * ``_ADAPTIVE_STEP``): returns (radii, cum, solves)."""
    dev = cy.device
    T, N = cy.shape
    f32 = lambda x: x.to(torch.float32).contiguous()
    u8 = lambda x: x.to(torch.bool).contiguous().view(torch.uint8)
    tabs = [f32(cy), f32(cx), f32(area), u8(mask)]
    if carry is None:
        prev, K = [None] * 4, 0
    else:
        prev = [f32(carry.cy.to(dev)), f32(carry.cx.to(dev)),
                f32(carry.area.to(dev)), u8(carry.valid.to(dev))]
        K = prev[0].shape[0]
    drift, cum0 = drift.contiguous(), cum0.contiguous()
    nlev, r0 = len(levels), levels[0]
    # a squared bound above r0^2: no pair beyond it has sqrt < r0
    thr = r0 * r0 * (1.0 + 2.0 ** -40)
    ptrs = [None if x is None else _device.ptr(x) for x in tabs + prev]
    args = (*ptrs, _device.ptr(drift), _device.ptr(cum0), T, N, K, nlev, r0,
            _ADAPTIVE_STEP, thr, _SQRT_AREA_WEIGHT)
    buf = torch.zeros(2 * T * nlev + 2, dtype=torch.int32, device=dev)
    counts, cursor = buf[:T * nlev], buf[T * nlev:2 * T * nlev]
    meta = buf[2 * T * nlev:]
    lib = _radii_lib()
    _device.launch(lib, lib.radii_count, dev, "radii_count", *args,
                   _device.ptr(counts), _device.ptr(meta))
    pairs = int(meta[0])
    edges = torch.empty((max(pairs, 1), 2), dtype=torch.int32, device=dev)
    radii = torch.empty((T, N), dtype=torch.float32, device=dev)
    cum = torch.empty(2, dtype=torch.float64, device=dev)
    # the union-find's bytes a frame: parent and count a node, two shorts
    # a cell; beyond the card's shared memory they live in device memory
    nbytes = 8 * (N + max(N, K)) + 4 * N
    ws = (None if nbytes <= _radii_shared_limit(lib, dev) else
          torch.empty(T * nbytes // 4, dtype=torch.int32, device=dev))
    _device.launch(lib, lib.radii_sweep, dev, "radii_sweep", *args,
                   _device.ptr(counts), _device.ptr(cursor),
                   _device.ptr(meta), _device.ptr(edges), _SUBNET_LIMIT,
                   _device.ptr(radii), _device.ptr(cum),
                   None if ws is None else _device.ptr(ws))
    _device.count_launch("radii_sweep", _RADII_LAUNCHES)
    return radii, cum, int(meta[1])


def _radii_points(cy, cx, area, valid, cum):
    """Rows and float64 points (y, x, sqrt(w) sqrt(max(area, 0))) of one
    frame's valid cells, rounded as the host rounds them."""
    rows = np.nonzero(valid)[0]
    side = np.sqrt(np.maximum(area[rows], np.float32(0))).astype(np.float64)
    return rows, np.stack([cy[rows].astype(np.float64) + cum[0],
                           cx[rows].astype(np.float64) + cum[1],
                           _SQRT_AREA_WEIGHT * side], axis=1)


def _uf_roots(parent: np.ndarray) -> np.ndarray:
    while True:
        up = parent[parent]
        if np.array_equal(up, parent):
            return parent
        parent = up


def _uf_unite(parent: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Unite the sets of every pair (a[k], b[k]); roots stay the smallest
    index of their set. Returns the parent array, every node at its root."""
    while True:
        parent = _uf_roots(parent)
        ra, rb = parent[a], parent[b]
        apart = ra != rb
        if not apart.any():
            return parent
        a, b, ra, rb = a[apart], b[apart], ra[apart], rb[apart]
        np.minimum.at(parent, np.maximum(ra, rb), np.minimum(ra, rb))


def _sweep_plain(N: int, P: int, cell: np.ndarray, prev: np.ndarray,
                 level: np.ndarray, nlev: int):
    """The kernel's sweep over one frame's pairs (cell row, previous row) at
    their levels: returns each cell's first oversized level met from the
    deepest (-1: none) and the frame's solves."""
    parent = np.arange(N + P)
    maxlev = np.full(N, -1)
    first = np.full(N, -1)
    solves = int(cell.size > 0)
    for lev in range(nlev - 1, -1, -1):
        here = level == lev
        a = cell[here]
        maxlev[a] = np.maximum(maxlev[a], lev)
        parent = _uf_unite(parent, a, N + prev[here])
        if lev == nlev - 1 or not (level >= lev).any():
            continue
        touched = np.nonzero(maxlev >= 0)[0]
        root = parent[touched]
        big = np.bincount(root, minlength=N + P) > _SUBNET_LIMIT
        deep = np.zeros(N + P, bool)
        deep[root[maxlev[touched] > lev]] = True
        hit = touched[big[root]]
        first[hit] = np.where(first[hit] < 0, lev, first[hit])
        solves += int((big & deep).sum())
    return first, solves


def _radii_plain(cy, cx, area, mask, drift, cum0, carry, levels):
    """Plain form of ``csrc/radii.cu`` on the host: the pairs within r_0
    (candidates from a KD-tree, distances by the kernel's formula), each at
    its level, then :func:`_sweep_plain` a frame. Returns (radii, cum,
    solves) as tensors on ``cy``'s device."""
    from scipy.spatial import cKDTree

    T, N = cy.shape
    cy, cx, area = (x.to(torch.float32).numpy() for x in (cy, cx, area))
    valid = mask.to(torch.bool).numpy()
    drift, cum = drift.numpy(), cum0.numpy().copy()
    r = np.asarray(levels)
    out = np.full((T, N), r[0])
    prev = None
    if carry is not None:
        prev = _radii_points(carry.cy.to(torch.float32).numpy(),
                             carry.cx.to(torch.float32).numpy(),
                             carry.area.to(torch.float32).numpy(),
                             carry.valid.to(torch.bool).numpy(), cum)
        prev = prev + (carry.valid.shape[0],)
    solves = 0
    for t in range(T):
        cum = cum + drift[t]
        rows, pts = _radii_points(cy[t], cx[t], area[t], valid[t], cum)
        if prev is not None and len(rows) and len(prev[0]):
            prows, ppts, P = prev
            near = cKDTree(pts).sparse_distance_matrix(
                cKDTree(ppts), r[0] * (1 + 1e-9), output_type="coo_matrix")
            d = pts[near.row] - ppts[near.col]
            dist = np.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                           + d[:, 2] * d[:, 2])
            keep = dist < r[0]
            dist = dist[keep]
            level = (dist[:, None] < r[None, 1:]).sum(axis=1)
            first, n = _sweep_plain(N, P, rows[near.row[keep]],
                                    prows[near.col[keep]], level, len(r))
            out[t] = r[first + 1]  # first == -1: r_0
            solves += n
        prev = rows, pts, N
    return (torch.from_numpy(out.astype(np.float32)),
            torch.from_numpy(cum), solves)
