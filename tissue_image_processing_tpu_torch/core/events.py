"""Event detection, the event store, and post-tracking type repair.

Port of ``tissue_image_processing_tpu/core/events.py``. Frame-pair set logic
on track ids detects delaminations (an id disappears with all its
neighbours stable), differentiations (an id newly positive for the HC
marker, present in both frames) and divisions (a new id whose
drift-corrected previous position falls inside a stable neighbour's old
cell). Events live in a pandas DataFrame with the ``EVENTS_INFO_SPEC``
schema. Each frame's table is read to the host once, all seven fields in
one batched transfer (``_device.to_host``); the detection itself is host
numpy, and ``fix_cell_types_after_tracking`` writes the repaired types back
on each table's own device.

Neighbour rows are segmentation labels minus one (the reference indexed
neighbour rows by label when checking neighbour stability, an off-by-one
fixed in the JAX package and kept fixed here).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import pandas as pd

from tissue_image_processing_tpu_torch._device import to_host
from tissue_image_processing_tpu_torch.core.cell_table import (
    replace_fields, to_numpy)

__all__ = ["add_event", "delete_event", "find_events_iterator", "find_event_frame",
           "fix_cell_types_after_tracking", "events_correlation_function",
           "events_rate_by_n_neighbors", "events_timing_by_n_neighbors"]


def add_event(tissue, event_type, start_frame, end_frame, start_pos=None,
              end_pos=None, second_end_pos=None, start_cell_id=None,
              daughter_cell_id=None, source="manual"):
    """Append one event row."""
    if start_frame is None:
        return 0
    if event_type == "delete event":
        return delete_event(tissue, start_frame, start_pos)
    if start_pos is not None:
        start_cell_id = tissue.get_cell_id_by_position(start_frame, start_pos)
    else:
        start_pos = tissue.get_cell_centroid_by_id(start_frame, start_cell_id)
        if start_pos is None:
            return 0
    if end_pos is not None:
        end_cell_id = tissue.get_cell_id_by_position(end_frame, end_pos)
    else:
        end_cell_id = start_cell_id
        go_back = 0
        end_pos = None
        while end_pos is None:
            end_pos = tissue.get_cell_centroid_by_id(end_frame - go_back, start_cell_id)
            go_back += 1
            if end_frame - go_back < start_frame:
                return 0
    new_event = {"type": event_type, "start_frame": start_frame,
                 "end_frame": end_frame, "start_pos_x": start_pos[0],
                 "start_pos_y": start_pos[1], "end_pos_x": end_pos[0],
                 "end_pos_y": end_pos[1], "daughter_pos_x": 0, "daughter_pos_y": 0,
                 "cell_id": start_cell_id, "daughter_id": 0, "source": source}
    if second_end_pos is not None or daughter_cell_id is not None:
        if daughter_cell_id is None:
            second_cell_id = tissue.get_cell_id_by_position(end_frame, second_end_pos)
        else:
            second_cell_id = daughter_cell_id
        if second_end_pos is None:
            second_end_pos = tissue.get_cell_centroid_by_id(end_frame, daughter_cell_id)
            if second_end_pos is None:
                return 0
        if start_cell_id != end_cell_id and start_cell_id == second_cell_id:
            second_cell_id = end_cell_id
        new_event["daughter_pos_x"] = second_end_pos[0]
        new_event["daughter_pos_y"] = second_end_pos[1]
        new_event["daughter_id"] = second_cell_id
    new_event["significant_frame"] = int(find_event_frame(tissue, new_event))
    tissue.events = pd.concat([tissue.events, pd.DataFrame(new_event, index=[0])],
                              ignore_index=True)
    return 0


def delete_event(tissue, start_frame, start_pos):
    cell_id = tissue.get_cell_id_by_position(start_frame, start_pos)
    to_delete = tissue.events.query(
        "start_frame == %d and (cell_id == %d or daughter_id == %d)"
        % (start_frame, cell_id, cell_id))
    if to_delete.size > 0:
        tissue.events.drop(to_delete.index, inplace=True)
    return 0


def find_event_frame(tissue, event) -> int:
    """The event's significant frame: the last valid frame before the cell
    disappears (delamination), before the daughter appears (division) or
    before the cell turns positive for type 0 (differentiation)."""
    start_frame = int(event["start_frame"])
    end_frame = int(event["end_frame"])
    event_type = event["type"]
    last_valid = start_frame
    for frame in range(start_frame, end_frame + 1):
        if not tissue.is_frame_valid(frame):
            continue
        c = tissue.get_cell_centroid_by_id(frame, int(event["cell_id"]))
        if event_type == "delamination":
            if c is None:
                return last_valid
        elif event_type == "division":
            d = tissue.get_cell_centroid_by_id(frame, int(event.get("daughter_id", 0)))
            if d is not None:
                return last_valid
        elif event_type == "differentiation":
            table = tissue.get_cells_info(frame)
            if table is not None and c is not None:
                lab, ok, types = to_host(table.label, table.valid_mask(),
                                         table.type)
                idx = np.nonzero((lab == int(event["cell_id"])) & ok)[0]
                if idx.size and bool(_positive_mask_host(types[idx[0]], 0)):
                    return last_valid
        last_valid = frame
    return start_frame


def _frame_view(tissue, frame):
    """numpy views of one frame's tracked cells: the table's seven fields
    come to the host in ONE batched transfer (non-blocking copies into
    pinned buffers, one synchronisation), not a blocking read a field."""
    table = tissue.get_cells_info(frame)
    labels = tissue.get_labels(frame)
    mask, ids, nbrs, cx, cy, types = to_host(
        table.valid_mask(), table.label, table.neighbors, table.cx, table.cy,
        table.type)
    labels = to_numpy(labels)
    # border rows from the host labels (tissue.detect_edge_cells' logic)
    edge = np.concatenate([labels[0, :], labels[:, 0], labels[-1, :],
                           labels[:, -1]])
    edge_rows = np.unique(edge[edge > 0]) - 1
    edge_row = np.zeros(ids.size, bool)
    edge_row[edge_rows[edge_rows < ids.size]] = True
    edge_ids = ids[edge_row]
    return dict(table=table, labels=labels, mask=mask, ids=ids,
                valid_ids=ids[mask], edge_ids=set(edge_ids.tolist()),
                edge_row=edge_row, nbrs=nbrs, cx=cx, cy=cy, types=types)


def _neighbor_fields(view, rows=None):
    """(valid_nb, ok, nb_ids, nb_rows) over the padded adjacency (optionally
    only ``rows`` of it): which neighbour slots hold a neighbour, whether
    that neighbour is a valid tracked row, its track id, and its row."""
    nbrs = view["nbrs"] if rows is None else view["nbrs"][rows]
    N = view["mask"].size
    valid_nb = nbrs > 0
    r = np.clip(nbrs.astype(np.int64) - 1, 0, N - 1)
    ok = valid_nb & (nbrs - 1 < N) & view["mask"][r]
    nb_ids = np.where(ok, view["ids"][r], 0)
    return valid_nb, ok, nb_ids, r


def _stable_rows(view, gone_arr: np.ndarray, edge_arr: np.ndarray) -> np.ndarray:
    """(N,) bool: all of each cell's neighbours are valid tracked cells that
    neither disappeared nor touch the border, in one pass over the padded
    adjacency."""
    valid_nb, ok, nb_ids, _ = _neighbor_fields(view)
    nb_gone = np.isin(nb_ids, gone_arr) & ok
    nb_edge = np.isin(nb_ids, edge_arr) & ok
    bad = valid_nb & (~ok | nb_gone | nb_edge)
    return ~bad.any(axis=1)


def _unique_id_rows(view) -> np.ndarray:
    """(N,) bool: this row's track id appears on exactly one valid row."""
    ids = view["ids"][view["mask"]]
    uniq, counts = np.unique(ids, return_counts=True)
    once = uniq[counts == 1]
    return view["mask"] & np.isin(view["ids"], once)


def _positive_mask_host(t: np.ndarray, type_index) -> np.ndarray:
    """Host twin of ``is_positive_for_type``, including the (pos_list,
    neg_list) tuple form."""
    if isinstance(type_index, tuple):
        pos_types, neg_types = type_index
        res = np.ones(np.shape(t), bool)
        for ti in pos_types:
            res &= _positive_mask_host(t, ti)
        for ti in neg_types:
            res &= ~_positive_mask_host(t, ti)
        return res
    if type_index < 0:
        return np.zeros(np.shape(t), bool)
    t = np.asarray(t).astype(np.uint8)
    bit = np.uint8(1 << type_index)
    return ((t & bit) == bit) & (t != 255)


def _hc_id_set(view, type_index) -> set:
    """Track ids of the cells positive for ``type_index``."""
    t = view["types"][view["mask"]].astype(np.uint8)
    return set(view["valid_ids"][_positive_mask_host(t, type_index)].tolist())


def find_events_iterator(tissue, initial_frame: int = 1, final_frame: int = -1,
                         differentiation_type_name: str = "",
                         differentiation_type_index: int = 0) -> Iterator[int]:
    """Automatic event detection over the tracked frames; yields each frame
    it finished."""
    if differentiation_type_name:
        index = tissue.type_name_to_index(differentiation_type_name)
        # a compound name resolves to a (pos_list, neg_list) tuple: keep it
        if isinstance(index, tuple) or (isinstance(index, int) and index >= 0):
            differentiation_type_index = index
    if final_frame == -1:
        final_frame = tissue.number_of_frames
    frame = initial_frame
    while (tissue.get_cells_info(frame) is None
           or tissue.get_labels(frame) is None):
        frame += 1
        if frame > final_frame:
            return
    prev = _frame_view(tissue, frame)
    prev_hc = _hc_id_set(prev, differentiation_type_index)
    skipped = 0
    for f in range(frame + 1, final_frame + 1):
        if not tissue.is_frame_valid(f) or tissue.get_cells_info(f) is None:
            skipped += 1
            continue
        cur = _frame_view(tissue, f)
        cur_hc = _hc_id_set(cur, differentiation_type_index)
        valid_window = [fr for fr in range(max(1, f - 5),
                                           min(tissue.number_of_frames, f + 5) + 1)
                        if tissue.is_frame_valid(fr)]
        start_frame = min(valid_window)
        end_frame = max(valid_window)
        if skipped < 3:
            # candidate gating is vectorised over the padded adjacency;
            # event EMISSION stays a loop (events are rare)
            gone_arr = np.setdiff1d(prev["valid_ids"], cur["valid_ids"])
            both_arr = np.intersect1d(prev["valid_ids"], cur["valid_ids"])
            prev_edge_arr = np.fromiter(prev["edge_ids"], dtype=np.int64,
                                        count=len(prev["edge_ids"]))
            cur_edge_arr = np.fromiter(cur["edge_ids"], dtype=np.int64,
                                       count=len(cur["edge_ids"]))
            stable = _stable_rows(prev, gone_arr, prev_edge_arr)
            unique_prev = _unique_id_rows(prev)
            # --- delaminations: id disappeared, off-edge, all neighbours stable
            delam = (unique_prev & stable
                     & np.isin(prev["ids"], gone_arr)
                     & ~np.isin(prev["ids"], prev_edge_arr))
            for cid in np.sort(prev["ids"][delam]):
                add_event(tissue, "delamination", start_frame, f,
                          start_cell_id=int(cid), source="automatic")
            # --- differentiations: newly HC-positive, present in both frames
            diff_ids = np.array(sorted((cur_hc - prev_hc)
                                       & set(both_arr.tolist())), dtype=np.int64)
            diffm = unique_prev & stable & np.isin(prev["ids"], diff_ids)
            for cid in np.sort(prev["ids"][diffm]):
                add_event(tissue, "differentiation", start_frame, end_frame,
                          start_cell_id=int(cid), source="automatic")
            # --- divisions: new id whose drift-corrected position falls in a
            # stable neighbour's previous-frame cell
            new_arr = np.setdiff1d(cur["valid_ids"], prev["valid_ids"])
            drift = tissue.drifts[f - 1]
            dx = drift[1] if np.isfinite(drift[1]) else 0.0
            dy = drift[0] if np.isfinite(drift[0]) else 0.0
            H, W = prev["labels"].shape
            cand = np.nonzero(_unique_id_rows(cur)
                              & np.isin(cur["ids"], new_arr)
                              & ~np.isin(cur["ids"], cur_edge_arr))[0]
            cand = cand[np.argsort(cur["ids"][cand], kind="stable")]
            if cand.size:
                px = np.round(cur["cx"][cand] + dx).astype(np.int64)
                py = np.round(cur["cy"][cand] + dy).astype(np.int64)
                inb = (px >= 0) & (px < W) & (py >= 0) & (py < H)
                cand, px, py = cand[inb], px[inb], py[inb]
            if cand.size:
                mother_label_prev = prev["labels"][py, px]          # (n,)
                valid_nb, ok, nb_ids, r = _neighbor_fields(cur, rows=cand)
                # ANY invalid neighbour kills the candidate
                alive = ~((valid_nb & ~ok).any(axis=1))
                considered = (ok & np.isin(nb_ids, both_arr)
                              & ~np.isin(nb_ids, cur_edge_arr))
                # the neighbour's CURRENT-frame centroid + frame drift
                # addresses the previous-frame label image, as for the
                # candidate itself
                nxs = np.round(cur["cx"][r] + dx).astype(np.int64)
                nys = np.round(cur["cy"][r] + dy).astype(np.int64)
                nin = considered & (nb_ids > 0) \
                    & (nxs >= 0) & (nxs < W) & (nys >= 0) & (nys < H)
                match = np.zeros_like(nin)
                match[nin] = (prev["labels"][nys[nin], nxs[nin]]
                              == np.broadcast_to(mother_label_prev[:, None],
                                                 nin.shape)[nin])
                match &= alive[:, None]
                has = match.any(axis=1)
                # the LAST matching neighbour in slot order is the mother
                last_slot = match.shape[1] - 1 - np.argmax(match[:, ::-1], axis=1)
                for i in np.nonzero(has)[0]:
                    cid = int(cur["ids"][cand[i]])
                    mother_id = int(nb_ids[i, last_slot[i]])
                    division_end = end_frame
                    pos = None
                    while pos is None and division_end >= start_frame:
                        if tissue.is_frame_valid(division_end):
                            pos = tissue.get_cell_centroid_by_id(division_end, cid)
                        if pos is None:
                            division_end -= 1
                    if pos is not None:
                        add_event(tissue, "division", start_frame, division_end,
                                  start_cell_id=mother_id, daughter_cell_id=cid,
                                  second_end_pos=pos, source="automatic")
        prev = cur
        prev_hc = cur_hc
        skipped = 0
        yield f


def fix_cell_types_after_tracking(tissue, window_size: int = 11,
                                  consistency_threshold: float = 0.5,
                                  min_frame_for_diff_detection: int = 10,
                                  min_frames_to_change_type: int = 3) -> int:
    """Majority-vote type repair over track time series: a moving-window
    vote per track, differentiation candidates from SC -> HC switches scored
    by before / after consistency, then every frame's types rewritten (on
    the table's own device)."""
    from scipy.ndimage import convolve1d

    KEEP, DIFF = -1, -2
    frames = [f for f in range(1, tissue.number_of_frames + 1)
              if tissue.is_frame_valid(f) and tissue.get_cells_info(f) is not None]
    if not frames:
        return 0
    host = {}
    for f in frames:
        t = tissue.get_cells_info(f)
        host[f] = to_host(t.valid_mask(), t.label, t.type)
    n_cells = 0
    for f in frames:
        m, lab, _ = host[f]
        ids = lab[m]
        if ids.size:
            n_cells = max(n_cells, int(ids.max()))
    T = len(frames)
    types_over_time = np.full((n_cells, T), KEEP, int)
    for j, f in enumerate(frames):
        m, lab, ty = host[f]
        ids = lab[m]
        ty = ty[m].astype(int)
        ok = (ids > 0) & (ids <= n_cells) & (ty != 255)
        types_over_time[ids[ok] - 1, j] = ty[ok]

    max_type = int(types_over_time.max()) + 1 if types_over_time.max() >= 0 else 1
    votes = [convolve1d((types_over_time == t).astype(int), np.ones(window_size),
                        axis=1, mode="nearest") for t in range(max_type)]
    invalid_vote = convolve1d((types_over_time == KEEP).astype(int),
                              np.ones(window_size), axis=1, mode="nearest")
    half = window_size // 2
    for v in votes:
        v[:, :half] = 0
        v[:, -half:] = 0
    result = np.argmax(np.dstack([invalid_vote] + votes), axis=2) - 1  # -1 = invalid

    # a differentiation candidate is a switch to a higher type (SC=0 -> HC=1)
    # between columns j and j+1
    diff_candidates = np.concatenate(
        [np.diff(result, axis=1) > 0, np.zeros((n_cells, 1), bool)], axis=1)
    # first / last settled (non-invalid) vote per track
    has_any = (result >= 0).any(axis=1)
    first_idx = np.argmax(result >= 0, axis=1)
    last_idx = result.shape[1] - 1 - np.argmax((result >= 0)[:, ::-1], axis=1)
    rows_idx = np.arange(n_cells)
    initial_types = np.where(has_any, result[rows_idx, first_idx], -1)
    final_types = np.where(has_any, result[rows_idx, last_idx], -1)
    valid_frames_for_cell = np.sum(result >= 0, axis=1)
    cum_sc = np.cumsum(result == initial_types[:, None], axis=1)
    cum_hc = np.fliplr(np.cumsum(np.fliplr(result == final_types[:, None]), axis=1))
    scores = np.zeros(diff_candidates.shape)
    scores[diff_candidates] = (cum_sc + cum_hc)[diff_candidates]
    max_scores = scores.max(axis=1) / np.maximum(valid_frames_for_cell, 1)
    diff_frames = np.argmax(scores, axis=1)
    is_diff = (max_scores > consistency_threshold) & \
              (valid_frames_for_cell > min_frame_for_diff_detection) & \
              (final_types > initial_types) & (initial_types >= 0)

    counts = np.stack([np.sum(result == t, axis=1) for t in range(max_type)], 1)
    new_types = np.argmax(counts, axis=1)
    new_types[counts.max(axis=1) < min_frames_to_change_type] = KEEP
    new_types[is_diff] = DIFF

    for j, f in enumerate(frames):
        t = tissue.get_cells_info(f)
        m, ids, ty = host[f]
        ty = ty.astype(int)
        tr = np.clip(ids - 1, 0, n_cells - 1)
        tracked = m & (ids > 0) & (ids <= n_cells)
        nt = new_types[tr]
        assign = np.where(nt == DIFF,
                          np.where(diff_frames[tr] >= j, initial_types[tr],
                                   final_types[tr]),
                          nt)
        upd = tracked & (assign >= 0)
        ty[upd] = assign[upd]
        tissue.set_cells_info(f, replace_fields(t, type=ty.astype(np.uint8)))
        tissue.update_cell_types_by_cells_info(f)
    return 0


def events_correlation_function(tissue, spatial_bin_size: int,
                                temporal_bin_size: int,
                                event_type: str = "all") -> np.ndarray:
    """Spatio-temporal pair correlation of the events with 1/(2 pi r) shell
    normalisation."""
    events = tissue.get_events()
    if event_type != "all":
        events = events.query(f'type == "{event_type}"')
    overall = tissue.calc_overall_drift()
    shape = None
    for f in range(1, tissue.number_of_frames + 1):
        if tissue.get_labels(f) is not None:
            shape = tissue.get_labels(f).shape
            break
    r_bins = (shape[1] if shape else 1024) // spatial_bin_size
    t_bins = max(tissue.number_of_frames // temporal_bin_size, 1)
    corr = np.zeros((t_bins, r_bins))
    rows = events.reset_index(drop=True)
    for i in range(len(rows)):
        for j in range(i, len(rows)):
            e1, e2 = rows.iloc[i], rows.iloc[j]
            x = (e1.start_pos_x + overall[int(e1.start_frame) - 1, 1]
                 - e2.start_pos_x - overall[int(e2.start_frame) - 1, 1])
            y = (e1.start_pos_y + overall[int(e1.start_frame) - 1, 0]
                 - e2.start_pos_y - overall[int(e2.start_frame) - 1, 0])
            r = int(np.sqrt(x * x + y * y) // spatial_bin_size)
            t = int(abs(e1.start_frame - e2.start_frame) // temporal_bin_size)
            while t >= corr.shape[0] or r >= corr.shape[1]:
                grown = np.zeros((corr.shape[0] * 2, corr.shape[1] * 2))
                grown[:corr.shape[0], :corr.shape[1]] = corr
                corr = grown
            corr[t, r] += 1
    dist = spatial_bin_size / 2
    for r in range(corr.shape[1]):
        corr[:, r] /= 2 * np.pi * dist
        dist += spatial_bin_size
    return corr / max(len(rows), 1)


def _n_neighbors_hist(tissue, frame: int, type_name: str = "HC"):
    from tissue_image_processing_tpu_torch.core import features as F
    table = tissue.get_cells_info(frame)
    mask = tissue.get_valid_non_edge_mask(frame)
    ti = tissue.type_name_to_index(type_name)
    ti = ti if isinstance(ti, (int, tuple)) and not isinstance(ti, bool) else 0
    sc = mask & ~_positive_mask_host(to_numpy(table.type), ti)
    nn = to_numpy(F.n_neighbors_from_type(table, ti, True))
    return table, sc, nn


def events_timing_by_n_neighbors(tissue, event_type: str, reference_frame: int,
                                 type_name: str = "HC"):
    """Event timing grouped by the initial number of HC neighbours."""
    table, sc_mask, nn = _n_neighbors_hist(tissue, reference_frame, type_name)
    ids = to_numpy(table.label)
    events = tissue.events.query(f'type == "{event_type}"')
    max_n = int(nn[sc_mask].max()) if sc_mask.any() else 0
    abundance = np.bincount(nn[sc_mask], minlength=max_n + 1)
    timing = [[] for _ in range(max_n + 1)]
    for _, ev in events.iterrows():
        rows = np.nonzero((ids == ev.cell_id) & sc_mask)[0]
        if rows.size:
            k = int(nn[rows[0]])
            if k <= max_n:
                timing[k].append(int(ev.significant_frame))
    return [t for t in timing if t], abundance


def events_rate_by_n_neighbors(tissue, event_type: str, reference_frame: int,
                               type_name: str = "HC"):
    """Kaplan-Meier event-rate estimator grouped by the number of HC
    neighbours."""
    table, sc_mask, nn = _n_neighbors_hist(tissue, reference_frame, type_name)
    ids = to_numpy(table.label)
    events = tissue.events.query(f'type == "{event_type}"').sort_values(
        "significant_frame")
    max_n = int(nn[sc_mask].max()) if sc_mask.any() else 0
    timing = [[] for _ in range(max_n + 1)]
    survival = [[] for _ in range(max_n + 1)]
    group_sizes = np.bincount(nn[sc_mask], minlength=max_n + 1).astype(float)
    for _, ev in events.iterrows():
        rows = np.nonzero((ids == ev.cell_id) & sc_mask)[0]
        if not rows.size:
            continue
        k = int(nn[rows[0]])
        if k > max_n:
            continue
        gs = group_sizes[k]
        timing[k].append(int(ev.significant_frame))
        survival[k].append(1 - 1 / gs if gs > 0 else 0.0)
        group_sizes[k] = max(gs - 1, 0)
    rates = {}
    out_t = []
    for k in range(max_n + 1):
        if timing[k]:
            rates[len(out_t)] = 1 - np.cumprod(np.array(survival[k]))
            out_t.append(np.array(timing[k]))
    return out_t, rates
