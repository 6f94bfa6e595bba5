"""PyTorch port vs the JAX package: features, frame data and events.

Every function of ``core/features.py``, ``get_frame_data`` for every feature
name (one case a name list, each checking every name of its list) and
``get_event_statistics`` run on the same tables in both packages, the port
on the CPU; the fast cases of ``tests/test_events_scale.py``, the event
store helpers and ``fix_cell_types_after_tracking`` run on twin sessions
made by each package's ``make_tracked_tissue`` (held equal first). Exact:
labels, ids, tables, types, integer features and the event DataFrames
(after a stable sort by type, frame and cell id); 1e-5 relative (1e-6
absolute near zero): float features, correlations and spatial maps.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

from test_torch_tissue import assert_events_equal, assert_same, leaves
from tissue_image_processing_tpu.core import events as JE
from tissue_image_processing_tpu.core import features as JF
from tissue_image_processing_tpu.core import frame_data as JD
from tissue_image_processing_tpu.utils.synthetic import (
    make_tracked_tissue as j_make_tracked_tissue)
from tissue_image_processing_tpu_torch.core import events as TE
from tissue_image_processing_tpu_torch.core import features as TF
from tissue_image_processing_tpu_torch.core import frame_data as TD
from tissue_image_processing_tpu_torch.utils.synthetic import (
    make_tracked_tissue as t_make_tracked_tissue, voronoi_labels)

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
G = 11                       # grid side of the 120-cell tissues
CENTER = (G // 2) * G + G // 2


def tracked_pair(**kw):
    """The JAX and port ``make_tracked_tissue`` at the JAX tests' size
    (256^2, 120 cells), held equal."""
    kw = dict(dict(n_frames=6, size=256, n_cells=120), **kw)
    jt, jinfo = j_make_tracked_tissue(**kw)
    tt, tinfo = t_make_tracked_tissue(device="cpu", **kw)
    assert tinfo == jinfo
    assert_same(tt, jt)
    return jt, tt


@pytest.fixture(scope="module")
def typed_pair():
    """Twin sessions with HC types (a third of the cells), the mean-intensity
    cache of frame 2 and an ablation event at frame 2."""
    jt, tt = tracked_pair(seed=6, differentiate=[(i, 1) for i in range(0, 120, 3)])
    for t in (jt, tt):
        t.type_names = ["HC"]
        lab = t.get_labels(2)
        marker = np.ones(lab.shape, np.float32)
        ids = np.asarray(t.get_cells_info(2).type)
        for row in np.nonzero(ids == 1)[0]:
            marker[lab == row + 1] = 900.0 + row
        t.calc_cell_types(marker, 2, "HC", threshold=0.3)
        t.add_event("ablation", 2, 3, start_pos=(128, 128))
    assert_same(tt, jt)
    return jt, tt


def assert_close(got, want, what=""):
    """Exact for integers and booleans, 1e-5 for floats; lists, DataFrames
    and scalars element by element."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{what}[{i}]")
        return
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_dtype=False,
                                      rtol=RTOL, atol=ATOL, obj=what)
        return
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind == "f" or g.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def _frame2(pair):
    jt, tt = pair
    return jt.get_cells_info(2), tt.get_cells_info(2), jt


FEATURE_CASES = {
    "roundness": lambda F, t, a, c: F.roundness(t),
    "shape_index": lambda F, t, a, c: F.shape_index(t),
    "neighbors_adjacency": lambda F, t, a, c: F.neighbors_adjacency(t),
    "n_neighbors_from_type": lambda F, t, a, c: [
        F.n_neighbors_from_type(t, 0, True), F.n_neighbors_from_type(t, 0, False),
        F.n_neighbors_from_type(t, same_type=True),
        F.n_neighbors_from_type(t, same_type=True, positive_for_type=False),
        F.n_neighbors_from_type(t, ([0], [1]), True),
        F.n_neighbors_from_type(t, count_mode="all"),
        F.n_neighbors_from_type(t, count_mode="valid"),
        F.n_neighbors_from_type(t, count_mode="invalid")],
    "second_order_neighbors_from_type": lambda F, t, a, c: [
        F.second_order_neighbors_from_type(t, 0, True),
        F.second_order_neighbors_from_type(t, 0, False),
        F.second_order_neighbors_from_type(t, count_all=True)],
    "psi_n": lambda F, t, a, c: [F.psi_n(t, a(c["vor"]), 6),
                                 F.psi_n(t, t.neighbors, 4)],
    "total_area": lambda F, t, a, c: [F.total_area(t),
                                      F.total_area(t, a(c["mask"]))],
    "density": lambda F, t, a, c: [F.density(t, a(c["mask"])),
                                   F.density(t, a(c["mask"]), a(np.float32(5e4)))],
    "type_fraction": lambda F, t, a, c: [
        F.type_fraction(t, a(c["mask"])),
        F.type_fraction(t, a(c["mask"]), a(np.float32(40.0)))],
    "neighbors_correlation": lambda F, t, a, c: [
        F.neighbors_correlation(t, a(c["state"]), a(c["mask"]), "neighbors"),
        F.neighbors_correlation(t, a(c["state"]), a(c["mask"]),
                                "neighbors average")],
    "contact_lengths_by_type": lambda F, t, a, c: [
        F.contact_lengths_by_type(t, a(c["contact"]), 0, True),
        F.contact_lengths_by_type(t, a(c["contact"]), 0, False),
        F.contact_lengths_by_type(t, a(c["contact"]), all_types=True)],
    "distance_from_points": lambda F, t, a, c: F.distance_from_points(
        t, a(np.array([[128.0, 128.0], [40.0, 200.0]], np.float32))),
    "cells_inside_circle": lambda F, t, a, c: F.cells_inside_circle(
        t, (128.0, 100.0), 60.0),
    "spatial_map": lambda F, t, a, c: [
        F.spatial_map(t, (256, 256), 40.0, 16, a(c["state"]), a(c["mask"]),
                      feature=kind) for kind in ("mean", "density", "fraction")],
    "voronoi_neighbor_lists": lambda F, t, a, c: F.voronoi_neighbor_lists(
        t, c["mask"], max_neighbors=16),
}


@pytest.mark.parametrize("name", sorted(FEATURE_CASES))
def test_feature_functions_match_jax(typed_pair, name):
    """Exact for integer and boolean results, 1e-5 for float ones, every
    option of the function on frame 2 of the typed twin sessions."""
    jtab, ttab, jt = _frame2(typed_pair)
    mask = jt.get_valid_non_edge_mask(2)
    state = (np.asarray(jtab.type) == 1).astype(np.float32)
    ctx = dict(mask=mask, state=state,
               contact=jt.calc_neighbors_contact_matrix(2),
               vor=JF.voronoi_neighbor_lists(jtab, mask & (state > 0)))
    want = FEATURE_CASES[name](JF, jtab, jnp.asarray, ctx)
    got = FEATURE_CASES[name](TF, ttab, lambda x: torch.from_numpy(np.array(x)),
                              ctx)
    assert_close(got, want, name)


@pytest.mark.parametrize("names", ["COLUMN_FEATURES", "SPECIAL_FEATURES",
                                   "SPATIAL_FEATURES", "SPECIAL_X_ONLY_FEATURES",
                                   "GLOBAL_FEATURES"])
def test_get_frame_data_matches_jax(typed_pair, names):
    """Every feature name of the list on frame 2: per-cell arrays exact
    (integer) or 1e-5 (float), global scalars 1e-5, the 'neighbors by type'
    DataFrame likewise, the messages equal."""
    jt, tt = typed_pair
    assert getattr(TD, names) == getattr(JD, names)
    mask = jt.get_valid_non_edge_mask(2)
    for feature in getattr(JD, names):
        want, wmsg = JD.get_frame_data(jt, 2, feature, mask)
        got, gmsg = TD.get_frame_data(tt, 2, feature, mask)
        assert gmsg == wmsg, feature
        assert (got is None) == (want is None), feature
        if want is not None:
            assert type(got) is type(want) or np.isscalar(want), feature
            assert_close(got, want, feature)


@pytest.mark.parametrize("event_type", ["ablation", "overall reference HC",
                                        "overall reference SC"])
def test_get_event_statistics_matches_jax(typed_pair, event_type):
    """1e-5: the per-event and the reference-population tables."""
    jt, tt = typed_pair
    pairs = [("area", "roundness"), ("HC neighbors", None),
             ("Distance from ablation", None)]
    if "reference" not in event_type:   # no per-cell timing for a population
        pairs.append(("timing histogram", None))
    for x, y in pairs:
        want = JD.get_event_statistics(jt, event_type, x, y, frame=2)
        got = TD.get_event_statistics(tt, event_type, x, y, frame=2)
        assert (got is None) == (want is None), (event_type, x)
        if want is not None:
            assert_close(got, want, f"{event_type} {x}")


def _events(tissue, **kw):
    for _ in tissue.find_events_iterator(1, tissue.number_of_frames, **kw):
        pass
    return tissue.get_events()


def test_planted_events_detected():
    """Exact events: the planted delamination, division and differentiation
    of a 120-cell tissue are found with the right ids in both packages; a
    delamination beside border cells (seed 23, id 24) is not reported,
    its neighbourhood not being stable."""
    jt, tt = tracked_pair(seed=1, delaminate=[(CENTER, 4), (23, 3)],
                          divide=[(CENTER - 3, 4)],
                          differentiate=[(CENTER + 3, 4)])
    want, ev = _events(jt), _events(tt)
    assert_events_equal(ev, want)
    by_type = {t: set(ev.query(f'type == "{t}"').cell_id.astype(int))
               for t in ("delamination", "division", "differentiation")}
    assert CENTER + 1 in by_type["delamination"]
    assert 24 not in by_type["delamination"]
    assert CENTER - 3 + 1 in by_type["division"]
    assert CENTER + 3 + 1 in by_type["differentiation"]
    assert 121 in set(ev.query('type == "division"').daughter_id.astype(int))


def test_no_spurious_events_on_static_tissue():
    """Exact: a static tissue gives no event in either package."""
    jt, tt = tracked_pair(n_frames=4, seed=2)
    assert len(_events(jt)) == 0
    assert len(_events(tt)) == 0


def test_differentiation_compound_type_index():
    """Exact: a (pos_list, neg_list) type index."""
    jt, tt = tracked_pair(n_frames=4, seed=4, differentiate=[(CENTER, 3)])
    kw = dict(differentiation_type_index=([0], []))
    want, ev = _events(jt, **kw), _events(tt, **kw)
    assert_events_equal(ev, want)
    assert CENTER + 1 in set(ev.query('type == "differentiation"')
                             .cell_id.astype(int))


def test_differentiation_compound_type_name():
    """Exact: a compound type name keeps its (pos, neg) tuple."""
    jt, tt = tracked_pair(n_frames=4, seed=5, differentiate=[(CENTER, 3)])
    for t in (jt, tt):
        t.type_names = ["HC"]
    kw = dict(differentiation_type_name="('HC-pos',)")
    want, ev = _events(jt, **kw), _events(tt, **kw)
    assert_events_equal(ev, want)
    assert CENTER + 1 in set(ev.query('type == "differentiation"')
                             .cell_id.astype(int))


def test_voronoi_labels_match_jax():
    """Exact: the Voronoi label maps of both factories."""
    from tissue_image_processing_tpu.utils.synthetic import (
        voronoi_labels as j_voronoi_labels)
    pts = np.random.default_rng(3).uniform(0, 96, (40, 2))
    np.testing.assert_array_equal(voronoi_labels(96, pts),
                                  j_voronoi_labels(96, pts))


def test_fix_cell_types_after_tracking_matches_jax():
    """Exact: majority-vote repair of a flickering type on a tracked
    tissue; the types are written back on the port tables' device."""
    jt, tt = tracked_pair(n_frames=14, seed=7,
                          differentiate=[(CENTER, 8), (CENTER + 2, 1)])
    rng = np.random.default_rng(7)
    flicker = [(int(f), int(r)) for f, r in zip(rng.integers(1, 15, 30),
                                                rng.integers(0, 120, 30))]
    for t in (jt, tt):
        for f, row in flicker:   # one-frame type glitches
            tab = t.get_cells_info(f)
            types = leaves(tab)["type"].copy()
            types[row] ^= 1
            t.set_cells_info(f, dataclasses.replace(tab, type=(
                jnp.asarray(types) if t is jt else torch.from_numpy(types))))
        t.fix_cell_types_after_tracking(min_frame_for_diff_detection=5)
    assert_same(tt, jt)
    assert tt.get_cells_info(14).type.device.type == "cpu"


def test_event_store_helpers_match_jax():
    """Exact: add / delete events, their significant frames, the cell-id
    and position fix-ups, and the event statistics by neighbour count; the
    correlation function 1e-5."""
    jt, tt = tracked_pair(seed=1, delaminate=[(CENTER, 4)],
                          divide=[(CENTER - 3, 4)],
                          differentiate=[(CENTER + 3, 4), (CENTER - 20, 3)])
    results = []
    for t, E in ((jt, JE), (tt, TE)):
        t.type_names = ["HC"]
        _events(t)
        t.add_event("ablation", 2, 5, start_pos=(100, 120))
        t.add_event("division", 2, 4, start_cell_id=10, daughter_cell_id=30)
        t.add_event("delamination", 1, 3, start_cell_id=50)
        t.delete_event(1, (int(t.get_cells_info(1).cx[49]),
                           int(t.get_cells_info(1).cy[49])))
        t.find_events_frame()
        t.fix_cell_pos_in_events()
        t.fix_cell_id_in_events()
        t.split_into_promoted_and_normal_differentiation(60.0)
        results.append([
            E.events_correlation_function(t, 32, 2),
            E.events_correlation_function(t, 16, 1, "division"),
            E.events_timing_by_n_neighbors(t, "delamination", 1),
            E.events_rate_by_n_neighbors(t, "differentiation", 1)])
    assert_same(tt, jt)
    want, got = results
    for i in (0, 1):
        assert_close(got[i], want[i], f"correlation {i}")
    assert [list(x) for x in got[2][0]] == [list(x) for x in want[2][0]]
    assert_close(got[2][1], want[2][1], "abundance")
    assert_close(got[3][0], want[3][0], "rate timing")
    assert sorted(got[3][1]) == sorted(want[3][1])
    for k in want[3][1]:
        assert_close(got[3][1][k], want[3][1][k], f"rate {k}")
