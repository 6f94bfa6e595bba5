"""PyTorch port vs the JAX package: editing, exports, overlays, plotting and
maintenance on ``Tissue`` sessions.

The cases of ``tests/test_editing_export.py`` and the ``Tissue`` cases of
``tests/test_plotting_misc.py`` run on twin sessions (the 64^2 grid tissue,
the port on the CPU) with the same edits, and every function of
``utils/maintenance.py`` on both. Exact: labels, track ids, tables, types,
the undo stack's restores (bit for bit at every depth), overlays and the
exported files' contents; figures are compared by the data they plot
(returned DataFrames and the axes' line data), float columns 1e-5.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from test_torch_tissue import (  # noqa: E402
    assert_same, assert_tables_equal, leaves, make_pair)
from tissue_image_processing_tpu.core import editing as JED  # noqa: E402
from tissue_image_processing_tpu.core import export as JX  # noqa: E402
from tissue_image_processing_tpu.core import plotting as JP  # noqa: E402
from tissue_image_processing_tpu.utils import maintenance as JM  # noqa: E402
from tissue_image_processing_tpu.viz import overlays as JV  # noqa: E402
from tissue_image_processing_tpu_torch.core import editing as TED  # noqa: E402
from tissue_image_processing_tpu_torch.core import export as TX  # noqa: E402
from tissue_image_processing_tpu_torch.core import plotting as TP  # noqa: E402
from tissue_image_processing_tpu_torch.utils import maintenance as TM  # noqa: E402
from tissue_image_processing_tpu_torch.viz import overlays as TV  # noqa: E402

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

RTOL = 1e-5


def typed_pair(T=1, track=False, cells=(15,)):
    """Twin grid sessions with ``cells`` HC-positive on every frame."""
    jt, tt = make_pair(T=T)
    for t in (jt, tt):
        if track:
            t.track_cells()
        t.type_names = ["HC"]
        for f in range(1, T + 1):
            lab = t.get_labels(f)
            marker = np.ones(lab.shape, np.float32)
            for c in cells:
                marker[lab == c] = 1000.0
            t.calc_cell_types(marker, f, "HC", threshold=0.3)
    assert_same(tt, jt)
    return jt, tt


def both(pair, fn):
    """``fn(tissue, package)`` on the JAX session then the port one; the
    sessions must stay equal. Returns the two results."""
    jt, tt = pair
    want = fn(jt, "jax")
    got = fn(tt, "port")
    assert_same(tt, jt)
    return want, got


def test_draw_line_matches_bresenham():
    """Exact: the pixel chains and disks of both packages."""
    for args in ((0, 0, 4, 9), (7, 3, -2, 1), (5, 5, 5, 5), (0, 9, 9, 0)):
        for a, b in zip(TED.draw_line(*args), JED.draw_line(*args)):
            np.testing.assert_array_equal(a, b)
    rr, cc = TED.draw_line(0, 0, 4, 9)
    assert len(rr) == 10 and rr[-1] == 4 and cc[-1] == 9
    for a, b in zip(TED.draw_disk((5.5, 4.0), 3.2, shape=(8, 8)),
                    JED.draw_disk((5.5, 4.0), 3.2, shape=(8, 8))):
        np.testing.assert_array_equal(a, b)


def test_find_nearest_segmentation_pixel():
    """Exact: the same nearest boundary pixel (or none) in both."""
    lab = np.ones((20, 20), np.int32)
    lab[10, 15] = 0
    for point, limit in (((14, 10), 5), ((2, 2), 3), ((3, 17), -1),
                         ((10, 10), -1)):
        got = TED.find_nearest_segmentation_pixel(lab, point, limit)
        assert got == JED.find_nearest_segmentation_pixel(lab, point, limit)
    assert TED.find_nearest_segmentation_pixel(lab, (14, 10), 5) == (15, 10)


def _split_15(editors, labels):
    ys, xs = np.nonzero(labels == 15)
    mid_y = (ys.min() + ys.max()) // 2

    def split(t, pkg):
        ed = editors[pkg]
        ed.add_segmentation_line(1, (xs.min(), mid_y), initial=True)
        ed.add_segmentation_line(1, (xs.max(), mid_y), point2=(xs.min(), mid_y))
        ed.add_segmentation_line(1, (xs.max(), mid_y), final=True)
    return split, ys, xs, mid_y


def test_add_segmentation_line_splits_cell():
    """Exact: the split cell's halves, the refreshed table and ids."""
    pair = make_pair(T=1)
    eds = {"jax": JED.SegmentationEditor(pair[0]),
           "port": TED.SegmentationEditor(pair[1])}
    n_before = int((pair[1].get_cells_info(1).empty_cell == 0).sum())
    split, ys, xs, _ = _split_15(eds, pair[1].get_labels(1))
    both(pair, split)
    lab2 = pair[1].get_labels(1)
    assert int((pair[1].get_cells_info(1).empty_cell == 0).sum()) == n_before + 1
    top, bottom = lab2[ys.min(), xs.min() + 2], lab2[ys.max(), xs.min() + 2]
    assert top != bottom and top > 0 and bottom > 0


def test_remove_segmentation_line_merges_cells():
    """Exact: the merged label map and table."""
    pair = make_pair(T=1)
    lab = pair[1].get_labels(1)
    ys, xs = np.nonzero(lab == 15)
    col, mid_y = xs.max() + 1, (ys.min() + ys.max()) // 2
    n_before = int((pair[1].get_cells_info(1).empty_cell == 0).sum())
    both(pair, lambda t, pkg: (TED if pkg == "port" else JED).SegmentationEditor(
        t).remove_segmentation_line(1, (col, mid_y)))
    assert int((pair[1].get_cells_info(1).empty_cell == 0).sum()) == n_before - 1
    assert pair[1].get_labels(1)[mid_y, col] > 0


def test_undo_roundtrip_bitexact():
    """Exact, bit for bit: add -> remove -> undo -> undo restores labels,
    table (ids, areas, types) and the types map at each depth, in both."""
    pair = typed_pair()
    jt, tt = pair
    eds = {"jax": JED.SegmentationEditor(jt), "port": TED.SegmentationEditor(tt)}
    labels_orig = tt.get_labels(1).copy()
    table_orig = leaves(tt.get_cells_info(1))
    types_orig = tt.get_cell_types(1).copy()
    split, ys, xs, _ = _split_15(eds, labels_orig)
    both(pair, split)
    labels_split = tt.get_labels(1).copy()
    table_split = leaves(tt.get_cells_info(1))
    assert (labels_split != labels_orig).any()
    both(pair, lambda t, pkg: eds[pkg].remove_segmentation_line(
        1, (xs.max() + 1, ys.min() + 1)))
    assert (tt.get_labels(1) != labels_split).any()
    assert both(pair, lambda t, pkg: eds[pkg].undo_last_action(1)) == (1, 1)
    np.testing.assert_array_equal(tt.get_labels(1), labels_split)
    assert_tables_equal(tt.get_cells_info(1), table_split)
    assert both(pair, lambda t, pkg: eds[pkg].undo_last_action(1)) == (1, 1)
    np.testing.assert_array_equal(tt.get_labels(1), labels_orig)
    assert_tables_equal(tt.get_cells_info(1), table_orig)
    np.testing.assert_array_equal(tt.get_cell_types(1), types_orig)
    assert both(pair, lambda t, pkg: eds[pkg].undo_last_action(1)) == (0, 0)


def test_undo_after_interrupted_line():
    """Exact: a half-drawn line sealed by the next action undoes in both."""
    pair = make_pair(T=1)
    eds = {"jax": JED.SegmentationEditor(pair[0]),
           "port": TED.SegmentationEditor(pair[1])}
    labels_orig = pair[1].get_labels(1).copy()
    ys, xs = np.nonzero(labels_orig == 15)
    mid_y = (ys.min() + ys.max()) // 2
    both(pair, lambda t, pkg: eds[pkg].add_segmentation_line(
        1, (xs.min() + 2, mid_y), initial=True))
    both(pair, lambda t, pkg: eds[pkg].remove_segmentation_line(
        1, (xs.max() + 1, mid_y)))
    assert both(pair, lambda t, pkg: eds[pkg].undo_last_action(1)) == (1, 1)
    assert both(pair, lambda t, pkg: eds[pkg].undo_last_action(1)) == (1, 1)
    np.testing.assert_array_equal(pair[1].get_labels(1), labels_orig)
    assert both(pair, lambda t, pkg: eds[pkg].undo_last_action(1)) == (0, 0)


def test_change_cell_type_and_invalid():
    """Exact: the toggled type bits and validity."""
    pair = make_pair(T=1)
    for t in pair:
        t.type_names = ["HC"]
    lab = pair[1].get_labels(1)
    ys, xs = np.nonzero(lab == 15)
    pos = (xs[0], ys[0])

    def editor(t, pkg):
        return (TED if pkg == "port" else JED).SegmentationEditor(t)

    both(pair, lambda t, pkg: editor(t, pkg).change_cell_type(1, pos, "HC"))
    assert int(pair[1].get_cells_info(1).type[14]) == 1
    both(pair, lambda t, pkg: editor(t, pkg).change_cell_type(1, pos, "SOX2"))
    assert int(pair[1].get_cells_info(1).type[14]) == 3
    both(pair, lambda t, pkg: editor(t, pkg).change_cell_type(1, pos, "HC"))
    both(pair, lambda t, pkg: editor(t, pkg).make_invalid_cell(1, pos))
    assert int(pair[1].get_cells_info(1).valid[14]) == 0
    both(pair, lambda t, pkg: editor(t, pkg).change_cell_type(1, (xs[0] + 11, ys[0]),
                                                              "invalid"))


def test_exports(tmp_path):
    """Exact: every exported array (matlab struct, both TIFFs, the npy
    bundle, the simulation bundle and its renamed table) equals the JAX
    package's."""
    from scipy.io import loadmat
    from tissue_image_processing_tpu_torch.io.tiff import read_tiff

    pair = typed_pair(T=2, track=True)
    outs = {}
    for t, X, pkg in ((pair[0], JX, "jax"), (pair[1], TX, "port")):
        d = tmp_path / pkg
        d.mkdir()
        X.export_segmentation_to_matlab(t, str(d), "seg")
        X.export_segmentation_to_tiff(t, str(d), "seg_t")
        X.export_segmentation_and_cell_types_to_tiff(t, str(d), "segty")
        X.export_segmentation_to_npy(t, str(d), "seg_n")
        t.data_path = os.path.join(str(d), "movie.tif")
        X.save_frame_data_for_simulation(t, 1, str(d))
        X.save_event_statistics_data(t, [1], str(d / "stats"))
        outs[pkg] = d
    j, p = outs["jax"], outs["port"]
    mj, mp = loadmat(str(j / "seg.mat")), loadmat(str(p / "seg.mat"))
    for k in ("frame1", "frame2", "valid_frames", "number_of_frames"):
        np.testing.assert_array_equal(mp[k], mj[k])
    assert mp["frame1"].max() > 0
    for name in ("seg_t.tif", "segty.tif"):
        np.testing.assert_array_equal(read_tiff(str(p / name))[0],
                                      read_tiff(str(j / name))[0])
    for name in ("seg_n.npy", "movie_labels_frame_1.npy",
                 "movie_contact_matrix_frame_1.npy"):
        np.testing.assert_array_equal(np.load(p / name), np.load(j / name))
    pd.testing.assert_frame_equal(pd.read_pickle(p / "movie_cells_info_frame_1"),
                                  pd.read_pickle(j / "movie_cells_info_frame_1"))
    assert sorted(os.listdir(p / "stats")) == sorted(os.listdir(j / "stats"))
    for name in os.listdir(j / "stats"):
        pd.testing.assert_frame_equal(pd.read_pickle(p / "stats" / name),
                                      pd.read_pickle(j / "stats" / name),
                                      rtol=RTOL)


def test_overlays():
    """Exact: every overlay of both packages."""
    pair = typed_pair(T=2, track=True)
    cx = int(pair[1].get_cells_info(1).cx[14])
    cy = int(pair[1].get_cells_info(1).cy[14])
    cid = int(pair[1].get_cells_info(1).label[14])
    both(pair, lambda t, pkg: t.add_event("ablation", 1, 2, start_pos=(cx, cy)))
    calls = [("draw_cell_types", (1, "HC")), ("draw_neighbors_connections", (1,)),
             ("draw_cell_tracking", (1, cid)), ("draw_cell_tracking", (1, 0)),
             ("draw_all_cell_tracking", (2,)), ("draw_events", (1,)),
             ("get_tracking_labels", (2,)),
             ("draw_marking_points", (1, [(5, 5), (40, 30)]))]
    for name, args in calls:
        got = getattr(TV, name)(pair[1], *args)
        want = getattr(JV, name)(pair[0], *args)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert np.asarray(got).sum() > 0, name


def test_frame_data_dispatch():
    """Exact / 1e-5: the dispatch cases of the JAX file's test."""
    from tissue_image_processing_tpu.core.frame_data import (
        get_frame_data as j_get)
    from tissue_image_processing_tpu_torch.core.frame_data import (
        get_frame_data as t_get)
    pair = typed_pair()
    mask = pair[1].get_valid_non_edge_mask(1)
    for feature in ["area", "roundness", "shape index", "HC neighbors",
                    "SC neighbors", "second neighbors", "contact length",
                    "HC contact length", "n_neighbors", "psi6", "density",
                    "type_fraction", "total_area", "number_of_cells",
                    "neighbors correlation", "neighbors by type"]:
        got, _ = t_get(pair[1], 1, feature, mask)
        want, _ = j_get(pair[0], 1, feature, mask)
        if isinstance(want, pd.DataFrame):
            pd.testing.assert_frame_equal(got, want, check_dtype=False)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=feature)
            assert len(np.atleast_1d(got)) in (1, mask.sum()), feature


@pytest.fixture
def tracked_pair():
    return typed_pair(T=4, track=True)


def _lines(ax):
    return [line.get_xydata() for line in ax.get_lines()]


def _plotted(fn):
    """(result, plotted line data) of ``fn(ax)`` on a fresh figure."""
    fig, ax = plt.subplots()
    try:
        res = fn(ax)
        return res, _lines(ax)
    finally:
        plt.close(fig)


def assert_same_plot(got, want):
    (gres, glines), (wres, wlines) = got, want
    if isinstance(wres, tuple):
        assert gres[1] == wres[1]
        gres, wres = gres[0], wres[0]
    if isinstance(wres, pd.DataFrame):
        pd.testing.assert_frame_equal(gres, wres, check_dtype=False, rtol=RTOL)
    else:
        np.testing.assert_allclose(gres, wres, rtol=RTOL)
    assert len(glines) == len(wlines)
    for g, w in zip(glines, wlines):
        np.testing.assert_allclose(g, w, rtol=RTOL)


def test_single_cell_data(tracked_pair):
    """The plotted time series of one cell, 1e-5."""
    jt, tt = tracked_pair
    cid = int(tt.get_cells_info(1).label[14])
    got = _plotted(lambda ax: TP.plot_single_cell_data(tt, cid, "area", ax))
    assert_same_plot(got, _plotted(
        lambda ax: JP.plot_single_cell_data(jt, cid, "area", ax)))
    assert len(got[0]) == 4 and (got[0]["area"] > 0).all()


def test_single_frame_plot(tracked_pair):
    """The scatter and histogram data, 1e-5."""
    jt, tt = tracked_pair
    for y in ("roundness", "histogram"):
        got = _plotted(lambda ax: TP.plot_single_frame_data(tt, 1, "area", y, ax))
        assert_same_plot(got, _plotted(
            lambda ax: JP.plot_single_frame_data(jt, 1, "area", y, ax)))
        assert len(got[0][0]) > 0


def test_compare_frames_plot(tracked_pair):
    """The per-frame means and errors, 1e-5."""
    jt, tt = tracked_pair
    got = _plotted(lambda ax: TP.plot_compare_frames_data(tt, [1, 2, 3], "area", ax))
    assert_same_plot(got, _plotted(
        lambda ax: JP.plot_compare_frames_data(jt, [1, 2, 3], "area", ax)))
    assert len(got[0][0]) == 3


def test_spatial_map_plot(tracked_pair):
    """The spatial map behind the image, 1e-5."""
    jt, tt = tracked_pair
    got = _plotted(lambda ax: TP.plot_spatial_map(tt, 1, "HC type_fraction",
                                                  20, 16, ax))
    assert_same_plot(got, _plotted(
        lambda ax: JP.plot_spatial_map(jt, 1, "HC type_fraction", 20, 16, ax)))
    assert got[0][0].shape == (64, 64)


def test_event_related_plot(tracked_pair):
    """The traces around an event, 1e-5."""
    jt, tt = tracked_pair
    cid = int(tt.get_cells_info(1).label[14])
    cx, cy = float(tt.get_cells_info(2).cx[14]), float(tt.get_cells_info(2).cy[14])
    both(tracked_pair, lambda t, pkg: t.add_event("ablation", 2, 3,
                                                  start_pos=(int(cx), int(cy))))
    got = _plotted(lambda ax: TP.plot_event_related_data(tt, cid, 2, "area", 2, ax))
    assert_same_plot(got, _plotted(
        lambda ax: JP.plot_event_related_data(jt, cid, 2, "area", 2, ax)))
    assert len(got[0]) > 0


def test_tissue_misc_api(tracked_pair):
    """Exact: names, the cell under a pixel, features, valid frames."""
    jt, tt = tracked_pair
    assert tt.get_cell_type_names() == jt.get_cell_type_names()
    got, want = tt.get_cell_by_pixel(5, 5, 1), jt.get_cell_by_pixel(5, 5, 1)
    assert got.keys() == want.keys() and got["area"] > 0
    for k in want:
        assert got[k] == want[k], k
    assert tt.get_cells_features(1) == jt.get_cells_features(1)
    assert tt.find_valid_frames(1, 10).tolist() == [1, 2, 3]
    assert tt.get_cells_number() == jt.get_cells_number()
    np.testing.assert_array_equal(tt.calc_overall_drift(), jt.calc_overall_drift())
    for t in tracked_pair:
        t.add_fake_type("SOX2", 1)
        t.set_validity_of_frame(3, False)
        t.shape_fitting_results[1]["circle"] = {"radius": (12.5, 0.25)}
    assert tt.get_cell_type_names() == jt.get_cell_type_names()
    assert tt.type_name_to_index("('HC-pos', 'SOX2-neg')") == \
        jt.type_name_to_index("('HC-pos', 'SOX2-neg')") == ([0], [1])
    assert tt.type_index_to_name(1) == jt.type_index_to_name(1) == "SOX2"
    assert tt.find_valid_frames(1, 10).tolist() == [1, 2]
    assert tt.get_number_of_valid_frames() == jt.get_number_of_valid_frames()
    np.testing.assert_array_equal(tt.get_segmentation(2), jt.get_segmentation(2))
    np.testing.assert_array_equal(tt.detect_edge_cells(2), jt.detect_edge_cells(2))
    assert tt.is_segmented(2) and tt.is_analyzed(2)
    from tissue_image_processing_tpu.core.frame_data import (
        get_frame_data as j_get)
    from tissue_image_processing_tpu_torch.core.frame_data import (
        get_frame_data as t_get)
    mask = tt.get_valid_non_edge_mask(2)
    assert t_get(tt, 2, "circle:radius", mask) == j_get(jt, 2, "circle:radius",
                                                        mask) == ((12.5, 0.25), "")
    assert t_get(tt, 2, "nothing", mask) == j_get(jt, 2, "nothing", mask)
    tt.reset_all_data(["a"])
    assert tt.get_labels(1) is None and tt.channel_names == ["a"]


def test_fix_cell_label_and_events(tracked_pair):
    """Exact: the retargeted ids and the event fix-ups."""
    jt, tt = tracked_pair
    labels = tt.get_labels(1)
    ys, xs = np.nonzero(labels == 15)
    both(tracked_pair, lambda t, pkg: t.fix_cell_label(1, (xs[0], ys[0]), 999))
    assert int(tt.get_cells_info(2).label[14]) == 999

    def fixups(t, pkg):
        t.add_event("delamination", 1, 2, start_pos=(int(xs[0]), int(ys[0])))
        t.fix_cell_pos_in_events()
        t.fix_cell_id_in_events()
        t.find_events_frame()
    both(tracked_pair, fixups)
    assert int(tt.events.iloc[-1].cell_id) == 999


@pytest.mark.parametrize("how", ["relink", "images", "positions"])
def test_fix_one_frame_tracking(tracked_pair, how):
    """Exact: the relinked ids after shuffling frames 3-4 (by centroids, by
    a clicked pair of positions, or with a local drift field of membrane
    images within 1e-4 px)."""
    jt, tt = tracked_pair
    for f in (3, 4):
        ids = leaves(jt.get_cells_info(f))["label"].copy()
        m = np.asarray(jt.get_cells_info(f).valid_mask())
        rows = np.nonzero(m)[0]
        ids[rows] = ids[np.roll(rows, 1)]
        jt.set_cells_info(f, dataclasses.replace(jt.get_cells_info(f),
                                                 label=jnp.asarray(ids)))
        tt.set_cells_info(f, dataclasses.replace(tt.get_cells_info(f),
                                                 label=torch.from_numpy(ids)))
    kw = {}
    if how == "images":
        rng = np.random.default_rng(2)
        kw = dict(images=np.stack([(jt.get_labels(f) == 0) * 300.0
                                   + rng.random((64, 64)) for f in range(1, 5)]
                                  ).astype(np.float32),
                  window_size=48, step_size=16)
    if how == "positions":
        kw = dict(start_frame_pos=(24, 44), end_frame_pos=(25, 44))
    both(tracked_pair, lambda t, pkg: t.fix_one_frame_tracking_using_local_drifts(
        2, 3, **kw))
    assert int(tt.get_cells_info(3).label[14]) == int(tt.get_cells_info(2).label[14])


def test_save_figure_with_data(tmp_path):
    """Exact: the saved data files of both packages."""
    fig, ax = plt.subplots()
    df = pd.DataFrame({"frame": [1, 2], "area": [10.0, 11.0]})
    ax.plot(df["frame"], df["area"])
    for data, fmt in ((df, "auto"), ({"k": 1}, "auto"), (df, "pickle"),
                      (np.arange(3.0), "pickle"), ({"k": 2}, "csv")):
        paths = [P.save_figure_with_data(fig, str(tmp_path / f"{name}.png"), data,
                                         fmt)
                 for P, name in ((JP, "j"), (TP, "t"))]
        assert os.path.basename(paths[1])[1:] == os.path.basename(paths[0])[1:]
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read(), paths
    plt.close(fig)


def _corrupt_ids(t, pkg):
    """Zero ids on frame 1 and duplicated ids on frame 2."""
    for f, fix in ((1, lambda ids: np.where(np.arange(ids.size) % 5 == 0, 0, ids)),
                   (2, lambda ids: np.where(np.arange(ids.size) % 7 == 3,
                                            ids[0], ids))):
        tab = t.get_cells_info(f)
        ids = fix(leaves(tab)["label"]).astype(np.int32)
        t.set_cells_info(f, dataclasses.replace(
            tab, label=jnp.asarray(ids) if pkg == "jax" else torch.from_numpy(ids)))


def _interior_pair(t, frame):
    """Rows of two neighbouring cells off the border (the Voronoi tissue's
    label map has no background band, so only their shared line is a
    candidate of the merge)."""
    tab = leaves(t.get_cells_info(frame))
    edge = set(t.detect_edge_cells(frame).tolist())
    for r in range(tab["label"].size):
        nbrs = [n - 1 for n in tab["neighbors"][r] if n > 0]
        if r not in edge and not edge & set(nbrs) and nbrs:
            return r, nbrs[0]
    raise AssertionError("no interior pair")


def _invalidate(t, pkg, frame, rows):
    tab = t.get_cells_info(frame)
    valid = leaves(tab)["valid"].copy()
    valid[list(rows)] = 0
    t.set_cells_info(frame, dataclasses.replace(
        tab, valid=jnp.asarray(valid) if pkg == "jax" else torch.from_numpy(valid)))
    t.update_cell_types_by_cells_info(frame)


MAINTENANCE = {
    "flip_frame_data": lambda M, t, pkg: M.flip_frame_data(t, 2),
    "flip_all_data": lambda M, t, pkg: (
        t.add_event("ablation", 1, 2, start_pos=(30, 20)), M.flip_all_data(t)),
    "fix_types_in_cell_info": lambda M, t, pkg: (
        t.set_cell_types(1, np.where(t.get_labels(1) == 22, 1,
                                     t.get_cell_types(1)).astype(np.uint8)),
        M.fix_types_in_cell_info(t)),
    "update_bounding_box_for_all_cells": lambda M, t, pkg:
        M.update_bounding_box_for_all_cells(t),
    "update_neighbors_for_all_cells": lambda M, t, pkg:
        M.update_neighbors_for_all_cells(t),
    "fix_zero_labeled_cells": lambda M, t, pkg: (
        _corrupt_ids(t, pkg), M.fix_zero_labeled_cells(t)),
    "fix_duplicated_labels": lambda M, t, pkg: (
        _corrupt_ids(t, pkg), M.fix_duplicated_label_cells_in_frame(t, 2),
        M.fix_duplicated_labels_in_all_frames(t)),
    "sensory_region": lambda M, t, pkg: (
        M.detect_non_sensory_region_cells(t, 1),
        M.remove_cells_outside_of_sensory_region(t, 1)),
    "merge_invalid_neighboring_cells": lambda M, t, pkg: (
        _invalidate(t, pkg, 2, _interior_pair(t, 2)),
        M.merge_invalid_neighboring_cells(t, 2)),
    "averages": lambda M, t, pkg: (
        M.calculate_average_area_in_movie(t),
        M.fix_mean_intensity(t, np.random.default_rng(5).random(
            (2, 2, 1, 64, 64)).astype(np.float32)),
        t.get_mean_intensity(1, "HC")),
}


@pytest.mark.parametrize("name", sorted(MAINTENANCE))
def test_maintenance_matches_jax(name):
    """Exact: each repair leaves both sessions equal; returned rows exact,
    average areas and mean intensities 1e-5."""
    if name == "merge_invalid_neighboring_cells":
        # a Voronoi tissue: the grid tissue's background band would be a
        # merge candidate in every round, up to the loop's cap
        from test_torch_features_events import tracked_pair as voronoi_pair
        pair = voronoi_pair(n_frames=2, size=128, n_cells=30, seed=8)
    else:
        pair = typed_pair(T=2, track=True, cells=(8, 9, 14, 15, 16, 20, 21, 22))
    for t in pair:
        t.channel_names = ["HC", "zo"]
    labels = pair[1].get_labels(2).copy()
    want, got = both(pair, lambda t, pkg: MAINTENANCE[name](
        TM if pkg == "port" else JM, t, pkg))
    if name == "merge_invalid_neighboring_cells":   # the pair merged
        assert (pair[1].get_labels(2) != labels).sum() > 3
    for g, w in zip(got or (), want or ()):
        if w is not None:
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(w, float),
                                       rtol=RTOL)
