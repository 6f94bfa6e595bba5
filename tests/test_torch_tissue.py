"""PyTorch port vs the JAX package: the ``Tissue`` session.

The cases of ``tests/test_tissue.py`` run on both packages from the same
inputs (the 64^2 grid tissue of that file), the port on the CPU, each port
session built from its JAX twin through ``utils/state.py:tissue_from_numpy``
and its own tables recomputed and held to the carried ones. Exact: labels,
track ids, tables, types and the event DataFrames (after a stable sort by
type, frame and cell id); 1e-5 relative: float features, mean intensities
and recoil speeds. A ``.seg`` archive written by either package loads in
the other with every artifact equal. One ``cuda``-marked case drives a
session fed by ``movie_pipeline`` on the card against the same steps on the
CPU; it skips without a card.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

from test_tissue import grid_labels, make_tissue
import tissue_image_processing_tpu.core.tissue as jtm
from tissue_image_processing_tpu.core import features as JF
from tissue_image_processing_tpu.core.cell_table import (
    CellTable as JCellTable, frame_cellinfo as j_frame_cellinfo)
from tissue_image_processing_tpu.core.tissue import Tissue as JTissue
import tissue_image_processing_tpu_torch.core.tissue as ttm
from tissue_image_processing_tpu_torch.core import features as TF
from tissue_image_processing_tpu_torch.core.cell_table import (
    CellTable, frame_cellinfo as t_frame_cellinfo)
from tissue_image_processing_tpu_torch.core.tissue import Tissue as TTissue
from tissue_image_processing_tpu_torch.utils.state import tissue_from_numpy

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

RTOL = 1e-5


def leaves(table):
    return None if table is None else {
        f.name: np.asarray(getattr(table, f.name))
        for f in dataclasses.fields(table)}


def jax_contents(jt):
    """(arrays, meta) of a JAX ``Tissue`` for ``tissue_from_numpy``."""
    T = jt.number_of_frames
    frames = range(1, T + 1)
    arrays = dict(labels=[jt.get_labels(f) for f in frames],
                  cell_types=[jt.get_cell_types(f) for f in frames],
                  tables=[leaves(jt.get_cells_info(f)) for f in frames],
                  drifts=jt.drifts, valid_frames=jt.valid_frames)
    meta = dict(number_of_frames=T, data_path=jt.data_path,
                capacity=jt.capacity, max_neighbors=jt.max_neighbors,
                min_cell_area=jt.min_cell_area, max_cell_area=jt.max_cell_area,
                type_names=jt.type_names, channel_names=jt.channel_names,
                fake_channels=jt.fake_channels, events=jt.events,
                shape_fitting_results=jt.shape_fitting_results)
    return arrays, meta


def twin(jt, recompute=True):
    """The port session of a JAX one, on the CPU; with ``recompute`` every
    table is also recomputed by the port and held to the carried one."""
    tt = tissue_from_numpy(*jax_contents(jt), device="cpu")
    if recompute:
        for f in range(1, jt.number_of_frames + 1):
            want = tt.get_cells_info(f)
            if want is None or tt.get_labels(f) is None:
                continue
            tt.calculate_frame_cellinfo(f)
            assert_tables_equal(tt.get_cells_info(f), leaves(want))
            tt.set_cells_info(f, want)
    return tt


def make_pair(T=4, **kw):
    """``test_tissue.make_tissue`` and its port twin."""
    jt = make_tissue(T=T, **kw)
    return jt, twin(jt)


def assert_tables_equal(got, want_leaves, what=""):
    for name, arr in want_leaves.items():
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(), arr,
                                      err_msg=f"{what} {name}")


def sorted_events(df):
    return df.sort_values(["type", "start_frame", "cell_id"],
                          kind="stable").reset_index(drop=True)


def assert_events_equal(got, want):
    pd.testing.assert_frame_equal(sorted_events(got), sorted_events(want),
                                  check_dtype=False)


def assert_same(tt, jt):
    """Every artifact of the port session equals the JAX one's, exactly."""
    assert tt.number_of_frames == jt.number_of_frames
    for f in range(1, jt.number_of_frames + 1):
        for get in ("get_labels", "get_cell_types"):
            a, b = getattr(tt, get)(f), getattr(jt, get)(f)
            assert (a is None) == (b is None), (get, f)
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{get}({f})")
        a, b = tt.get_cells_info(f), jt.get_cells_info(f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert_tables_equal(a, leaves(b), f"frame {f}")
    assert_events_equal(tt.get_events(), jt.get_events())
    np.testing.assert_array_equal(tt.drifts, jt.drifts)
    np.testing.assert_array_equal(tt.valid_frames, jt.valid_frames)
    assert tt.type_names == jt.type_names
    assert tt.channel_names == jt.channel_names
    assert tt.fake_channels == jt.fake_channels


def test_cellinfo_exact_fallback_on_adversarial_labels(monkeypatch):
    """Exact: alternating 1-px labels overflow the compacted adjacency's
    per-row vote budget; both packages detect it and give the exact
    neighbour graph."""
    lab = np.tile(np.arange(1, 33, dtype=np.int32), (256, 8))  # (256, 256)
    monkeypatch.setattr(jtm, "_NEIGHBOR_COMPACT_K", 8)
    monkeypatch.setattr(ttm, "_NEIGHBOR_COMPACT_K", 8)
    jt = JTissue(1, "adversarial", capacity=64)
    tt = TTissue(1, "adversarial", capacity=64, device="cpu")
    for t in (jt, tt):
        t.set_labels(1, lab)
        t.calculate_frame_cellinfo(1)
    want = leaves(j_frame_cellinfo(jnp.asarray(lab), capacity=64))
    assert_tables_equal(tt.get_cells_info(1), want)
    assert_tables_equal(t_frame_cellinfo(torch.from_numpy(lab), capacity=64),
                        want)


def _drift_images(jt):
    """Membrane-like frames of a session's labels: boundaries bright."""
    rng = np.random.default_rng(4)
    return np.stack([(jt.get_labels(f) == 0) * 500.0
                     + rng.random((64, 64)) * 10.0
                     for f in range(1, jt.number_of_frames + 1)]
                    ).astype(np.float32)


STAGE = pd.DataFrame({   # stage positions (um) and pixel sizes of 4 frames
    "y": [10.0, 10.2, 10.2, 10.5], "x": [5.0, 5.0, 4.9, 4.9],
    "physical_size_y": [0.1] * 4, "physical_size_x": [0.1] * 4})


@pytest.mark.parametrize("drifts", ["none", "images", "stage"])
def test_frame_analysis_and_tracking(drifts):
    """Exact ids and tables; with images, the drift chain (or, with a stage
    sidecar, the stage-prior refinement) within 1e-4 px, the ids still
    exact."""
    jt, tt = make_pair()
    kw = {} if drifts == "none" else {"images": _drift_images(jt)}
    if drifts == "stage":
        jt.stage_locations = tt.stage_locations = STAGE
    assert tt.track_cells(**kw) == jt.track_cells(**kw)
    np.testing.assert_allclose(tt.drifts, jt.drifts, atol=1e-4)
    tt.drifts = jt.drifts.copy()
    assert_same(tt, jt)
    if drifts == "stage":   # the priors say the stage moved; the frames did not
        return
    t1, t4 = tt.get_cells_info(1), tt.get_cells_info(4)
    assert set(t1.label[t1.valid_mask()].tolist()) == \
        set(t4.label[t4.valid_mask()].tolist())


@pytest.mark.parametrize("peak_window_size", [0, 5])
def test_cell_types_classification(peak_window_size):
    """Exact types, validity and painted map; mean intensities 1e-5."""
    jt, tt = make_pair(T=1)
    lab = jt.get_labels(1)
    marker = np.zeros(lab.shape, np.float32)
    hc_cells = [1, 6, 11, 16]
    for c in hc_cells:
        marker[lab == c] = 1000.0
    marker += np.random.default_rng(0).random(lab.shape).astype(np.float32)
    for t in (jt, tt):
        t.calc_cell_types(marker, 1, "HC", threshold=0.1,
                          peak_window_size=peak_window_size)
    assert_same(tt, jt)
    np.testing.assert_allclose(tt.get_mean_intensity(1, "HC"),
                               jt.get_mean_intensity(1, "HC"), rtol=RTOL)
    table = tt.get_cells_info(1)
    pos = (table.type == 1) & (table.empty_cell == 0)
    got_hc = set((torch.nonzero(pos).flatten() + 1).tolist())
    if peak_window_size == 0:
        assert got_hc == set(hc_cells)
    cm = tt.get_cell_types(1)
    assert (cm[lab == 0] == 255).all()


def test_event_detection_delamination():
    """Exact ids and events."""
    jt, tt = make_pair(T=5, delaminate=(15, 3))
    for t in (jt, tt):
        t.track_cells()
        t.find_events()
    assert_same(tt, jt)
    assert len(tt.get_events().query('type == "delamination"')) >= 1


def test_event_detection_division():
    """Exact ids and events."""
    jt, tt = make_pair(T=5, divide=(15, 3))
    for t in (jt, tt):
        t.track_cells()
        t.find_events()
    assert_same(tt, jt)
    divs = tt.get_events().query('type == "division"')
    assert len(divs) >= 1 and (divs.daughter_id > 0).all()


def test_event_detection_division_under_drift():
    """Exact events: the division under a 6 px/frame drift is assigned to
    the right mother by both packages."""
    T, shift = 5, 6
    sessions = (JTissue(T, "drift_division", channel_names=["zo"], capacity=64),
                TTissue(T, "drift_division", channel_names=["zo"], capacity=64,
                        device="cpu"))
    for f in range(1, T + 1):
        lab = grid_labels()
        if f >= 3:
            ys, _ = np.nonzero(lab == 15)
            mid = (ys.min() + ys.max()) // 2
            new = lab.max() + 1
            rows = np.arange(lab.shape[0])[:, None]
            lab[(lab == 15) & (rows > mid)] = new
            lab[(lab == 15) & (rows == mid)] = 0
        lab = np.roll(lab, (f - 1) * shift, axis=0)
        for t in sessions:
            t.set_labels(f, lab.copy())
            t.calculate_frame_cellinfo(f)
    for t in sessions:
        t.drifts[1:] = (-float(shift), 0.0)
        t.find_events()
    jt, tt = sessions
    assert_same(tt, jt)
    divs = tt.get_events().query('type == "division"')
    assert 37 in set(int(v) for v in divs.daughter_id.values)
    assert int(divs[divs.daughter_id == 37].iloc[0].cell_id) == 15


def test_event_detection_differentiation():
    """Exact types and events."""
    jt, tt = make_pair(T=6)
    for t in (jt, tt):
        t.track_cells()
        for f in range(1, 7):
            lab = t.get_labels(f)
            marker = np.ones(lab.shape, np.float32)
            if f >= 4:
                marker[lab == 15] = 1000.0
            marker[lab == 22] = 1000.0
            t.calc_cell_types(marker, f, "HC", threshold=0.3)
        t.find_events()
    assert_same(tt, jt)
    expected = int(tt.get_cells_info(3).label[14])
    assert expected in tt.get_events().query(
        'type == "differentiation"').cell_id.values


def test_fix_cell_types_after_tracking():
    """Exact repaired types (written back on the CPU tables)."""
    jt, tt = make_pair(T=30)
    for t in (jt, tt):
        t.track_cells()
        for f in range(1, 31):
            lab = t.get_labels(f)
            marker = np.ones(lab.shape, np.float32)
            marker[lab == 22] = 1000.0
            if f == 15:
                marker[lab == 2] = 1000.0
            if f >= 16:
                marker[lab == 15] = 1000.0
            t.calc_cell_types(marker, f, "HC", threshold=0.3)
        t.fix_cell_types_after_tracking(min_frame_for_diff_detection=5)
    assert_same(tt, jt)
    assert int(tt.get_cells_info(15).type[1]) == 0
    assert int(tt.get_cells_info(10).type[14]) == 0
    assert int(tt.get_cells_info(25).type[14]) == 1
    assert tt.get_cells_info(25).type.device.type == "cpu"


def _analysed_pair(tmp_path):
    jt, tt = make_pair(T=2)
    for t in (jt, tt):
        t.track_cells()
        lab = t.get_labels(1)
        marker = np.ones(lab.shape, np.float32)
        marker[lab == 15] = 1000.0
        t.calc_cell_types(marker, 1, "HC", threshold=0.3)
        t.drifts[1] = (1.5, -2.0)
        t.add_event("ablation", 1, 2, start_pos=(30, 30))
        t.shape_fitting_results[0]["circle"] = {"x_center": [1.0, 0.1]}
        t.add_fake_type("fake", 1)
    return jt, tt


def test_seg_save_load_roundtrip(tmp_path):
    """Exact: a port session saved and loaded by the port."""
    _, tt = _analysed_pair(tmp_path)
    path = os.path.join(tmp_path, "session.seg")
    for _ in tt.save(path):
        pass
    fresh = TTissue(2, os.path.join(tmp_path, "other"), capacity=64,
                    device="cpu")
    for _ in fresh.load(path):
        pass
    for f in (1, 2):
        np.testing.assert_array_equal(fresh.get_labels(f), tt.get_labels(f))
        np.testing.assert_array_equal(fresh.get_cell_types(f),
                                      tt.get_cell_types(f))
        assert_tables_equal(fresh.get_cells_info(f),
                            leaves(tt.get_cells_info(f)))
    np.testing.assert_array_equal(fresh.drifts, tt.drifts)
    assert fresh.type_names == ["HC", "fake"]
    assert fresh.shape_fitting_results == tt.shape_fitting_results
    assert_events_equal(fresh.get_events(), tt.get_events())
    tt.clean_up()
    fresh.clean_up()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_seg_crosses_between_packages(tmp_path, writer):
    """Exact: a .seg written by one package loads in the other with labels,
    type maps, tables, events, drifts, valid frames and names equal."""
    jt, tt = _analysed_pair(tmp_path)
    jt.set_validity_of_frame(2, False)
    tt.set_validity_of_frame(2, False)
    assert_same(tt, jt)
    src = jt if writer == "jax" else tt
    path = os.path.join(tmp_path, f"{writer}.seg")
    for _ in src.save(path):
        pass
    jl = JTissue(2, os.path.join(tmp_path, "j"), capacity=64)
    tl = TTissue(2, os.path.join(tmp_path, "t"), capacity=64, device="cpu")
    for t in (jl, tl):
        for _ in t.load(path):
            pass
    assert_same(tl, jt)
    assert_same(tt, jl)
    assert tl.shape_fitting_results == jl.shape_fitting_results
    for t in (jt, tt, jl, tl):
        t.clean_up()


def test_features_basic():
    """Exact integer features; float features 1e-5."""
    jt, tt = make_pair(T=1)
    jtab, ttab = jt.get_cells_info(1), tt.get_cells_info(1)
    np.testing.assert_allclose(TF.roundness(ttab).numpy(),
                               np.asarray(JF.roundness(jtab)), rtol=RTOL)
    np.testing.assert_allclose(TF.shape_index(ttab).numpy(),
                               np.asarray(JF.shape_index(jtab)), rtol=RTOL)
    exists = np.asarray(jtab.empty_cell) == 0
    for fn in ("total_area", "density"):
        np.testing.assert_allclose(
            float(getattr(TF, fn)(ttab, torch.from_numpy(exists))),
            float(getattr(JF, fn)(jtab, jnp.asarray(exists))), rtol=RTOL)
    types = np.zeros(64, np.uint8)
    types[::2] = 1
    jt2 = dataclasses.replace(jtab, type=jnp.asarray(types))
    tt2 = dataclasses.replace(ttab, type=torch.from_numpy(types))
    np.testing.assert_array_equal(TF.n_neighbors_from_type(tt2, 0, True).numpy(),
                                  np.asarray(JF.n_neighbors_from_type(jt2, 0, True)))
    state = (types == 1).astype(np.float32)
    np.testing.assert_allclose(
        float(TF.neighbors_correlation(tt2, torch.from_numpy(state),
                                       torch.from_numpy(exists))),
        float(JF.neighbors_correlation(jt2, jnp.asarray(state),
                                       jnp.asarray(exists))), rtol=RTOL)


def test_features_psi6_hex():
    """1e-5: a perfect hexagon around a centre cell gives psi6 ~ 1 in both."""
    angles = np.arange(6) * np.pi / 3
    cx = np.zeros(8, np.float32)
    cy = np.zeros(8, np.float32)
    cx[1:7] = 10 * np.cos(angles)
    cy[1:7] = 10 * np.sin(angles)
    nbr = np.zeros((8, 8), np.int32)
    nbr[0, :6] = np.arange(2, 8)
    ttab = dataclasses.replace(CellTable.empty(8, 8, device="cpu"),
                               cx=torch.from_numpy(cx), cy=torch.from_numpy(cy),
                               neighbors=torch.from_numpy(nbr))
    jtab = JCellTable(**{k: jnp.asarray(v) for k, v in leaves(ttab).items()})
    got = TF.psi_n(ttab, ttab.neighbors, 6).numpy()
    np.testing.assert_allclose(got, np.asarray(JF.psi_n(jtab, jtab.neighbors, 6)),
                               rtol=RTOL, atol=1e-6)
    assert abs(got[0] - 1.0) < 1e-4


def test_spatial_map():
    """1e-5: the windowed mean map."""
    jt, tt = make_pair(T=1)
    jtab, ttab = jt.get_cells_info(1), tt.get_cells_info(1)
    exists = np.asarray(jtab.empty_cell) == 0
    vals = exists.astype(np.float32)
    want = np.asarray(JF.spatial_map(jtab, (64, 64), 20.0, 16, jnp.asarray(vals),
                                     jnp.asarray(exists), feature="mean"))
    got = TF.spatial_map(ttab, (64, 64), 20.0, 16, torch.from_numpy(vals),
                         torch.from_numpy(exists), feature="mean").numpy()
    assert got.shape == (64, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_stage_shift_chain_mapping(tmp_path):
    """Exact: the stage sidecar's shifts."""
    loc = pd.DataFrame({
        "z": [0.0, 0.0, 0.0], "y": [10.0, 12.0, 12.0], "x": [5.0, 5.0, 4.0],
        "physical_size_z": [1.0] * 3, "physical_size_y": [0.1] * 3,
        "physical_size_x": [0.1] * 3})
    path = os.path.join(str(tmp_path), "movie.tif")
    jt = JTissue(3, path, capacity=8)
    tt = TTissue(3, path, capacity=8, device="cpu")
    for t in (jt, tt):
        t.stage_locations = loc
    got = tt.stage_shift_chain(1, 3)
    np.testing.assert_array_equal(got, jt.stage_shift_chain(1, 3))
    assert np.allclose(got[1], [20.0, 0.0]) and np.allclose(got[2], [0.0, -10.0])


def test_out_of_core_swap_keeps_one_frame(tmp_path):
    """Exact: random-access reads of a swap-mode session give the frames
    back bit for bit with at most one frame of each artifact in RAM."""
    T = 12
    t = TTissue(T, os.path.join(str(tmp_path), "ooc.tif"), channel_names=["zo"],
                capacity=64, use_working_dir=True, device="cpu")
    rng = np.random.default_rng(0)
    frames = {}
    for f in range(1, T + 1):
        lab = rng.integers(0, 50, (256, 256)).astype(np.int32)
        frames[f] = lab
        t.set_labels(f, lab)
        assert sum(x is not None for x in t._labels) <= 1
    for f in rng.permutation(np.arange(1, T + 1))[:6]:
        np.testing.assert_array_equal(t.get_labels(int(f)), frames[int(f)])
        assert sum(x is not None for x in t._labels) <= 1
    want = leaves(j_frame_cellinfo(jnp.asarray(frames[3]), capacity=64))
    t.set_cells_info(3, t_frame_cellinfo(torch.from_numpy(frames[3]), capacity=64))
    t.set_cell_types(5, np.zeros((256, 256), np.uint8))
    t.set_cells_info(4, None)   # swaps frame 3's table out to disk
    assert_tables_equal(t.get_cells_info(3), want)
    assert t.get_cells_info(4) is None
    assert t.get_cell_types(5) is not None
    assert sum(x is not None for x in t._tables) <= 1
    t.clean_up()


def test_out_of_core_save_load_roundtrip(tmp_path):
    """Exact: swap-mode save in one package, swap-mode load in the other."""
    T = 4
    rng = np.random.default_rng(1)
    labs = {f: rng.integers(0, 20, (64, 64)).astype(np.int32)
            for f in range(1, T + 1)}
    t = TTissue(T, os.path.join(str(tmp_path), "oocrt.tif"), channel_names=["zo"],
                capacity=32, use_working_dir=True, device="cpu")
    for f, lab in labs.items():
        t.set_labels(f, lab)
    seg = os.path.join(str(tmp_path), "session.seg")
    for _ in t.save(seg):
        pass
    fresh = JTissue(T, os.path.join(str(tmp_path), "oocrt2.tif"),
                    channel_names=["zo"], capacity=32, use_working_dir=True)
    back = TTissue(T, os.path.join(str(tmp_path), "oocrt3.tif"),
                   channel_names=["zo"], capacity=32, use_working_dir=True,
                   device="cpu")
    for s in (fresh, back):
        for _ in s.load(seg):
            pass
    for f, lab in labs.items():
        np.testing.assert_array_equal(fresh.get_labels(f), lab)
        np.testing.assert_array_equal(back.get_labels(f), lab)
        assert sum(x is not None for x in back._labels) <= 1
    for s in (t, fresh, back):
        s.clean_up()


def test_legacy_types_map_migration(tmp_path):
    """Exact: a legacy archive (no format marker) migrates its pre-bitmask
    types maps once at load, in both packages alike."""
    import zipfile

    legacy_dir = tmp_path / "legacy_wd"
    legacy_dir.mkdir()
    old = np.array([[0, 1], [2, 1]], np.uint8)
    np.save(legacy_dir / "frame_1_types.npy", old)
    seg = tmp_path / "legacy.seg"
    with zipfile.ZipFile(seg, "w") as z:
        z.write(legacy_dir / "frame_1_types.npy", "frame_1_types.npy")
    path = os.path.join(str(tmp_path), "legacy.tif")
    jt = JTissue(1, path, capacity=8, use_working_dir=True)
    tt = TTissue(1, path, capacity=8, use_working_dir=True, device="cpu")
    for t in (jt, tt):
        for _ in t.load(str(seg)):
            pass
    np.testing.assert_array_equal(tt.get_cell_types(1),
                                  np.array([[255, 1], [0, 1]], np.uint8))
    np.testing.assert_array_equal(tt.get_cell_types(1), jt.get_cell_types(1))
    jt.clean_up()
    tt.clean_up()


def test_new_format_types_map_not_remigrated(tmp_path):
    """Exact: a new-format types map with values in {0, 1, 2} survives the
    swap round trip and a save in the port + load in the JAX package."""
    t = TTissue(2, os.path.join(str(tmp_path), "new.tif"), capacity=8,
                use_working_dir=True, device="cpu")
    tm = np.array([[0, 1], [2, 1]], np.uint8)
    t.set_cell_types(1, tm.copy())
    t.set_cell_types(2, np.zeros((2, 2), np.uint8))  # swaps frame 1 out
    np.testing.assert_array_equal(t.get_cell_types(1), tm)
    seg = str(tmp_path / "own.seg")
    for _ in t.save(seg):
        pass
    j2 = JTissue(2, os.path.join(str(tmp_path), "new.tif"), capacity=8,
                 use_working_dir=True)
    for _ in j2.load(seg):
        pass
    np.testing.assert_array_equal(j2.get_cell_types(1), tm)
    t.clean_up()
    j2.clean_up()


def test_legacy_h5_neighbor_string_parsing(monkeypatch):
    """Exact: the h5-era string-encoded neighbour sets parse alike
    (``pd.read_hdf`` stubbed)."""
    fixture = pd.DataFrame({
        "neighbors": ["set()", "{np.int64(3), np.int64(7)}", "{1, 2}", {4}],
        "type": [0, 1, 0, 1],
    })
    monkeypatch.setattr(pd, "read_hdf", lambda path, key: fixture.copy())
    got = TTissue._read_legacy_h5("whatever.h5")
    assert got["neighbors"].tolist() == [set(), {3, 7}, {1, 2}, {4}]
    pd.testing.assert_frame_equal(got, JTissue._read_legacy_h5("whatever.h5"))


def test_recoil_speed_from_circular_ablation(tmp_path):
    """1e-5: the rim cells' recoil (2 px outward plus a rigid drift) in both
    packages; the rows and ids exact."""
    jt, tt = make_pair(T=2)
    for t in (jt, tt):
        t.track_cells()
    t2 = jt.get_cells_info(2)
    cx = np.asarray(t2.cx, float).copy()
    cy = np.asarray(t2.cy, float).copy()
    xc = yc = 32.0
    d = np.hypot(cx - xc, cy - yc)
    dd = d.copy()
    dd[np.asarray(t2.valid) == 0] = 1e9
    valid = np.asarray(t2.valid).copy()
    valid[int(dd.argmin())] = 0
    ux = (cx - xc) / np.maximum(d, 1e-9)
    uy = (cy - yc) / np.maximum(d, 1e-9)
    new = dict(cx=(cx + 2 * ux + 1.0).astype(np.float32),
               cy=(cy + 2 * uy - 1.0).astype(np.float32),
               valid=valid.astype(np.int32))
    jt.set_cells_info(2, dataclasses.replace(
        t2, **{k: jnp.asarray(v) for k, v in new.items()}))
    tt.set_cells_info(2, dataclasses.replace(
        tt.get_cells_info(2), **{k: torch.from_numpy(v) for k, v in new.items()}))
    outs = []
    for name, t in (("j", jt), ("t", tt)):
        t.shape_fitting_results[1]["circle"] = {
            "x_center": (xc, 0.0), "y_center": (yc, 0.0), "radius": (25.0, 0.0)}
        outs.append(t.calc_recoil_speed_from_circular_ablation(
            "circle", 1, 2, save_path=str(tmp_path / f"recoil_{name}.pkl")))
        with pytest.raises(KeyError):
            t.calc_recoil_speed_from_circular_ablation("ellipse", 1, 2,
                                                       save_path="")
    want, got = outs
    assert len(got) > 0 and (got["radial_movement"] < -1.0).all()
    for col in want.columns:
        if want[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], want[col], rtol=RTOL, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[col], want[col])
    pd.testing.assert_frame_equal(pd.read_pickle(tmp_path / "recoil_t.pkl"), got)


def test_orphan_scratch_dirs_swept(tmp_path):
    """Exact: dead-owner scratch dirs are swept, live-owned and marker-less
    ones kept, the new dir beside the data with our pid."""
    data = tmp_path / "movie.npy"
    data.write_bytes(b"")
    dead = tmp_path / "movie.npy_temp_dead"
    dead.mkdir()
    (dead / ttm._PID_MARKER).write_text("999999999")
    live = tmp_path / "movie.npy_temp_live"
    live.mkdir()
    (live / ttm._PID_MARKER).write_text(str(os.getpid()))
    foreign = tmp_path / "movie.npy_temp_foreign"
    foreign.mkdir()
    wd = ttm.get_temp_directory(str(data))
    assert not dead.exists()
    assert live.exists() and foreign.exists()
    assert os.path.dirname(wd) == str(tmp_path)
    assert ttm._PID_MARKER == jtm._PID_MARKER
    assert (tmp_path / os.path.basename(wd) / ttm._PID_MARKER).read_text() == \
        str(os.getpid())


def test_pid_marker_not_archived(tmp_path):
    """Exact: the pid marker stays out of the archive."""
    import zipfile

    d = tmp_path / "wd"
    d.mkdir()
    (d / "frame_1_labels.npy").write_bytes(b"x")
    (d / ttm._PID_MARKER).write_text("123")
    zp = str(tmp_path / "out.seg")
    for _ in ttm.pack_archive_with_progress(str(d), zp):
        pass
    out = tmp_path / "out"
    assert list(ttm.unpack_archive_with_progress(zp, str(out))) == [0.0]
    assert sorted(os.listdir(out)) == ["frame_1_labels.npy"]


def test_session_entry_points_resolve_to_the_card():
    """The session's entry points take ``device=None`` as the card: without
    one they raise instead of running on the CPU."""
    from tissue_image_processing_tpu_torch.utils.synthetic import (
        make_tracked_tissue)
    if torch.cuda.is_available():
        assert TTissue(1, "x", capacity=8).device.type == "cuda"
        return
    jt = make_tissue(T=1)
    for make in (lambda: TTissue(1, "x", capacity=8),
                 lambda: tissue_from_numpy(*jax_contents(jt)),
                 lambda: make_tracked_tissue(n_frames=1, size=32, n_cells=4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.cuda
def test_pipeline_fed_tissue_card_matches_cpu(tmp_path):
    """Exact: a session populated from ``movie_pipeline`` on the card (one
    stacked read-back, then set_labels, apply_track_ids and the drifts)
    equals the same steps on the CPU: cell types (with and without the
    peak gate), their repair, events, contact matrices and features; float
    features 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tissue_image_processing_tpu_torch.core.frame_data import (
        COLUMN_FEATURES, get_frame_data)
    from tissue_image_processing_tpu_torch.core.pipeline import (
        _projections, movie_pipeline)
    from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

    movie = make_movie(T=4, Z=1, H=256, W=256, seed=1).astype(np.uint16)
    out = movie_pipeline(movie, batch=2, capacity=256, block_size=51, std=3.0)
    markers = _projections(movie, 0, torch.device("cuda"), keep=[1])[
        :, 0].transpose(1, 2).cpu().numpy()
    labels = out["labels"].cpu().numpy()
    host = out["tables"].map(lambda t: t.cpu())
    sessions = []
    for device in ("cuda", "cpu"):
        t = TTissue(4, str(tmp_path / device), capacity=256, device=device)
        for f in range(1, 5):
            t.set_labels(f, labels[f - 1], reset_data=True)
            t.apply_track_ids(f, host.map(lambda x: x[f - 1].to(device)),
                              out["ids"][f - 1],
                              host.valid_mask()[f - 1].numpy())
        t.drifts[:] = out["drifts"]
        for f in range(1, 5):
            t.calc_cell_types(markers[f - 1], f, "HC", threshold=0.3)
        t.calc_cell_types(markers[0], 1, "HCpeak", threshold=0.3,
                          peak_window_size=5)
        t.fix_cell_types_after_tracking(min_frame_for_diff_detection=1)
        t.find_events()
        sessions.append(t)
    card, cpu = sessions
    for f in range(1, 5):
        np.testing.assert_array_equal(card.get_cell_types(f), cpu.get_cell_types(f))
        assert_tables_equal(card.get_cells_info(f), leaves(cpu.get_cells_info(f)))
        np.testing.assert_array_equal(card.calc_neighbors_contact_matrix(f),
                                      cpu.calc_neighbors_contact_matrix(f))
    assert_events_equal(card.get_events(), cpu.get_events())
    mask = cpu.get_valid_non_edge_mask(2)
    for name in COLUMN_FEATURES + ["roundness", "HC second neighbors",
                                   "contact length", "psi6"]:
        a, _ = get_frame_data(card, 2, name, mask)
        b, _ = get_frame_data(cpu, 2, name, mask)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6, err_msg=name)
