"""The port's ``TissueViewer`` (``viz/napari_viewer.py``) driven end to end
against a stubbed napari: the seven cases of ``tests/test_napari_viewer.py``
on the port. Each click mode (add line / remove line / change type / mark
event) must change labels, tables and events exactly as the direct
``SegmentationEditor`` / ``add_event`` calls do; ``undo`` restores the
labels bit for bit; ``cli view`` opens the viewer and saves the session.
Sessions compute on the CPU (``device="cpu"``). One more case holds the
layers the port builds to the JAX package's for the same session (exact).
"""

import os
import sys
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tissue_image_processing_tpu.core.cell_table import (
    frame_cellinfo as j_frame_cellinfo)
from tissue_image_processing_tpu.core.tissue import Tissue as JTissue
from tissue_image_processing_tpu.viz import napari_viewer as jviewer
from tissue_image_processing_tpu_torch.core.cell_table import frame_cellinfo
from tissue_image_processing_tpu_torch.core.editing import SegmentationEditor
from tissue_image_processing_tpu_torch.core.tissue import Tissue
from tissue_image_processing_tpu_torch.viz import napari_viewer as tviewer

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)


class _FakeLayerList(list):
    def __contains__(self, name):
        return any(layer.name == name for layer in self)

    def remove(self, name):
        for layer in list(self):
            if layer.name == name:
                super().remove(layer)


class _FakeLayer:
    def __init__(self, data, name, **kwargs):
        self.data = data
        self.name = name
        self.kwargs = kwargs


class _FakeViewer:
    def __init__(self, title=""):
        self.title = title
        self.layers = _FakeLayerList()
        self.mouse_drag_callbacks = []

    def _add(self, data, name=None, **kwargs):
        self.layers.append(_FakeLayer(data, name, **kwargs))

    add_image = add_labels = add_points = _add


class _FakeEvent:
    def __init__(self, y, x):
        self.type = "mouse_press"
        self.position = (float(y), float(x))


@pytest.fixture
def fake_napari(monkeypatch):
    mod = types.ModuleType("napari")
    mod.Viewer = _FakeViewer
    monkeypatch.setitem(sys.modules, "napari", mod)
    return mod


def two_cell_labels():
    labels = np.zeros((64, 64), np.int32)
    labels[:, :31] = 1
    labels[:, 32:] = 2
    labels[:, 31] = 0  # 1-px watershed line between the two cells
    return labels


def _two_cell_tissue(tmp_path, tag):
    t = Tissue(1, os.path.join(str(tmp_path), f"{tag}.tif"),
               channel_names=["zo"], capacity=32, device="cpu")
    labels = two_cell_labels()
    t.set_labels(1, labels)
    t.set_cells_info(1, frame_cellinfo(torch.from_numpy(labels), capacity=32))
    t.set_cell_types(1, np.zeros((64, 64), np.uint8))
    return t


def _make_viewer(t):
    img = np.zeros((1, 1, 64, 64), np.float32)
    return tviewer.TissueViewer(t, images=img, frame=1)


def _click(v, y, x):
    """Drive the viewer through its registered napari mouse callback."""
    assert len(v.viewer.mouse_drag_callbacks) == 1
    v.viewer.mouse_drag_callbacks[0](v.viewer, _FakeEvent(y, x))


def test_cli_view_opens_viewer_and_saves(fake_napari, tmp_path):
    """``cli view`` builds the layers over the session and saves on close."""
    from tissue_image_processing_tpu_torch.cli import main

    fake_napari.run = lambda: None  # headless: the "window" closes at once
    mp = os.path.join(str(tmp_path), "m.npy")
    np.save(mp, np.zeros((2, 1, 1, 64, 64), np.float32))
    session = os.path.join(str(tmp_path), "v.seg")
    t = _two_cell_tissue(tmp_path, "cliview")
    for _ in t.save(session):
        pass
    mtime = os.path.getmtime(session)
    os.utime(session, (mtime - 10, mtime - 10))
    assert main(["view", mp, "--session", session, "--capacity", "32",
                 "--frame", "1", "--mode", "change_type"], device="cpu") == 0
    assert os.path.getmtime(session) > mtime - 10
    back = Tissue(2, "back", capacity=32, device="cpu")
    for _ in back.load(session):
        pass
    np.testing.assert_array_equal(back.get_labels(1), two_cell_labels())


def test_viewer_builds_layers(fake_napari, tmp_path):
    v = _make_viewer(_two_cell_tissue(tmp_path, "a"))
    names = [layer.name for layer in v.viewer.layers]
    assert "segmentation" in names and "cell types" in names and "zo" in names
    assert all(isinstance(layer.data, np.ndarray) for layer in v.viewer.layers)


def test_add_line_clicks_match_direct_editor(fake_napari, tmp_path):
    tv = _two_cell_tissue(tmp_path, "v")
    td = _two_cell_tissue(tmp_path, "d")
    v = _make_viewer(tv)
    v.mode = "add_line"
    _click(v, 0, 16)    # event.position is (y, x); handle_click gets (x, y)
    _click(v, 63, 16)
    SegmentationEditor(td).add_segmentation_line(1, (16, 0), (16, 63),
                                                 initial=True, final=True)
    np.testing.assert_array_equal(tv.get_labels(1), td.get_labels(1))
    assert tv.get_labels(1).max() > 2  # the cell actually split
    for name in ("label", "area", "cx", "cy", "valid"):
        np.testing.assert_array_equal(
            getattr(tv.get_cells_info(1), name).numpy(),
            getattr(td.get_cells_info(1), name).numpy())
    # the viewer refreshed its labels layer with the post-edit map
    seg = [layer for layer in v.viewer.layers if layer.name == "segmentation"][0]
    np.testing.assert_array_equal(seg.data, tv.get_labels(1))


def test_remove_line_clicks_match_direct_editor(fake_napari, tmp_path):
    tv = _two_cell_tissue(tmp_path, "v")
    td = _two_cell_tissue(tmp_path, "d")
    v = _make_viewer(tv)
    v.mode = "remove_line"
    _click(v, 32, 31)   # on the vertical boundary
    SegmentationEditor(td).remove_segmentation_line(1, (31, 32))
    np.testing.assert_array_equal(tv.get_labels(1), td.get_labels(1))
    lab = tv.get_labels(1)
    assert len(np.unique(lab[lab > 0])) == 1   # the two cells merged


def test_change_type_click_matches_direct_editor(fake_napari, tmp_path):
    tv = _two_cell_tissue(tmp_path, "v")
    td = _two_cell_tissue(tmp_path, "d")
    v = _make_viewer(tv)
    v.mode = "change_type"
    v.type_name = "HC"
    _click(v, 30, 10)   # inside cell 1
    SegmentationEditor(td).change_cell_type(1, (10, 30), "HC")
    np.testing.assert_array_equal(tv.get_cells_info(1).type.numpy(),
                                  td.get_cells_info(1).type.numpy())
    assert tv.get_cells_info(1).type.numpy().any()
    types_layer = [layer for layer in v.viewer.layers
                   if layer.name == "cell types"][0]
    np.testing.assert_array_equal(types_layer.data,
                                  tv.get_cell_types(1).astype(np.int32))


def test_mark_event_click_adds_event(fake_napari, tmp_path):
    tv = _two_cell_tissue(tmp_path, "v")
    v = _make_viewer(tv)
    v.mode = "mark_event"
    v.event_type = "division"
    _click(v, 20, 10)
    ev = tv.events
    assert len(ev) == 1
    assert ev.iloc[0]["type"] == "division"
    assert (ev.iloc[0]["start_pos_x"], ev.iloc[0]["start_pos_y"]) == (10, 20)
    assert ev.iloc[0]["cell_id"] == 1
    # the refresh added an events points layer
    assert any(layer.name == "events" for layer in v.viewer.layers)


def test_viewer_undo_restores_labels(fake_napari, tmp_path):
    tv = _two_cell_tissue(tmp_path, "v")
    before = tv.get_labels(1).copy()
    v = _make_viewer(tv)
    v.mode = "add_line"
    _click(v, 0, 16)
    _click(v, 63, 16)
    assert tv.get_labels(1).max() > 2
    assert v.undo() == 1
    np.testing.assert_array_equal(tv.get_labels(1), before)


def test_layer_specs_match_jax(tmp_path):
    """``build_layer_specs`` (no napari needed) of a port session equals the
    JAX package's for the same labels, types, channels and events."""
    labels = two_cell_labels()
    jt = JTissue(1, os.path.join(str(tmp_path), "j.tif"),
                 channel_names=["zo"], capacity=32)
    jt.set_labels(1, labels)
    jt.set_cells_info(1, j_frame_cellinfo(jnp.asarray(labels), capacity=32))
    tt = _two_cell_tissue(tmp_path, "t")
    for t in (jt, tt):
        t.set_cell_types(1, np.where(labels == 2, 1, 0).astype(np.uint8))
        t.add_event("delamination", 1, 1, start_pos=(40, 20),
                    end_pos=(40, 20))
    img = np.random.default_rng(0).random((2, 64, 64)).astype(np.float32)
    want = jviewer.build_layer_specs(jt, 1, img)
    got = tviewer.build_layer_specs(tt, 1, img)
    assert [(s["kind"], s["name"]) for s in got] == [
        (s["kind"], s["name"]) for s in want] == [
        ("image", "zo"), ("image", "channel 1"), ("labels", "segmentation"),
        ("labels", "cell types"), ("points", "events")]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["data"], w["data"])
        assert g["data"].dtype == w["data"].dtype
        assert g["kwargs"] == w["kwargs"]


def test_without_napari(monkeypatch, tmp_path):
    """napari stays optional: without it the viewer raises ImportError with
    the install hint, and the layer specs still build."""
    monkeypatch.setitem(sys.modules, "napari", None)  # import napari fails
    assert not tviewer.napari_available()
    tissue = _two_cell_tissue(tmp_path, "n")
    with pytest.raises(ImportError, match="pip install napari"):
        tviewer.TissueViewer(tissue)
    assert [s["name"] for s in tviewer.build_layer_specs(tissue, 1)] == [
        "segmentation", "cell types"]
