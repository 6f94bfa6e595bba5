"""``correct`` on dry runs of the harness at a small size on the CPU: a
sound run passes; with the timed path broken underneath (an answer altered
where it is produced, half of a batch left out, the tracker's state left
unchanged, a drift or a table altered) and with the control in the
program's place, it comes out false. The cells run on one card each, so
there is no exchange between cards to leave out."""

import pytest
import torch

import tissue_image_processing_tpu_torch.core.pipeline as port
from benchmark.run import run_cell
from benchmark.tests.helpers import ROOT, small_cell


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(cell, capsys, side=128, **kw):
    spec, config, traffic = small_cell(cell, side)
    res = run_cell(ROOT, cell, 2 ** 31 + 99, 0.0, False, device="cpu",
                   spec=spec, config=config, traffic=traffic, **kw)
    printed = capsys.readouterr()
    assert printed.out.strip().splitlines()[-1].startswith('{"correct"')
    assert printed.err.strip().splitlines()[-1].startswith("check ids_mismatch")
    return res


def test_a_sound_run_is_correct(capsys):
    res = _run("ws_raw_2000", capsys)
    assert res["correct"] and res["failed"] == 0
    assert list(res["checks"]) == ["labels_mismatch", "tables_mismatch",
                                   "drift_gap", "ids_mismatch"]
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def _altered_answer(real):
    def seg(images, *a, **k):
        lab = real(images, *a, **k)
        lab[0][lab[0] == 3] = 4          # two cells merged in one frame
        return lab
    return seg


def _half_batch(real):
    def seg(images, *a, **k):
        lab = real(images, *a, **k)
        lab[lab.shape[0] // 2:] = 0      # the batch's second half left out
        return lab
    return seg


def _state_unchanged(real):
    def track(*a, **k):
        ids = real(*a, **k)
        ids[1:] = ids[0]                 # frame 0's links repeated
        return ids
    return track


def _drift_altered(real):
    def chain(images):
        dr = real(images)
        dr[-1, 0] += 0.5
        return dr
    return chain


def _table_altered(real):
    def cellinfo(labels, **k):
        tab, over = real(labels, **k)
        tab.area[0] += 1.0
        return tab, over
    return cellinfo


FAULTS = [("watershed_segmentation_batch", _altered_answer, "labels_mismatch"),
          ("watershed_segmentation_batch", _half_batch, "labels_mismatch"),
          ("track_movie", _state_unchanged, "ids_mismatch"),
          ("compute_drift_chain", _drift_altered, "drift_gap"),
          ("frame_cellinfo_checked", _table_altered, "tables_mismatch")]


@pytest.mark.parametrize("name, fault, number", FAULTS,
                         ids=[f[1].__name__ for f in FAULTS])
def test_a_broken_path_is_not_correct(monkeypatch, capsys, name, fault,
                                      number):
    monkeypatch.setattr(port, name, fault(getattr(port, name)))
    res = _run("ws_raw_2000", capsys)
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_the_unet_post_process_with_half_a_batch_is_not_correct(
        monkeypatch, capsys):
    real = port.unet_postprocess_batch

    def post(preds, *a, **k):
        lab, hc = real(preds, *a, **k)
        lab[lab.shape[0] // 2:] = 0
        return lab, hc
    monkeypatch.setattr(port, "unet_postprocess_batch", post)
    res = _run("unet_raw_2000", capsys, side=256)
    assert not res["correct"]
    assert res["checks"]["labels_mismatch"]["value"] > 0.1


def test_the_watershed_control_is_not_correct(capsys):
    res = _run("ws_preproj_2000", capsys, control=True)
    assert not res["correct"]
    assert res["checks"]["labels_mismatch"]["value"] > 0.0


def test_the_unet_control_reads_above_the_sound_run(capsys):
    sound = _run("unet_raw_2000", capsys, side=256)
    control = _run("unet_raw_2000", capsys, side=256, control=True)
    assert (control["checks"]["prob_gap"]["value"]
            > 3 * sound["checks"]["prob_gap"]["value"] > 0.0)


def test_a_call_that_raises_counts_failed(monkeypatch, capsys):
    real, calls = port.track_movie, []

    def boom(*a, **k):
        calls.append(1)
        if len(calls) > 2:          # the two warm-up calls pass
            raise RuntimeError("planted")
        return real(*a, **k)
    monkeypatch.setattr(port, "track_movie", boom)
    res = _run("ws_preproj_2000", capsys)
    assert res["failed"] >= 1 and not res["correct"]


def test_jax_loaded_in_the_process_gives_no_result(monkeypatch, capsys):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    spec, config, traffic = small_cell("ws_preproj_2000")
    with pytest.raises(SystemExit) as ex:
        run_cell(ROOT, "ws_preproj_2000", 5, 0.0, False, device="cpu",
                 spec=spec, config=config, traffic=traffic)
    assert ex.value.code != 0
    printed = capsys.readouterr()
    assert '{"correct"' not in printed.out and "jax" in printed.err
