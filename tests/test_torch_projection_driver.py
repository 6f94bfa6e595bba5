"""PyTorch port vs the JAX package: the projection driver and its CLI, the
store-fed chunked pipeline, ``utils/runtime`` and the native Meyer oracle.

Both drivers project through the unfused route (the JAX driver's vmapped
``time_point_surface_projection``, the port's frame-by-frame loop of the
same function on the CPU). Tolerances:

- z-maps equal (the class of ``tests/test_torch_projection.py``: >= 99.9%
  equal with |dz| <= 1 everywhere; the runs here read exact equality);
  projections rtol 1e-4 / atol 1e-3 where the z-maps agree (two frameworks'
  float32 blurs and reductions in another order);
- the CLI's ``position1.tif`` holds the projections cast to uint16
  (``concatenate_time_points`` truncates, ``save_tiff`` leaves uint16 as it
  is): a projection value v of at most 65535 may move by 1e-4 * v + 1e-3
  <= 6.56, so its truncation by at most 7.56 counts: held to <= 8 counts;
- ``large_image_projection``'s TIFF is rescaled by the projection's maximum
  (``save_tiff(..., data_type="uint16")``): both the value and the maximum
  may move by 1e-4 relative, so a count by at most 2e-4 * 65535 + 1 (the
  rounding) = 14.1: held to <= 15 counts. From the same projection array
  the two packages write byte-equal files (``tests/test_torch_io.py``);
- ``update_projection_metadata``, the stage pickles, the chunked pipeline
  fed from a port ``MovieStore`` (against the in-memory run of the port)
  and the native Meyer flood: exact.
"""

import dataclasses
import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

from tissue_image_processing_tpu.io import tiff as j_tiff
from tissue_image_processing_tpu.projection import cli as j_cli
from tissue_image_processing_tpu.projection import driver as j_driver
from tissue_image_processing_tpu_torch.core.pipeline import (
    movie_pipeline, movie_pipeline_chunked)
from tissue_image_processing_tpu_torch.io import tiff as t_tiff
from tissue_image_processing_tpu_torch.io.movie import MovieStore
from tissue_image_processing_tpu_torch.projection import cli as t_cli
from tissue_image_processing_tpu_torch.projection import driver as t_driver
from tissue_image_processing_tpu_torch.utils import runtime
from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _assert_projections(got, want):
    (gp, gz), (wp, wz) = got, want
    assert gz.dtype == np.int32 and gz.shape == wz.shape
    np.testing.assert_array_equal(gz, wz)
    np.testing.assert_allclose(gp, wp, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def movie():
    """(3, 2, 8, 128, 128) uint16 raw z-stack movie."""
    return make_movie(T=3, Z=8, H=128, W=128, n_cells=24, seed=4).astype(
        np.uint16)


@pytest.fixture(scope="module")
def port_batch4(movie):
    return t_driver.project_movie_array(movie, batch=4, device="cpu")


def test_project_movie_array_matches_jax(movie, port_batch4):
    want = j_driver.project_movie_array(movie, batch=4)
    _assert_projections(port_batch4, want)
    assert port_batch4[0].dtype == np.float32


def test_project_movie_array_batch_sizes_equal(movie, port_batch4):
    """The port projects frame by frame, so the batch only sets how many
    frames are read and uploaded at once: every batch size gives the same
    arrays."""
    for batch in (1, 2):
        got = t_driver.project_movie_array(movie, batch=batch, device="cpu")
        np.testing.assert_array_equal(got[0], port_batch4[0])
        np.testing.assert_array_equal(got[1], port_batch4[1])


def test_project_movie_array_options_match_jax(movie):
    """A z-window, the airyscan offset, another reference channel, the
    shifted mask and the manifold, on one frame."""
    kw = dict(reference_channel=1, min_z=1, max_z=7, airyscan=True,
              atoh_shift=1, build_manifold=True, batch=1)
    got = t_driver.project_movie_array(movie[:1], device="cpu", **kw)
    _assert_projections(got, j_driver.project_movie_array(movie[:1], **kw))


def _read_outputs(d):
    return {os.path.basename(p): p for p in glob.glob(os.path.join(d, "*"))}


def _cli_args(kind, d):
    if kind == "fixed":
        return ["-i", d, "--fixed", "--file", "fixed.npy", "-c", "40", "-r",
                "0"]
    return ["-i", d, "-n", "1", "-m", "2", "-r", "0", "--ext", kind]


@pytest.mark.parametrize("kind", ["npy", "tif", "fixed"])
def test_cli_matches_jax(tmp_path, kind):
    """The CLI of each package on the same inputs: two movie files of one
    position (``.npy`` stores or lazy TIFF stores), or one fixed sample
    tiled into ragged 40 x 40 blocks. Same files, z-maps equal, TIFF counts
    within the bounds of the module docstring."""
    mv = make_movie(T=3, Z=6, H=64, W=72, n_cells=12, seed=5).astype(np.uint16)
    dirs = {}
    for name in ("jax", "port"):
        d = str(tmp_path / name)
        os.makedirs(d)
        if kind == "fixed":
            np.save(os.path.join(d, "fixed.npy"), mv[:1])
        for i, part in enumerate((mv[:2], mv[2:])):
            if kind == "npy":
                np.save(os.path.join(d, f"m{i + 1}.npy"), part)
            elif kind == "tif":
                j_tiff.save_tiff(os.path.join(d, f"m{i + 1}.tif"), part,
                                 axes="TCZYX")
        dirs[name] = d
    assert j_cli.main(_cli_args(kind, dirs["jax"])) == 0
    metrics = runtime.StageMetrics(stream=None)
    assert t_cli.main(_cli_args(kind, dirs["port"]), device="cpu",
                      metrics=metrics) == 0
    got, want = _read_outputs(dirs["port"]), _read_outputs(dirs["jax"])
    assert sorted(got) == sorted(want)
    if kind == "fixed":
        tif, zmap, bound = "fixed_projection.tif", "fixed_zmap.npy", 15
    else:
        tif, zmap, bound = "position1.tif", "zmap_position1.npy", 8
        assert [r["stage"] for r in metrics.records] == [
            "project", "project", "concat_save"]
    gz, wz = np.load(got[zmap]), np.load(want[zmap])
    assert gz.dtype == wz.dtype and gz.shape[-2:] == (64, 72)
    np.testing.assert_array_equal(gz, wz)
    (ga, gaxes, _, gmeta), (wa, waxes, _, wmeta) = (
        t_tiff.read_tiff(got[tif]), j_tiff.read_tiff(want[tif]))
    assert ga.dtype == wa.dtype == np.uint16 and ga.shape == wa.shape
    assert (gaxes, gmeta) == (waxes, wmeta)
    assert np.abs(ga.astype(np.int64) - wa).max() <= bound


def test_cli_resumes_and_cleans_up(tmp_path):
    """Existing per-(position, movie) intermediates are not projected again
    (a ``skip_existing`` line); intermediates are removed after the save."""
    mv = make_movie(T=2, Z=4, H=32, W=32, seed=6).astype(np.uint16)
    d = str(tmp_path)
    np.save(os.path.join(d, "m1.npy"), mv)
    proj, zmap = t_driver.project_movie_array(mv, device="cpu")
    np.save(os.path.join(d, "position0_movie0_projection.npy"), proj + 1.0)
    np.save(os.path.join(d, "position0_movie0_zmap.npy"), zmap.astype(np.uint16))
    metrics = runtime.StageMetrics(stream=None)
    t_cli.main(["-i", d, "-n", "1", "-m", "1", "-r", "0", "--ext", "npy"],
               device="cpu", metrics=metrics)
    assert [r["event"] for r in metrics.records] == ["skip_existing", "stage"]
    assert sorted(os.listdir(d)) == ["m1.npy", "position1.tif",
                                     "zmap_position1.npy"]
    back = t_tiff.read_tiff(os.path.join(d, "position1.tif"))[0]
    np.testing.assert_array_equal(back, (proj + 1.0).astype(np.uint16))


def test_update_projection_metadata_and_stage_pickles_match_jax(tmp_path):
    arr = (np.random.default_rng(1).random((3, 2, 8, 16)) * 65535).astype(
        np.uint16)
    for name, tiff, drv in (("jax", j_tiff, j_driver),
                            ("port", t_tiff, t_driver)):
        os.makedirs(tmp_path / name)
        p = str(tmp_path / name / "proj.tif")
        tiff.save_tiff(p, arr, axes="TCYX")
        meta = drv.update_projection_metadata(
            p, size_t=3, physical_pixel_sizes=(1.0, 0.1, 0.1))
        assert meta["SizeT"] == 3 and meta["physical_size_y"] == 0.1
        drv.save_stage_positions([{"x": 1.5, "y": [2, 3]}, {"x": 0.0}],
                                 str(tmp_path / name), output_name="run_")
    for f in ("proj.tif", "run_stage_locations_position1.pkl",
              "run_stage_locations_position2.pkl"):
        with open(tmp_path / "port" / f, "rb") as a, \
                open(tmp_path / "jax" / f, "rb") as b:
            assert a.read() == b.read(), f
    with open(tmp_path / "port" / "run_stage_locations_position1.pkl", "rb") as f:
        assert pickle.load(f) == {"x": 1.5, "y": [2, 3]}


KW = dict(capacity=96, block_size=31, batch=2)


@pytest.fixture(scope="module")
def zmovie():
    return make_movie(T=4, Z=6, H=128, W=128, n_cells=24, seed=7).astype(
        np.uint16)


@pytest.fixture(scope="module")
def in_memory_run(zmovie):
    out = movie_pipeline(zmovie, device="cpu", **KW)
    return {"labels": out["labels"].numpy(), "ids": out["ids"],
            "tables": out["tables"].map(lambda x: x.numpy()),
            "drifts": out["drifts"]}


@pytest.mark.parametrize("kind", ["npy", "tif"])
def test_chunked_pipeline_from_store_equals_in_memory(tmp_path, zmovie,
                                                      in_memory_run, kind):
    """``movie_pipeline_chunked`` reads ``np.asarray(data[t0:t0 + C])`` of a
    port ``MovieStore`` (the ``.npy`` memory map, or the lazy TIFF that
    decodes the chunk's frames): labels, every table field, ids and drifts
    equal the in-memory run's."""
    path = str(tmp_path / f"movie.{kind}")
    if kind == "npy":
        np.save(path, zmovie)
    else:
        t_tiff.save_tiff(path, zmovie, axes="TCZYX")
    store = MovieStore.open(path)
    got = movie_pipeline_chunked(store, chunk_frames=3, device="cpu", **KW)
    store.close()
    want = in_memory_run
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["drifts"], want["drifts"])
    for field in dataclasses.fields(got["tables"]):
        np.testing.assert_array_equal(
            getattr(got["tables"], field.name).numpy(),
            getattr(want["tables"], field.name), err_msg=field.name)
    assert int((want["ids"] > 0).sum(axis=1).min()) >= 10


def test_runtime_trace_timer_and_metrics(tmp_path):
    log_dir = str(tmp_path / "trace")
    with runtime.trace(log_dir) as prof:
        x = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
        (x @ x).sum()
    traces = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any("aten::mm" in e.key for e in prof.key_averages())
    metrics = runtime.StageMetrics(stream=None, run="r")
    with metrics.stage("a", n=1):
        pass
    with pytest.raises(ValueError), metrics.stage("b"):
        raise ValueError("boom")
    assert [r["event"] for r in metrics.records] == ["stage", "stage_error"]
    assert metrics.records[1]["error"] == "ValueError: boom"
    assert list(metrics.summary()) == ["a"] and metrics.records[0]["run"] == "r"


def test_native_meyer_watershed_matches_jax():
    from tissue_image_processing_tpu.native import (
        meyer_watershed_native as j_meyer)
    from tissue_image_processing_tpu_torch.native import (
        meyer_watershed_native, native_available)
    from tissue_image_processing_tpu_torch.native.build import BUILD_DIR

    if not native_available():
        pytest.skip("no g++: the native oracle cannot be built")
    surface = np.load(os.path.join(FIXTURES, "watershed_128x128.npz"))["surface"]
    for line in (True, False):
        got = meyer_watershed_native(surface, watershed_line=line)
        want = j_meyer(surface, watershed_line=line)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert got.max() > 10
    assert glob.glob(str(BUILD_DIR / "libtipws-*.so"))


def test_entry_points_without_card_raise(tmp_path, movie, monkeypatch):
    """``device=None`` is the card: without one every entry point raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(tmp_path / "m1.npy", movie[:1])
    calls = [
        lambda: t_driver.project_movie_array(movie[:1]),
        lambda: t_driver.large_image_projection(str(tmp_path), str(tmp_path),
                                                "m1.npy"),
        lambda: t_cli.main(["-i", str(tmp_path), "-n", "1", "-m", "1",
                            "--ext", "npy"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            call()
    assert sorted(os.listdir(tmp_path)) == ["m1.npy"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_driver_on_card_matches_cpu(cuda_device, tmp_path, movie, port_batch4):
    """The driver and the CLI on the card: three ``blur3d`` launches a
    frame, z-maps and projections in the class of the module docstring
    against the CPU route, the CLI's z-maps equal to the in-memory run's."""
    import tissue_image_processing_tpu_torch as tipt

    tipt.reset_launches()
    got = t_driver.project_movie_array(movie, batch=2, device=cuda_device)
    assert tipt.LAUNCHES["blur3d"] == 3 * movie.shape[0]
    gz, wz = got[1], port_batch4[1]
    same = gz == wz
    assert same.mean() >= 0.999 and np.abs(gz - wz).max() <= 1
    sel = np.broadcast_to(same[:, None], got[0].shape)
    np.testing.assert_allclose(got[0][sel], port_batch4[0][sel], rtol=1e-4,
                               atol=1e-3)
    np.save(tmp_path / "m1.npy", movie)
    assert t_cli.main(["-i", str(tmp_path), "-n", "1", "-m", "1", "-r", "0",
                       "--ext", "npy"], device=cuda_device) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "zmap_position1.npy"), gz)
