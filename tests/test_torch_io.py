"""PyTorch port vs the JAX package: the file layer (``io/``) and ``config``.

Both packages' ``io/`` modules are host code (PIL, numpy, ``zstandard``);
the port keeps its own copy. Every comparison here is exact: the same
array, axes and metadata give byte-identical TIFF files from either package,
each package reads the other's files to the same arrays and metadata, the
CZI readers (on files from ``tests/test_czi.py:write_czi``: uncompressed,
zstd0, zstd1 with and without hi-lo packing, a mosaic, a sparse acquisition)
return the same arrays, and the lazy TIFF / CZI / ``.npy`` stores return what
the eager reads return. ``large_image_projection`` decodes each frame of a
lazy store once (as ``tests/test_movie_lazy.py`` pins for the JAX driver),
the external-segmentation ingest drives a stub tissue exactly as the JAX
ingest does, and the configuration round-trips through JSON into the JAX
package's dictionary.
"""

import json
import os

import numpy as np
import pytest
import torch

from tissue_image_processing_tpu import config as j_config
from tissue_image_processing_tpu.io import czi as j_czi
from tissue_image_processing_tpu.io import external_seg as j_ext
from tissue_image_processing_tpu.io import movie as j_movie
from tissue_image_processing_tpu.io import movie_tools as j_tools
from tissue_image_processing_tpu.io import tiff as j_tiff
from tissue_image_processing_tpu_torch import config as t_config
from tissue_image_processing_tpu_torch.io import czi as t_czi
from tissue_image_processing_tpu_torch.io import external_seg as t_ext
from tissue_image_processing_tpu_torch.io import movie as t_movie
from tissue_image_processing_tpu_torch.io import movie_tools as t_tools
from tissue_image_processing_tpu_torch.io import tiff as t_tiff

from test_czi import make_movie_planes, write_czi

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)


def _rng(seed=0):
    return np.random.default_rng(seed)


# (array, axes, metadata, data_type)
TIFF_CASES = {
    "uint16-TCYX": lambda: ((_rng(0).random((3, 2, 8, 16)) * 65535).astype(
        np.uint16), "TCYX", None, ""),
    "float32-ZYX-physical": lambda: (_rng(1).random((4, 6, 10)).astype(
        np.float32), "ZYX", {"physical_size_x": 0.1, "physical_size_z": 0.5,
                             "SizeT": 1}, ""),
    "uint8-YX": lambda: ((_rng(2).random((9, 7)) * 255).astype(np.uint8),
                         "YX", {"note": "µm and <tags> & quotes\""}, ""),
    "float64-rescaled-uint16": lambda: (_rng(3).random((2, 5, 6)) * 3.0,
                                        "CYX", None, "uint16"),
    "float32-rescaled-uint8": lambda: (_rng(4).random((3, 4, 5)).astype(
        np.float32), "TYX", {"SizeT": 3}, "uint8"),
    "bare-pages": lambda: ((_rng(5).random((2, 3, 4, 5)) * 999).astype(
        np.uint16), "", None, ""),
    "TCZYX": lambda: ((_rng(6).random((2, 2, 3, 5, 7)) * 60000).astype(
        np.uint16), "TCZYX", {"physical_size_y": 0.2}, ""),
}


@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_tiff_files_byte_equal_and_cross_read(tmp_path, case):
    arr, axes, meta, data_type = TIFF_CASES[case]()
    paths = {}
    for name, mod in (("jax", j_tiff), ("port", t_tiff)):
        os.makedirs(tmp_path / name)
        # the same base name: the OME-XML carries it
        paths[name] = str(tmp_path / name / "image.tif")
        mod.save_tiff(paths[name], arr, metadata=meta, axes=axes,
                      data_type=data_type)
    with open(paths["jax"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()
    for reader, path in ((t_tiff, paths["jax"]), (j_tiff, paths["port"])):
        got = reader.read_tiff(path)
        want = j_tiff.read_tiff(paths["jax"])
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype
        assert got[1:] == want[1:]
    got = t_tiff.read_whole_image(paths["jax"])
    want = j_tiff.read_whole_image(paths["jax"])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    gd, wd = (m.get_image_dimensions(paths["jax"]) for m in (t_tiff, j_tiff))
    assert [getattr(gd, a) for a in "TCZYX"] == [getattr(wd, a) for a in "TCZYX"]


@pytest.mark.parametrize("axes,shape", [
    ("TCZYX", (2, 3, 4, 5, 6)), ("CZYX", (2, 3, 4, 5)), ("QYX", (3, 4, 5)),
    ("TQYX", (2, 3, 4, 5)), ("YX", (4, 5)), ("ZTCYX", (2, 3, 4, 5, 6))])
def test_ome_xml_and_axes_helpers(axes, shape):
    meta = {"physical_size_x": 0.25, "physical_size_z": 1.5, "SizeT": 7,
            "extra": [1, 2]}
    xml_t = t_tiff.build_ome_xml(axes, shape, "uint16", meta, name="a&b.tif")
    assert xml_t == j_tiff.build_ome_xml(axes, shape, "uint16", meta,
                                         name="a&b.tif")
    assert t_tiff.parse_ome_xml(xml_t) == j_tiff.parse_ome_xml(xml_t)
    assert t_tiff._ome_dimension_order(axes) == j_tiff._ome_dimension_order(axes)
    arr = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    try:
        want = j_tiff.to_tczyx(arr, axes)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            t_tiff.to_tczyx(arr, axes)
        return
    got = t_tiff.to_tczyx(arr, axes)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _czi_case(name, path):
    """Write one CZI case to ``path``; returns the expected TCZYX array (or
    None where only the two readers are compared)."""
    if name in ("plain", "zstd0", "zstd1", "zstd1-hilo"):
        comp, hilo = {"plain": (0, False), "zstd0": (5, False),
                      "zstd1": (6, False), "zstd1-hilo": (6, True)}[name]
        planes, vol = make_movie_planes(T=2, C=2, Z=3, Y=24, X=32, seed=7)
        write_czi(path, planes, compression=comp, hilo=hilo)
        return vol
    rng = _rng(3)
    if name == "mosaic":
        a = rng.integers(0, 255, (16, 16)).astype(np.uint8)
        b = rng.integers(0, 255, (16, 16)).astype(np.uint8)
        write_czi(path, [({"X": (5000, 16), "Y": (7000, 16), "T": (0, 1)}, a),
                         ({"X": (5016, 16), "Y": (7000, 16), "T": (0, 1)}, b)])
        return np.concatenate([a, b], axis=1)[None, None, None]
    assert name == "sparse"
    p0 = rng.integers(0, 999, (8, 8)).astype(np.uint16)
    p2 = rng.integers(0, 999, (8, 8)).astype(np.uint16)
    write_czi(path, [({"X": (0, 8), "Y": (0, 8), "T": (0, 1)}, p0),
                     ({"X": (0, 8), "Y": (0, 8), "T": (2, 1)}, p2)])
    return np.stack([p0, np.zeros_like(p0), p2])[:, None, None]


@pytest.mark.parametrize("name", ["plain", "zstd0", "zstd1", "zstd1-hilo",
                                  "mosaic", "sparse"])
def test_czi_reads_match_jax(tmp_path, name):
    path = str(tmp_path / f"{name}.czi")
    vol = _czi_case(name, path)
    got, want = t_czi.read_czi(path), j_czi.read_czi(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vol)
    assert got.dtype == vol.dtype
    with t_czi.CziFile.open(path) as f, j_czi.CziFile.open(path) as g:
        assert f.shape_tczyx() == g.shape_tczyx()
        assert f.dims() == g.dims() and f.dim_origins() == g.dim_origins()
        assert f.metadata_xml == g.metadata_xml
        assert [(s.file_position, s.compression, s.pixel_type, s.dims)
                for s in f.subblocks] == [
            (s.file_position, s.compression, s.pixel_type, s.dims)
            for s in g.subblocks]
    arr, axes, shape = t_tiff.read_whole_image(path)
    np.testing.assert_array_equal(arr, vol)
    assert axes == "TCZYX" and shape == vol.shape


def test_czi_series_to_store_matches_jax(tmp_path):
    paths = []
    for i, (T, Y, seed) in enumerate(((2, 16, 1), (1, 12, 2))):
        planes, _ = make_movie_planes(T=T, Z=2, Y=Y, X=16, seed=seed)
        paths.append(str(tmp_path / f"m{i}.czi"))
        write_czi(paths[-1], planes)
    got = t_czi.czi_to_store(paths, str(tmp_path / "t.npy"))
    want = j_czi.czi_to_store(paths, str(tmp_path / "j.npy"))
    assert got.shape == want.shape == (3, 2, 2, 16, 16)
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    with open(tmp_path / "t.npy", "rb") as f, open(tmp_path / "j.npy", "rb") as g:
        assert f.read() == g.read()


def _movie_file(tmp_path, kind):
    movie = (_rng(8).random((3, 2, 4, 16, 24)) * 60000).astype(np.uint16)
    path = str(tmp_path / f"movie.{kind}")
    if kind == "tif":
        j_tiff.save_tiff(path, movie, axes="TCZYX")
    elif kind == "npy":
        np.save(path, movie)
    else:
        planes = []
        for t in range(3):
            for c in range(2):
                for z in range(4):
                    planes.append(({"X": (0, 24), "Y": (0, 16), "C": (c, 1),
                                    "Z": (z, 1), "T": (t, 1)}, movie[t, c, z]))
        write_czi(path, planes, compression=6, hilo=True)
    return path, movie


@pytest.mark.parametrize("kind", ["tif", "czi", "npy"])
def test_lazy_store_equals_eager_and_jax(tmp_path, kind):
    path, movie = _movie_file(tmp_path, kind)
    store = t_movie.MovieStore.open(path)
    jstore = j_movie.MovieStore.open(path)
    if kind == "npy":  # a read-only view of the file's memory map
        assert not store.data.flags.owndata and not store.data.flags.writeable
    else:
        assert isinstance(store.data, t_movie._LazyFrameSource)
    assert store.shape == jstore.shape == movie.shape
    assert store.num_frames == 3
    sel = np.array([True, False, True])
    for key in (1, -1, slice(0, 2), slice(None, None, 2), (slice(None), 1, 0),
                sel, [2, 0]):
        np.testing.assert_array_equal(np.asarray(store.data[key]), movie[key])
        np.testing.assert_array_equal(np.asarray(store.data[key]),
                                      np.asarray(jstore.data[key]))
    np.testing.assert_array_equal(store.frame(1), movie[1])
    np.testing.assert_array_equal(store.frames(1, 3), movie[1:3])
    np.testing.assert_array_equal(np.asarray(store.data), movie)
    eager = t_movie.MovieStore.open(path, lazy=False, mmap=False)
    np.testing.assert_array_equal(np.asarray(eager.data), movie)
    store.close()
    jstore.close()


def test_store_write_and_movie_helpers_match_jax(tmp_path):
    movie = (_rng(9).random((4, 2, 3, 10, 12)) * 60000).astype(np.uint16)
    t = t_movie.MovieStore.create(str(tmp_path / "t"), movie.shape)
    j = j_movie.MovieStore.create(str(tmp_path / "j"), movie.shape)
    for i in range(4):
        t.write_frame(i, movie[i])
        j.write_frame(i, movie[i])
    t.data.flush()
    j.data.flush()
    with open(tmp_path / "t.npy", "rb") as f, open(tmp_path / "j.npy", "rb") as g:
        assert f.read() == g.read()
    # chunked walk with a tuple-valued function scattered into two outputs
    outs = {}
    for name, mod in (("port", t_movie), ("jax", j_movie)):
        o1 = np.zeros((4, 2, 3, 10, 12), np.float32)
        o2 = np.zeros((4, 2, 3, 10, 12), np.int32)
        chunks = list(mod.read_image_in_chunks(
            movie, dt=3, dz=2, dy=7, apply_function=lambda c: (
                c * 0.5, c.astype(np.int32) - 7), output=[o1, o2]))
        outs[name] = (len(chunks), o1, o2)
    assert outs["port"][0] == outs["jax"][0]
    for a, b in zip(outs["port"][1:], outs["jax"][1:]):
        np.testing.assert_array_equal(a, b)
    # concatenation along T with padding, and the virtual TIFF concatenation
    files = []
    for i, (Y, X) in enumerate(((10, 12), (8, 12))):
        files.append(str(tmp_path / f"p{i}.npy"))
        np.save(files[-1], movie[:2, :, 0, :Y, :X].astype(np.float32) + i)
    np.testing.assert_array_equal(t_movie.concatenate_time_points(files),
                                  j_movie.concatenate_time_points(files))
    for name, mod in (("port", t_movie), ("jax", j_movie)):
        os.makedirs(tmp_path / name)
        mod.virtually_concatenate_time_points(
            [movie[:2], movie[2:]], str(tmp_path / name / "v.tif"))
    with open(tmp_path / "port" / "v.tif", "rb") as f, \
            open(tmp_path / "jax" / "v.tif", "rb") as g:
        assert f.read() == g.read()


def test_movie_tools_match_jax(tmp_path):
    path, movie = _movie_file(tmp_path, "tif")
    for name, mod in (("port", t_tools), ("jax", j_tools)):
        out = mod.split_large_movie(path, str(tmp_path / name), positions=[1, 2])
        assert [os.path.relpath(p, tmp_path / name) for p in out] == [
            f"position{p}/timepoint{t}.tif" for p in (1, 2) for t in (1, 2, 3)]
    for rel in ("position1/timepoint2.tif", "position2/timepoint3.tif"):
        with open(tmp_path / "port" / rel, "rb") as f, \
                open(tmp_path / "jax" / rel, "rb") as g:
            assert f.read() == g.read()
    track = [(5, 4), (20, 14), (12, 8)]
    np.testing.assert_array_equal(t_tools.crop_section_by_track(movie, track, 4),
                                  j_tools.crop_section_by_track(movie, track, 4))
    npy = str(tmp_path / "m2.npy")
    np.save(npy, movie[:2, :1, :3, :12, :20])
    for name, mod in (("port", t_tools), ("jax", j_tools)):
        mod.convert_series_to_store([path, npy], str(tmp_path / f"{name}.npy"),
                                    chunk_frames=2)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"),
                                  np.load(tmp_path / "jax.npy"))


def test_large_image_projection_decodes_each_frame_once(tmp_path, monkeypatch):
    """The XY tile loop decodes each frame of a lazy store once and tiles
    the host array (``tests/test_movie_lazy.py``'s check of the JAX
    driver, on the port's driver)."""
    from tissue_image_processing_tpu_torch.projection.driver import (
        large_image_projection)

    movie = (_rng(0).random((2, 1, 3, 32, 32)) * 60000).astype(np.uint16)
    t_tiff.save_tiff(str(tmp_path / "movie.tif"), movie, axes="TCZYX")
    calls = []
    orig = t_movie._TiffFrameSource._read_frame

    def counting(self, t):
        calls.append(t)
        return orig(self, t)

    monkeypatch.setattr(t_movie._TiffFrameSource, "_read_frame", counting)
    out = tmp_path / "out"
    os.makedirs(out)
    assert large_image_projection(str(tmp_path), str(out), "movie.tif",
                                  chunk_size=16, device="cpu") == 1
    # 2 x 2 tiles a frame, 2 frames: one decode a frame
    assert sorted(calls) == [0, 1], calls
    assert os.path.isfile(out / "movie_projection.tif")
    assert np.load(out / "movie_zmap.npy").shape == (2, 32, 32)
    assert large_image_projection(str(tmp_path), str(out), "missing.tif",
                                  device="cpu") == 0


class StubTissue:
    """The two members the ingest calls, recording every call."""

    def __init__(self):
        self.calls = []

    def set_labels(self, frame, labels, reset_data=False):
        self.calls.append(("set_labels", frame, labels.dtype.str,
                           labels.tobytes(), reset_data))

    def calculate_frame_cellinfo(self, frame):
        self.calls.append(("cellinfo", frame))


def test_external_segmentation_with_stub_tissue(tmp_path):
    rng = _rng(11)
    folder = tmp_path / "seg"
    os.makedirs(folder / "sub")
    for n, ext in ((1, "npy"), (2, "tif"), (3, "npy")):
        img = np.where(rng.random((12, 14)) < 0.3, 255, 0).astype(np.uint8)
        path = folder / ("sub" if n == 3 else "") / f"frame_{n}_boundaries.{ext}"
        if ext == "npy":
            np.save(path, img)
        else:
            j_tiff.save_tiff(str(path), img, axes="YX")
    (folder / "notes.txt").write_text("not a frame")
    stubs = {}
    for name, mod in (("port", t_ext), ("jax", j_ext)):
        stub = StubTissue()
        progress = list(mod.ingest_external_segmentation(
            stub, str(folder), 3, poll_interval=0.0, stable_checks=1,
            timeout=30.0))
        assert progress == [1 / 3, 2 / 3, 1.0]
        direct = mod.load_external_labels(stub, 9, str(folder / "frame_2_boundaries.tif"))
        assert mod.load_external_labels(stub, 9, str(folder / "none.npy")) is None
        stubs[name] = (sorted(stub.calls[:6], key=lambda c: (c[1], c[0])),
                       stub.calls[6:], direct)
    assert stubs["port"][0] == stubs["jax"][0]
    assert stubs["port"][1] == stubs["jax"][1]
    np.testing.assert_array_equal(stubs["port"][2], stubs["jax"][2])
    assert t_ext._frame_number("x/frame_12_a.tif") == 12
    assert t_ext._frame_number("x/frame_b.tif") is None


def test_config_round_trip_matches_jax(tmp_path):
    for cls in ("ProjectionConfig", "SegmentationConfig", "UNetConfig",
                "TrackingConfig", "CellTableConfig", "PipelineConfig"):
        got = [(f.name, f.default) for f in
               t_config.dataclasses.fields(getattr(t_config, cls))]
        want = [(f.name, f.default) for f in
                j_config.dataclasses.fields(getattr(j_config, cls))]
        assert got == want, cls
    cfg = t_config.PipelineConfig().replace(
        pixel_length_um=0.2,
        projection=t_config.ProjectionConfig(bin_size=2,
                                             pre_blur_std=(1.0, 2.0, 2.0)))
    jcfg = j_config.PipelineConfig().replace(
        pixel_length_um=0.2,
        projection=j_config.ProjectionConfig(bin_size=2,
                                             pre_blur_std=(1.0, 2.0, 2.0)))
    assert cfg.to_dict() == jcfg.to_dict()
    cfg.to_json(str(tmp_path / "t.json"))
    jcfg.to_json(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert t_config.PipelineConfig.from_json(str(tmp_path / "j.json")) == cfg
    assert t_config.PipelineConfig.from_dict(
        json.loads((tmp_path / "t.json").read_text())) == cfg
