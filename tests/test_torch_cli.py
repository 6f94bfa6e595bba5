"""PyTorch port vs the JAX package: the main CLI (``cli.py``).

Each JAX CLI chain runs once, in a module-scoped fixture; the port runs the
same argv with ``device="cpu"``. Tolerances:

- the parsers: every subcommand, option string, ``dest``, default, choice,
  ``nargs``, type and action equal;
- the watershed chain on ``tests/test_cli_and_tools.py:_grid_movie`` (64^2,
  T=3): segment -> types -> track ``--use-images --fix-types`` -> events ->
  export in all five formats -> analyze ``--out``. After each step both
  ``.seg`` files load into the port's ``Tissue`` and every artifact is
  exact (labels, types, tables, events, drifts, type names). The exported
  files are byte for byte equal, but the ``.mat``, whose header carries the
  time of writing: its arrays are equal. analyze's table is byte for byte
  equal, and so is every line the chain prints once the two run
  directories are named alike;
- ``segment`` and ``track --use-images`` on a drifting 128^2 movie: labels,
  tables and ids exact, drifts to 1e-4 px;
- ``pipeline --events`` on the grid movie: exact against the JAX CLI; in
  the port ``pipeline`` equals ``segment`` + ``track`` (labels and track
  ids) and ``pipeline --chunk 2`` equals the whole-movie run (every
  artifact);
- the U-Net: one Keras ``.h5`` (``utils/synthetic.write_keras_h5``) read by
  both CLIs, its head bias set so that 30% of the first frame passes the
  0.1 HC threshold. ``pipeline --unet`` (bfloat16) and ``unet``: labels,
  tables and ids exact, the drifts (phase correlation of the projected
  frames, float32 in another order) to 1e-4 px, as in
  ``tests/test_torch_pipeline.py``. ``pipeline --unet --quantize``: the
  int8 class of ``tests/test_torch_quant.py::test_unet_int8_apply_matches_jax``
  on the probabilities behind the sessions (these frames, these
  weights): on JAX's int8 scales the port's forward equals JAX's eager
  forward (mean |dP| <= 1e-5, argmax everywhere), its own calibration is
  within mean |dP| 1e-4 of that, and against the jitted JAX forward its
  argmax agrees on >= 0.98 and its mean |dP| is JAX's own eager-vs-jit gap
  within 1e-4. That gap (ROADMAP section 3, fault 6) reads 0.0069 here,
  above that test's 5e-3 bar, which was set on other inputs. The sessions'
  labelled (> 0) pixels agree on >= 0.98 of each frame (0.997 here): the
  0.1 threshold and the post-process morphology magnify the gap, so the
  cell counts differ (7 and 9 in frame 1 here), and on other seeds the
  labelled pixels of the two int8 sessions agree on as little as 0.94.
"""

import argparse
import contextlib
import io
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.io
import torch

from test_cli_and_tools import _grid_movie
import tissue_image_processing_tpu.cli as jcli
import tissue_image_processing_tpu_torch._device as tdevice
import tissue_image_processing_tpu_torch.cli as tcli
from tissue_image_processing_tpu_torch.core.tissue import Tissue
from tissue_image_processing_tpu_torch.utils.runtime import (
    enable_compilation_cache)
from tissue_image_processing_tpu_torch.utils.synthetic import (
    head_bias_for_share, keras_unet_arrays, make_movie, write_keras_h5)

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

SEG = ["--capacity", "256", "--threshold", "0.3", "--std", "1.0",
       "--block-size", "21"]
STEPS = ("segment", "types", "track", "events")
FORMATS = ("matlab", "tiff", "tiff+types", "npy", "events")


def port_main(argv):
    return tcli.main(argv, device="cpu")


def chain(main, d, movie):
    """The per-frame chain in directory ``d``: the session copied after each
    step, one export directory per format; returns everything it printed."""
    s = os.path.join(d, "s.seg")
    common = ["--session", s, "--capacity", "256"]
    argvs = {
        "segment": ["segment", movie, "--session", s] + SEG,
        "types": ["types", movie] + common + ["--channel", "1", "--name", "HC",
                                             "--threshold", "0.3"],
        "track": ["track", movie] + common + ["--use-images", "--fix-types"],
        "events": ["events"] + common + ["--frames", "3"],
    }
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for step in STEPS:
            assert main(argvs[step]) == 0
            shutil.copy(s, os.path.join(d, f"{step}.seg"))
        for fmt in FORMATS:
            assert main(["export"] + common + ["--frames", "3",
                                               os.path.join(d, f"export_{fmt}"),
                                               "--format", fmt]) == 0
        assert main(["analyze"] + common + ["--frames", "3", "--feature",
                                            "area", "--out",
                                            os.path.join(d, "area.csv")]) == 0
        assert main(["pipeline", movie, "--session",
                     os.path.join(d, "pipeline.seg"), "--events"] + SEG) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    d = tmp_path_factory.mktemp("grid")
    return _grid_movie(str(d))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, grid):
    d = str(tmp_path_factory.mktemp("jax"))
    return d, chain(jcli.main, d, grid)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory, grid):
    d = str(tmp_path_factory.mktemp("port"))
    return d, chain(port_main, d, grid)


def contents(path, T, capacity):
    """Every artifact of a ``.seg`` file, loaded by the port."""
    t = Tissue(T, "check", capacity=capacity, device="cpu")
    for _ in t.load(path):
        pass
    frames = range(1, T + 1)
    tables = []
    for f in frames:
        table = t.get_cells_info(f)
        tables.append(None if table is None else {
            k: v.numpy() for k, v in vars(table).items()})
    ev = t.get_events().sort_values(["type", "start_frame", "cell_id"],
                                    kind="stable").reset_index(drop=True)
    return {"labels": [t.get_labels(f) for f in frames],
            "types": [t.get_cell_types(f) for f in frames],
            "tables": tables, "events": ev, "drifts": t.drifts,
            "names": (t.type_names, t.channel_names)}


def assert_sessions_equal(a, b, drift_atol=0.0):
    for key in ("labels", "types"):
        for f, (x, y) in enumerate(zip(a[key], b[key])):
            assert (x is None) == (y is None), (key, f)
            if y is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"{key} {f + 1}")
    for f, (x, y) in enumerate(zip(a["tables"], b["tables"])):
        assert (x is None) == (y is None), f
        for k in (y or {}):
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{k} {f + 1}")
    pd.testing.assert_frame_equal(a["events"], b["events"], check_dtype=False)
    np.testing.assert_allclose(a["drifts"], b["drifts"], rtol=0, atol=drift_atol)
    assert a["names"] == b["names"]


# --- the parser ---------------------------------------------------------------------------

def actions(parser):
    """Each subcommand's arguments as comparable tuples."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))

    def row(a):
        return (tuple(a.option_strings), a.dest, repr(a.default), a.nargs,
                None if a.choices is None else tuple(a.choices), a.type,
                a.required, type(a).__name__)

    return {name: sorted((row(a) for a in sp._actions), key=repr)
            for name, sp in sub.choices.items()}


# the port's pipeline segments with Cellpose too, which the JAX package
# lacks: these two options are its own
CELLPOSE_OPTIONS = {
    ("--cellpose",): ("cellpose", "None", None),
    ("--cp-diameter",): ("cp_diameter", "None", float)}


def test_parser_matches_jax():
    want = actions(jcli.build_parser())
    got = actions(tcli.build_parser())
    assert sorted(got) == sorted(want) == sorted(
        ["segment", "pipeline", "unet", "types", "track", "events", "export",
         "analyze", "warmup", "view"])
    own = {r[0]: r for r in got["pipeline"] if r[0] in CELLPOSE_OPTIONS}
    assert sorted(own) == sorted(CELLPOSE_OPTIONS)
    for opt, (dest, default, typ) in CELLPOSE_OPTIONS.items():
        assert own[opt][1:3] == (dest, default), opt
        assert own[opt][5] is typ, opt
    got["pipeline"] = [r for r in got["pipeline"]
                       if r[0] not in CELLPOSE_OPTIONS]
    for name in want:
        assert got[name] == want[name], name


def test_config_threading(tmp_path):
    """``--config`` seeds the flags left unset; an explicit flag wins."""
    from tissue_image_processing_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig().replace(
        segmentation=PipelineConfig().segmentation.__class__(
            threshold=0.33, block_size=51, std=2.0))
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    for cli in (jcli, tcli):
        args = cli._apply_config(cli.build_parser().parse_args(
            ["pipeline", "m.npy", "--config", path, "--std", "4.5"]))
        assert (args.threshold, args.block_size, args.std, args.capacity,
                args.search_range, args.memory) == (0.33, 51, 4.5, 4096, 100.0, 3)


# --- the watershed chain against the JAX CLI -----------------------------------------------

@pytest.mark.parametrize("step", STEPS + ("pipeline",))
def test_chain_sessions_match_jax(jax_run, port_run, step):
    want = contents(os.path.join(jax_run[0], f"{step}.seg"), 3, 256)
    got = contents(os.path.join(port_run[0], f"{step}.seg"), 3, 256)
    assert_sessions_equal(got, want)
    assert all(lab is not None and lab.max() > 30 for lab in got["labels"])
    assert got["names"][0] == ([] if step in ("segment", "pipeline") else ["HC"])


@pytest.mark.parametrize("fmt", FORMATS)
def test_chain_exports_match_jax(jax_run, port_run, fmt):
    jd = os.path.join(jax_run[0], f"export_{fmt}")
    td = os.path.join(port_run[0], f"export_{fmt}")
    names = sorted(os.listdir(jd))
    assert names and sorted(os.listdir(td)) == names
    for name in names:
        a, b = os.path.join(td, name), os.path.join(jd, name)
        if name.endswith(".mat"):
            got, want = scipy.io.loadmat(a), scipy.io.loadmat(b)
            keys = sorted(k for k in want if not k.startswith("__"))
            assert keys and sorted(k for k in got if not k.startswith("__")) == keys
            for k in keys:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_chain_analyze_and_prints_match_jax(jax_run, port_run):
    (jd, jout), (td, tout) = jax_run, port_run
    with open(os.path.join(jd, "area.csv")) as f:
        want = f.read()
    with open(os.path.join(td, "area.csv")) as f:
        assert f.read() == want
    assert len(pd.read_csv(os.path.join(td, "area.csv"))) == 3
    assert tout.replace(td, "<dir>") == jout.replace(jd, "<dir>")
    assert "segmented frame 3: " in tout and "pipeline: 3 frames" in tout


def test_pipeline_equals_segment_and_track(port_run):
    """In the port, the whole-movie ``pipeline`` gives the per-frame chain's
    labels and track ids (the grid movie is static: no drift either way)."""
    d = port_run[0]
    piped = contents(os.path.join(d, "pipeline.seg"), 3, 256)
    chained = contents(os.path.join(d, "track.seg"), 3, 256)
    for f in range(3):
        np.testing.assert_array_equal(piped["labels"][f], chained["labels"][f])
        np.testing.assert_array_equal(piped["tables"][f]["label"],
                                      chained["tables"][f]["label"])


# --- the U-Net paths ------------------------------------------------------------------------

def calibrated_h5(path, movie, depth, filters, share):
    """Keras arrays of the reference U-Net (seeded), the head bias set so
    that ``share`` of the first frame passes the 0.1 HC threshold; written
    to ``path``."""
    from tissue_image_processing_tpu_torch.models.predictor import (
        SegmentationPredictor, prepare_batch)

    arrays = keras_unet_arrays(depth, filters, seed=0)
    write_keras_h5(path, arrays, "keras2")
    Y, X = movie.shape[-2:]
    pred = SegmentationPredictor(path, (2, Y, X), depth=depth,
                                 base_filters=filters, dtype=torch.float32,
                                 device="cpu")
    x, (px, py) = prepare_batch(torch.from_numpy(
        movie[0, :, 0].astype(np.float32))[None])
    convs = [k for k in arrays if re.fullmatch(r"conv2d(_\d+)?", k)]
    head = max(convs, key=lambda k: int(k.split("_")[1]) if "_" in k else 0)
    arrays[head]["bias"][0] += head_bias_for_share(
        pred._forward(x)[0, px:, py:], share)
    write_keras_h5(path, arrays, "keras2")
    return path


@pytest.fixture(scope="module")
def unet_movie(tmp_path_factory):
    d = tmp_path_factory.mktemp("unet")
    movie = make_movie(T=4, Z=1, H=128, W=128, seed=0).astype(np.uint16)
    path = str(d / "movie.npy")
    np.save(path, movie)
    return str(d), path, calibrated_h5(str(d / "w.h5"), movie, 2, 8, 0.3)


def unet_argv(movie, weights, *extra):
    return ["pipeline", movie, "--capacity", "64", "--unet", "--weights",
            weights, "--unet-depth", "2", "--unet-filters", "8",
            "--unet-batch", "2", *extra]


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_pipeline_unet_matches_jax(unet_movie, quantize):
    d, movie, weights = unet_movie
    extra = ["--quantize"] if quantize else []
    tag = "q" if quantize else "b"
    sessions = {}
    for name, main in (("jax", jcli.main), ("port", port_main)):
        sessions[name] = os.path.join(d, f"{name}_{tag}.seg")
        assert main(unet_argv(movie, weights, "--session", sessions[name],
                              *extra)) == 0
    want = contents(sessions["jax"], 4, 64)
    got = contents(sessions["port"], 4, 64)
    cells = [int(lab.max()) for lab in want["labels"]]
    assert min(cells) >= 5, cells   # not a trivial flood
    if not quantize:
        assert_sessions_equal(got, want, drift_atol=1e-4)
        return
    for f, (a, b) in enumerate(zip(got["labels"], want["labels"])):
        assert ((a > 0) == (b > 0)).mean() >= 0.98, f
    # the int8 class of test_torch_quant.py on the probabilities behind
    # these sessions
    import jax
    import jax.numpy as jnp
    from tissue_image_processing_tpu.models import predictor as jpred
    from tissue_image_processing_tpu.models import quant as jq
    from tissue_image_processing_tpu_torch.models import quant as tq
    from tissue_image_processing_tpu_torch.models.predictor import (
        SegmentationPredictor)
    from tissue_image_processing_tpu_torch.utils.state import (
        quant_params_from_jax)

    frames = np.load(movie)[:, :, 0].astype(np.float32)
    tp = SegmentationPredictor(weights, (2, 128, 128), depth=2, base_filters=8,
                               quantize=True, device="cpu")
    jp = jpred.SegmentationPredictor(weights, (2, 128, 128), depth=2,
                                     base_filters=8, quantize=True)
    tp.calibrate(frames[0])
    jp.calibrate(frames[0])
    batch, _ = tp._prepare(torch.from_numpy(frames))
    own = tp._forward(batch).float().numpy()
    on_jax_scales = tq.unet_int8_apply(
        quant_params_from_jax(jax.device_get(jp._qparams)), batch,
        depth=2).float().numpy()
    x = jnp.asarray(batch.numpy())
    jitted = np.asarray(jq.unet_int8_apply(jp._qparams, x, depth=2))
    with jax.disable_jit():
        eager = np.asarray(jq._forward_int8(
            jax.tree_util.tree_map(jnp.asarray, jp._qparams["params"]), x, 2))

    def gap(a, b):
        return np.abs(a - b.astype(np.float32)).mean()

    assert gap(on_jax_scales, eager) <= 1e-5
    assert (on_jax_scales.argmax(-1) == eager.argmax(-1)).all()
    assert gap(own, on_jax_scales) <= 1e-4      # the calibrations agree
    assert (own.argmax(-1) == jitted.argmax(-1)).mean() >= 0.98
    # against the jitted forward the port is as far as JAX's own eager one
    assert abs(gap(own, jitted) - gap(eager, jitted)) <= 1e-4


def test_unet_subcommand_matches_jax(tmp_path, grid):
    """``unet`` (the reference net: depth 3, 128 filters, bfloat16; frames in
    groups of 8) on the grid movie from one weights file: labels, tables
    exact."""
    movie = np.load(grid)
    weights = calibrated_h5(str(tmp_path / "w3.h5"), movie, 3, 128, 0.15)
    sessions = {}
    for name, main in (("jax", jcli.main), ("port", port_main)):
        sessions[name] = str(tmp_path / f"{name}.seg")
        assert main(["unet", grid, "--session", sessions[name], "--capacity",
                     "64", "--weights", weights]) == 0
    want = contents(sessions["jax"], 3, 64)
    assert_sessions_equal(contents(sessions["port"], 3, 64), want,
                          drift_atol=1e-4)
    assert all(lab.shape == (64, 64) and lab.max() >= 2
               for lab in want["labels"])


def test_segment_and_track_match_jax_on_a_drifting_movie(unet_movie):
    """``segment`` and ``track --use-images`` on a movie that is neither
    symmetric nor static (``utils/synthetic.make_movie``, 128^2, T=4):
    labels, tables and ids exact, the drift chain to 1e-4 px. The grid
    movie cannot show a lost transpose; this one does."""
    d, movie, _ = unet_movie
    sessions = {}
    for name, main in (("jax", jcli.main), ("port", port_main)):
        sessions[name] = os.path.join(d, f"{name}_ws.seg")
        common = ["--session", sessions[name], "--capacity", "256"]
        assert main(["segment", movie, *common]) == 0
        assert main(["track", movie, *common, "--use-images"]) == 0
    want = contents(sessions["jax"], 4, 256)
    assert_sessions_equal(contents(sessions["port"], 4, 256), want,
                          drift_atol=1e-4)
    assert np.abs(want["drifts"]).max() > 0.5   # the movie does drift


@pytest.mark.parametrize("path", ["watershed", "unet"])
def test_pipeline_chunked_equals_whole(tmp_path, grid, unet_movie, path):
    if path == "watershed":
        argv = ["pipeline", grid] + SEG
        T, cap = 3, 256
    else:
        _, movie, weights = unet_movie
        argv = unet_argv(movie, weights)
        T, cap = 4, 64
    whole, chunked = str(tmp_path / "whole.seg"), str(tmp_path / "chunked.seg")
    assert port_main(argv + ["--session", whole, "--events"]) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main(argv + ["--session", chunked, "--events",
                                 "--chunk", "2"]) == 0
    assert f"streaming {T} frames in chunks of 2" in out.getvalue()
    assert_sessions_equal(contents(chunked, T, cap), contents(whole, T, cap))


# --- the other front-end pieces -------------------------------------------------------------

class _Store:
    def __init__(self, shape, dtype):
        self.shape, self.num_frames = shape, shape[0]
        self.data = np.empty((0,), dtype)


@pytest.mark.parametrize("shape,dtype,multiple", [
    ((8, 2, 30, 1024, 1024), np.uint16, 2),     # the headline movie: whole
    ((100, 2, 30, 1024, 1024), np.uint16, 2),
    ((100, 2, 40, 2048, 2048), np.uint16, 8),
    ((17, 2, 1, 4096, 4096), np.float32, 8),
    ((40, 2, 44, 1920, 2000), np.float32, 3)])
def test_auto_chunk_frames_matches_jax(shape, dtype, multiple):
    store = _Store(shape, dtype)
    got = tcli._auto_chunk_frames(store, multiple=multiple)
    assert got == jcli._auto_chunk_frames(store, multiple=multiple)
    assert (got == 0) == (shape[0] == 8)


def test_analyze_interactive(port_run, monkeypatch):
    seen = {}
    monkeypatch.setattr(tcli, "_embed_console", lambda ns: seen.update(ns))
    session = os.path.join(port_run[0], "events.seg")
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_main(["analyze", "--session", session, "--capacity", "256",
                          "--frames", "3", "--feature", "area",
                          "--interactive"]) == 0
    assert sorted(seen) == ["args", "df", "tissue"]
    assert len(seen["df"]) == 3 and seen["tissue"].device.type == "cpu"


@pytest.mark.parametrize("unet", [False, True])
def test_warmup_on_cpu_builds_nothing(monkeypatch, unet):
    def no_build(*a, **k):
        raise AssertionError("warmup on the CPU built a kernel")

    monkeypatch.setattr(tdevice, "build_kernels", no_build)
    monkeypatch.setattr(tdevice, "load_library", no_build)
    argv = ["warmup", "--frames", "2", "--size", "64", "--zdepth", "2"]
    if unet:
        argv += ["--unet", "--quantize", "--unet-depth", "2",
                 "--unet-filters", "8", "--unet-batch", "2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main(argv) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("kernel libraries: none on cpu")
    assert lines[-1].startswith("warm cache ready:")
    assert any("unet predictor (2x64x64, depth 2, 8 filters, int8): built in"
               in line for line in lines) == unet


def test_warmup_kernel_sets():
    """The libraries each path launches from: the watershed set, the
    adaptive radii's sweep and the tracker's auction, plus ``cc_scan`` on
    the U-Net path and ``conv_s8`` on its int8 form; the fused projection
    only for a stack its gate accepts."""
    def libs(*argv):
        args = tcli.build_parser().parse_args(["warmup", *argv])
        return sorted(tcli._kernel_libraries(args))

    assert libs() == ["auction", "blur3d", "flood", "projection", "radii"]
    assert libs("--zdepth", "1") == ["auction", "blur3d", "flood", "radii"]
    assert libs("--size", "96") == ["auction", "blur3d", "flood", "radii"]
    assert libs("--unet") == ["auction", "blur3d", "cc_scan", "flood",
                              "projection", "radii"]
    assert libs("--unet", "--quantize") == ["auction", "blur3d", "cc_scan",
                                            "conv_s8", "flood", "projection",
                                            "radii"]


def test_enable_compilation_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(tdevice, "BUILD_DIR", tdevice.BUILD_DIR)
    path = tmp_path / "cache" / "kernels"
    assert enable_compilation_cache(str(path)) == str(path)
    assert path.is_dir() and tdevice.BUILD_DIR == path
    assert tdevice._paths("flood")[1].parent == path
    assert enable_compilation_cache() == str(tdevice.DEFAULT_BUILD_DIR)
    assert tdevice.BUILD_DIR == tdevice.DEFAULT_BUILD_DIR
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        enable_compilation_cache(str(blocker / "sub"))


def test_main_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing.npy")
    session = str(tmp_path / "s.seg")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["pipeline", missing, "--session", session,
                   "--config", str(tmp_path / "missing.json")])
    assert not os.path.exists(session)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["warmup"])


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import tissue_image_processing_tpu_torch.cli\n"
        "import tissue_image_processing_tpu_torch.ops.optical_flow\n"
        "import tissue_image_processing_tpu_torch.viz.napari_viewer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'napari', 'tissue_image_processing_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
