"""Cellpose v2 in the port (``models/cellpose.py``, ``ops/flows.py``, the
``cellpose=`` branch of ``core/pipeline.py``) against the benchmark's plain
reference (``benchmark/reference/cellpose.py``, written from Cellpose v2's
own code: the per-seed growth, the per-mask hole filling loop, the
gather-form diffusion) on the CPU, on the benchmark's seeded weights at a
small size (96^2 to 128^2 frames, 64^2 tiles). Tolerances:

- the network and the tiled eval path in float32: to 2e-5 of the
  reference (the style's mean and the blend in another order);
- flow following, ``get_masks``, the flow check's flows, the hole filling
  and the whole per-frame chain (``follow`` + ``frame_masks``, v2's
  ``compute_masks``): exact, on the reference's flows;
- the flow errors: to 1e-12 (their per-mask sums run in another order);
- ``movie_pipeline(cellpose=...)`` and ``movie_pipeline_chunked``: labels,
  tables, drifts and ids exact against the reference's post-process of the
  port's own (bfloat16) flows, the flows within 0.05 of the reference's
  float32 forward;
- ``state_dict`` files of ``CPnet`` load strictly, the CLI's too.

The benchmark cell's readers and costs are checked at the end. The card's
kernel is held to ``follow_plain`` in ``test_torch_follow_cuda.py``.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.cellpose_weights import cellpose_state
from benchmark.costs.cellpose import tile_flops, tiles_a_frame
from benchmark.movies import make_movie
from benchmark.reference import cellpose as ref
from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.core.pipeline import (
    movie_pipeline, movie_pipeline_chunked)
from tissue_image_processing_tpu_torch.models import cellpose as cp
from tissue_image_processing_tpu_torch.ops import flows as fl

# one intra-op thread: the test workers share the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
SIDE, DIAM, TILE = 96, 24.0, 64
CONFIG = {"reference_channel": 0, "channels": [0, 1], "diameter": DIAM,
          "tile": TILE, "tile_overlap": 0.1, "batch": 2, "niter": 200,
          "cellprob_threshold": 0.0, "flow_threshold": 0.4, "min_size": 15,
          "capacity": 256, "search_range": 100.0, "memory": 3}


def _movie(T=4, side=SIDE, seed=7):
    traffic = json.load(open("benchmark/traffic/preproj_2000.json"))
    traffic.update(height=side, width=side, cell_area_px=200)
    return make_movie(traffic, T, seed, CPU)


def _calibrate(state, flows, share, median_flow):
    """Set the output conv's cell-probability bias and its flow channels'
    gain in ``state`` (in place) from the (3, Y, X) flows of one frame
    under ``state``: a share ``share`` of the frame foreground, the median
    |dP| over it ``median_flow``. A random network's flows then make masks
    at a small size, where training one on the CPU would take minutes."""
    cp_ = flows[2].reshape(-1)
    kth = max(1, int(round((1.0 - share) * cp_.numel())))
    delta = -float(torch.kthvalue(cp_, kth).values)
    fg = (flows[2] + delta) > 0
    gain = median_flow / float(torch.sqrt(flows[0] ** 2
                                          + flows[1] ** 2)[fg].median())
    state["output.2.bias"][2] += delta
    state["output.2.weight"][:2] *= gain
    state["output.2.bias"][:2] *= gain


@pytest.fixture(scope="module")
def setup():
    """The benchmark's seeded initial weights, calibrated on a small
    movie's first frame, the movie, and the reference's float32 flows of
    its frames."""
    state = cellpose_state(21, CPU)
    movie = _movie()
    frames = torch.from_numpy(movie[:, :, 0].astype(np.float32))
    net = ref.reference_net(state, CPU)
    with torch.no_grad():
        first = ref.reference_flows(net, frames[:1], DIAM, tile=TILE)[0]
    _calibrate(state, first, 0.8, 5.0)
    net = ref.reference_net(state, CPU)
    with torch.no_grad():
        flows = ref.reference_flows(net, frames, DIAM, tile=TILE)
    return state, movie, frames, flows


def _config(state, **kw):
    return cp.CellposePredictor(state, diameter=DIAM, tile=TILE, batch=2,
                                device="cpu", **kw).pipeline_config()


# --- the network and the eval path ----------------------------------------------

def test_cpnet_forward_equals_reference(setup):
    state = setup[0]
    port = cp.CPnet()
    port.load_state_dict(state, strict=True)
    x = torch.randn(3, 2, 48, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, style = port.eval()(x)
        want, wstyle = ref.reference_net(state, CPU)(x)
    assert got.shape == (3, 3, 48, 32) and style.shape == (3, 256)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(style, wstyle, rtol=2e-5, atol=2e-6)


def test_state_dict_files_load_strictly(tmp_path, setup):
    state = setup[0]
    net = ref.reference_net(state, CPU)
    path = tmp_path / "cyto_like.pth"
    torch.save(net.state_dict(), path)
    pred = cp.CellposePredictor(str(path), diameter=DIAM, device="cpu")
    names = set(pred.runner.net.state_dict())
    assert names == set(state) and {"diam_mean", "diam_labels"} <= names
    assert pred.runner.diam_mean == 30.0
    broken = dict(state)
    broken.pop("output.2.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        cp.CellposePredictor(broken, device="cpu")


def test_set_up_training_targets_and_steps():
    """The benchmark's set-up training on a small movie: Cellpose's targets
    (5 x unit flows inside the cells read back from the membrane, the cell
    mask), and two steps that move the weights and BatchNorm's statistics
    and keep the keys and dtypes."""
    from benchmark.cellpose_weights import cell_labels, train, training_set

    frames = torch.from_numpy(_movie(T=2)[:, :, 0].astype(np.float32))
    lab = cell_labels(frames[0])
    assert lab.max() > 20 and 0.5 < (lab > 0).mean() < 0.95
    x, y = training_set(frames, DIAM)
    assert x.shape == (2, 2, 128, 128) and y.shape == (2, 3, 128, 128)
    inside = y[:, 2] > 0
    norm = y[:, :2].norm(dim=1)
    assert not norm[~inside].any()
    assert ((norm[inside] - 5.0).abs() < 1e-5).float().mean() > 0.95
    state = cellpose_state(21, CPU)
    deterministic = torch.backends.cudnn.deterministic
    got = train(state, x, y, steps=2, batch=2, tile=64)
    assert torch.backends.cudnn.deterministic == deterministic
    assert {k: v.dtype for k, v in got.items()} == {
        k: v.dtype for k, v in state.items()}
    for key in ("output.2.weight", "output.0.running_mean"):
        assert not torch.equal(got[key], state[key]), key
    assert torch.equal(got["diam_mean"], state["diam_mean"])


@pytest.mark.parametrize("shape,diameter", [((96, 96), 24.0), ((80, 112), 45.0),
                                            ((50, 40), 30.0)])
def test_tiles_and_blend_equal_reference(setup, shape, diameter):
    state = setup[0]
    g = torch.Generator().manual_seed(3)
    frames = 1000 * torch.rand((2, 2) + shape, generator=g)
    runner = cp.CellposeRunner(_config(state) | {"diameter": diameter}, CPU)
    # the eval path around a float32 network, to hold it to the reference's
    net = cp.CPnet()
    net.load_state_dict(state, strict=True)
    runner.net, runner.dtype = net.eval(), torch.float32
    got = runner.blend(runner.forward(runner.tiles(frames)), *shape)
    with torch.no_grad():
        want = ref.reference_flows(ref.reference_net(state, CPU), frames,
                                   diameter, tile=TILE)
    assert got.shape == (2, 3) + shape
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_tile_geometry():
    g = cp.tile_geometry(2000, 2000, 48.0, 30.0)
    assert g["resized"] == (1250, 1250) and g["padded"] == (1264, 1264)
    assert g["pad"] == (7, 7, 7, 7) and g["tile"] == (224, 224)
    assert list(g["ys"]) == [0, 173, 346, 520, 693, 866, 1040]
    assert len(g["ys"]) * len(g["xs"]) == tiles_a_frame(2000, 2000, 48.0) == 49
    small = cp.tile_geometry(50, 40, 30.0, 30.0)
    assert small["padded"] == (64, 48) and small["tile"] == (64, 48)
    assert list(small["ys"]) == [0] and list(small["xs"]) == [0]
    mask = cp._taper_mask(224, 224)
    assert mask.shape == (224, 224) and mask[111, 111] > 0.99
    edge, centre = (1 / (1 + np.exp((abs(i - 111.5) - 92) / 7.5))
                    for i in (0, 111))
    assert mask[0, 111] == pytest.approx(edge * centre, rel=1e-6)


# --- compute_masks, step by step, on the reference's flows ------------------

def _follow_inputs(flows, t=0):
    m = flows[t, 2] > 0
    return ((flows[t, :2] * m) / 5.0), m


def test_follow_plain_equals_reference(setup):
    flows = setup[3]
    d = torch.stack([_follow_inputs(flows, t)[0] for t in range(2)])
    got = fl.follow_plain(d, 200)
    for t in range(2):
        want = ref.follow_flows(d[t], 200)
        assert torch.equal(got[t], want)
    moved = (got[:, :, :, :] != fl.follow_plain(d, 0)).any(1)
    assert int(moved.sum()) > 1000


def test_get_masks_equals_reference(setup):
    flows = setup[3]
    for t in range(flows.shape[0]):
        d, m = _follow_inputs(flows, t)
        p = fl.follow_plain(d[None], 200)[0]
        got, n = fl.get_masks(p, m)
        want = ref.get_masks(p.numpy(), m.numpy())
        assert np.array_equal(got.numpy(), want)
        assert n == int(want.max()) > 10


def _points(spec, shape=(40, 40)):
    """A position field where each (y, x, count) of ``spec`` gathers
    ``count`` pixels of a square block at (y, x)."""
    p = torch.stack(torch.meshgrid(torch.arange(shape[0]),
                                   torch.arange(shape[1]),
                                   indexing="ij")).to(torch.float32)
    m = torch.zeros(shape, dtype=torch.bool)
    at = 0
    for y, x, count in spec:
        flat = torch.arange(at, at + count)
        p[0].view(-1)[flat], p[1].view(-1)[flat] = y + 0.5, x + 0.25
        m.view(-1)[flat] = True
        at += count
    return p, m


@pytest.mark.parametrize("spec", [
    [(5, 5, 30), (30, 30, 12), (5, 6, 11)],       # a tie merges; 12 seeds
    [(20, 20, 700)],                              # over 40%: dropped
    [(3, 30, 9), (10, 10, 40)],                   # 9 is no seed
])
def test_get_masks_on_made_up_positions(spec):
    p, m = _points(spec)
    got, n = fl.get_masks(p, m)
    want = ref.get_masks(p.numpy(), m.numpy())
    assert np.array_equal(got.numpy(), want) and n == int(want.max())


def test_flow_check_equals_reference(setup):
    flows = setup[3]
    d, m = _follow_inputs(flows, 1)
    labels, n = fl.get_masks(fl.follow_plain(d[None], 200)[0], m)
    mu, n_iter = fl.masks_to_flows(labels, n)
    want = ref.masks_to_flows(labels.numpy(), CPU)
    assert np.array_equal(mu.numpy(), want)
    err = fl.flow_error(labels, flows[1, :2], n)[1:].numpy()
    dp = flows[1, :2].numpy()
    want_err = sum(__import__("scipy.ndimage").ndimage.mean(
        (want[i] - dp[i] / 5.) ** 2, labels.numpy(),
        index=np.arange(1, n + 1)) for i in range(2))
    np.testing.assert_allclose(err, want_err, rtol=1e-12, atol=0)
    got = fl.remove_bad_flow_masks(labels, flows[1, :2], n)
    assert np.array_equal(got.numpy(), ref.remove_bad_flow_masks(
        labels.numpy(), dp, 0.4, CPU))
    assert 100 < n_iter < 1000


def _rings():
    """Label maps where masks enclose masks: nested rings, a mask inside
    an earlier and a later mask's hole, a mask split across a hole, a
    diagonal ring, small masks, absent labels, masks on the frame edge."""
    a = np.zeros((40, 48), np.int32)
    a[2:14, 2:14] = 1
    a[4:12, 4:12] = 0
    a[6:10, 6:10] = 2               # inside 1's hole: filled over
    a[2:16, 20:34] = 5
    a[4:14, 22:32] = 0
    a[6:12, 24:30] = 3              # earlier label inside a later ring
    a[8:10, 26:28] = 0              # a hole in 3 too
    a[20:36, 2:18] = 6
    a[22:34, 4:16] = 0
    a[24:32, 6:14] = 7              # 7 is a ring inside 6 ...
    a[26:30, 8:12] = 8              # ... around 8
    a[26:30, 40:46] = 7             # and 7 has a part outside 6
    a[30:40, 30:34] = 9             # on the frame edge, with a notch
    a[39, 31:33] = 0
    a[0:3, 40:43] = 10              # small: dropped
    yy, xx = np.mgrid[:40, :48]
    a[(np.abs(yy - 20) + np.abs(xx - 40) == 4)] = 11    # a diagonal ring
    b = np.zeros((30, 30), np.int32)
    b[1:29, 1:29] = 2               # a later ring ...
    b[3:27, 3:27] = 1               # ... around an earlier ring ...
    b[5:25, 5:25] = 0
    b[10:20, 10:20] = 3             # ... around a third mask
    b[12:18, 12:18] = 0
    return [a, b]


@pytest.mark.parametrize("case", range(2))
def test_hole_filling_equals_v2_loop_where_masks_nest(case):
    labels = _rings()[case]
    got, kept = fl.fill_holes_and_remove_small_masks(torch.from_numpy(labels),
                                                     int(labels.max()))
    want = ref.fill_holes_and_remove_small_masks(labels)
    assert np.array_equal(got.numpy(), want)
    assert kept == int(want.max())      # the last kept mask keeps its number


def test_hole_filling_equals_v2_loop_on_random_blobs():
    rng = np.random.default_rng(5)
    for _ in range(4):
        lab = np.zeros((64, 64), np.int32)
        for k in range(1, 30):
            y, x = rng.integers(0, 56, 2)
            h, w = rng.integers(2, 16, 2)
            blob = rng.random((h, w)) < 0.8
            region = lab[y:y + h, x:x + w]
            region[blob[:region.shape[0], :region.shape[1]]] = k
        got, _ = fl.fill_holes_and_remove_small_masks(torch.from_numpy(lab),
                                                      int(lab.max()))
        assert np.array_equal(got.numpy(),
                              ref.fill_holes_and_remove_small_masks(lab))


def _compute_masks(dP, cellprob, span=None):
    """The port's masks of one frame as the pipeline makes them: ``follow``,
    then ``frame_masks``."""
    p, m, followed = fl.follow(dP[None], cellprob[None])
    return fl.frame_masks(p[0], m[0], dP, int(followed[0]), span=span)


def test_compute_masks_equals_reference(setup):
    flows = setup[3]
    _device.reset_launches()
    spans = []

    def span(name):
        spans.append(name)
        return __import__("contextlib").nullcontext()
    for t in range(2):
        got = _compute_masks(flows[t, :2], flows[t, 2], span)
        want = ref.compute_masks(flows[t, :2], flows[t, 2])
        assert torch.equal(got, want)
    assert spans == ["masks", "flow_qc", "masks"] * 2
    c = _device.COUNTS
    assert c["cp_masks_found"] > 20 and c["qc_iters"] > 100
    assert c["follow_px"] > 1000 and c["cp_masks_kept"] >= 0


def test_compute_masks_without_cells():
    z = torch.zeros((2, 20, 20))
    assert not _compute_masks(z, torch.full((20, 20), -1.0)).any()
    d = torch.zeros((2, 20, 20))
    d[0, 3, 4:7] = 5.0               # 3 followed pixels: fewer than 5
    assert not _compute_masks(d, torch.ones((20, 20))).any()


# --- the pipeline branch ----------------------------------------------------

def _program(make, state, movie):
    """The benchmark's program (or control) on ``movie`` with ``state`` in
    place of the network its set-up trains on the card."""
    import benchmark.programs.cellpose_pipeline as program

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(program, "trained_state", lambda config, device: state)
        return make(dict(CONFIG, weights_seed=21), [movie], CPU)


@pytest.fixture(scope="module")
def port_run(setup):
    state, movie = setup[0], setup[1]
    from benchmark.programs.cellpose_pipeline import Program
    prog = _program(Program, state, movie)
    timings = {}
    _device.reset_launches()
    out = prog.kept_call(movie, timings)
    counts = dict(_device.COUNTS)
    return prog, movie, out, timings, counts


def test_pipeline_branch_equals_reference(port_run):
    prog, movie, out, _, _ = port_run
    assert out["labels"].shape == (4, SIDE, SIDE)
    assert out["flows"].shape == (4, 3, SIDE, SIDE)
    numbers = prog.check(movie, out)
    assert 0.0 < numbers["prob_gap"] < 0.05
    assert {k: v for k, v in numbers.items() if k != "prob_gap"} == {
        "labels_mismatch": 0.0, "tables_mismatch": 0.0, "drift_gap": 0.0,
        "ids_mismatch": 0.0}
    assert int(out["seeds"].max()) > 10


def test_pipeline_spans_and_counters(port_run):
    _, movie, out, timings, counts = port_run
    assert {"upload", "cp_tiles", "cpnet", "follow", "masks", "flow_qc",
            "tables", "drift", "adaptive_radii", "track"} == set(timings)
    assert counts["cp_tiles"] == 4 * 9
    assert counts["cp_masks_found"] == int(
        sum(int(s.max()) for s in out["seeds"]))
    assert counts["follow_px"] > 0 and counts["qc_iters"] > 0
    assert "cp_masks_kept" in counts


def test_chunked_equals_whole(port_run, setup):
    prog, movie, out, _, _ = port_run
    kw = {k: v for k, v in prog.kwargs.items() if k != "device"}
    whole = movie_pipeline(movie, device="cpu", **kw)
    chunked = movie_pipeline_chunked(movie, chunk_frames=2, device="cpu", **kw)
    assert torch.equal(whole["labels"], out["labels"])
    assert np.array_equal(chunked["labels"], whole["labels"].numpy())
    assert np.array_equal(chunked["ids"], whole["ids"])
    np.testing.assert_array_equal(chunked["drifts"], whole["drifts"])
    for name in ("area", "cx", "cy", "valid", "neighbors"):
        assert torch.equal(getattr(chunked["tables"], name),
                           getattr(whole["tables"], name))


def test_control_reads_above_the_sound_run(port_run):
    from benchmark.programs.cellpose_pipeline import control, flow_gap
    prog, movie, out, _, _ = port_run
    low = _program(control, prog.state, movie)
    got = low.kept_call(movie)
    numbers = prog.check(movie, got)
    assert numbers["prob_gap"] > 3 * prog.check(movie, out)["prob_gap"]
    assert flow_gap(None, out["flows"]) == float("inf")


def test_unet_and_cellpose_are_exclusive(port_run):
    prog, movie = port_run[:2]
    with pytest.raises(ValueError, match="not both"):
        movie_pipeline(movie, device="cpu", unet={"params": {}},
                       cellpose=prog.kwargs["cellpose"])


def test_the_kernel_is_not_imported_off_the_branch():
    code = ("import sys, tissue_image_processing_tpu_torch.core.pipeline; "
            "print('tissue_image_processing_tpu_torch.ops.flows_cuda' "
            "in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "False"


def test_cli_pipeline_cellpose(tmp_path, setup):
    import tissue_image_processing_tpu_torch.cli as tcli
    from tissue_image_processing_tpu_torch.core.tissue import Tissue

    state, movie = setup[0], setup[1]
    weights = tmp_path / "cyto.pth"
    torch.save(ref.reference_net(state, CPU).state_dict(), weights)
    path = tmp_path / "movie.npy"
    np.save(path, movie[:2])
    session = str(tmp_path / "out.seg")
    assert tcli.main(["pipeline", str(path), "--cellpose", str(weights),
                      "--cp-diameter", str(DIAM), "--capacity", "256",
                      "--session", session], device="cpu") == 0
    cfg = cp.CellposePredictor(str(weights), diameter=DIAM, device="cpu",
                               batch=2).pipeline_config()
    want = movie_pipeline(movie[:2], capacity=256, device="cpu",
                          cellpose=cfg)
    tissue = Tissue(2, "check", capacity=256, device="cpu")
    for _ in tissue.load(session):
        pass
    for f in range(2):
        assert np.array_equal(np.asarray(tissue.get_labels(f + 1)),
                              want["labels"][f].numpy())
    np.testing.assert_array_equal(tissue.drifts[:2], want["drifts"])


# --- the benchmark cell's costs and readers ---------------------------------

def test_costs_and_readers():
    from types import SimpleNamespace

    from benchmark.costs import follow, peaks
    from benchmark.run import reader
    from benchmark.tests.helpers import ROOT
    from benchmark.trace import Trace

    assert tile_flops() / 1e9 == pytest.approx(31.0, abs=0.01)
    cfg = json.load(open("benchmark/configs/utricle_cellpose.json"))
    ns = 10 ** 9
    tr = Trace(kernels=[("follow_kernel(float const*)", 0, ns),
                        ("other", ns, 2 * ns)], window=(0, 4 * ns))
    ctx = SimpleNamespace(config=cfg, traffic={"height": 2000,
                                               "width": 2000},
                          trace=tr, traced_frames=16, frames=40,
                          timings={"cpnet": 2.0})
    counts = {"follow_px": 40 * 3_000_000, "cp_tiles": 40 * 49,
              "qc_iters": 40 * 300}
    old = _device.COUNTS
    _device.COUNTS = counts
    try:
        def read(name):
            return reader(ROOT, name)(ctx, name)
        least = follow.least_follow_seconds(16 * 4e6, 16 * 3e6, 200)
        # operations bound, at the unfused float32 rate: 33.5 T a second
        assert least == pytest.approx(32 * 16 * 3e6 * 200 / 33.5e12)
        assert read("follow_roofline") == pytest.approx(100 * least)
        assert read("peak_share.cpnet") == pytest.approx(
            100 * tile_flops() * 40 * 49 / (peaks.BF16_FLOPS * 2.0))
        assert read("mfu.cellpose_infer") == pytest.approx(
            100 * tile_flops() * 49 * 16 / (peaks.BF16_FLOPS * 4.0))
        assert read("qc_iters") == 300 and read("follow_px") == 3e6
        _device.COUNTS = {}
        assert read("follow_roofline") is None
        assert read("peak_share.cpnet") is None and read("qc_iters") is None
    finally:
        _device.COUNTS = old
