"""PyTorch port vs the JAX package: the whole watershed movie pipeline.

A pre-projected (Z == 1) drifting membrane movie goes through both
``movie_pipeline``s. The blur is not bit-exact across frameworks (XLA fuses
its multiply-adds) and round-off can flip plateau ties, so labels must agree
on >= 99.5% of pixels with per-cell Dice >= 0.99, and track ids are compared
through the label matching. The port's chunked run must equal its unchunked
run exactly. A raw z-stack movie (Z > 1, uint16, with and without the
airyscan offset) goes through both packages too: each projects every frame
(on the CPU both take the unfused route), and there the runs agree exactly.
The U-Net branch (``unet=``) goes through both packages with the same
weights on Z == 1 and Z > 1 movies; there labels, tables and ids are equal and
drifts agree to 1e-4 (see ``passthrough_variables`` for why the comparison
can be exact); with ``{"quantized": True}`` both packages run the int8
forward on the same int8 parameters (from the JAX quantizer), whole and
chunked, under the watershed branch's criteria. Also: the package imports no
JAX, asking for the card without one raises, the stages are profiler spans
that agree with ``timings``, and the movie's uploaded bytes are counted.
"""

import collections
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tissue_image_processing_tpu.core.pipeline import movie_pipeline as j_pipe
from tissue_image_processing_tpu.ops.brightness import (
    normalize_channel as j_normalize)
from tissue_image_processing_tpu_torch.models.predictor import (
    prepare_batch, unet_from_config)
from tissue_image_processing_tpu_torch.utils.state import (
    quant_params_from_jax, unet_state_from_flax)
from tissue_image_processing_tpu_torch.core.pipeline import (
    movie_pipeline as t_pipe, movie_pipeline_chunked as t_pipe_chunked)
from tissue_image_processing_tpu_torch import _device, resolve_device

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

KW = dict(capacity=96, block_size=31, batch=2)


def _movie(T=6, C=2, Z=1, H=128, W=128, seed=0):
    """Drifting synthetic membrane movie (the recipe of
    tests/test_pipeline_chunked.py, pre-projected)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    n_cells = 24
    pts = np.stack([rng.uniform(0, H, n_cells), rng.uniform(0, W, n_cells)], 1)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (Z / 2 + (Z / 4) * np.sin(yy / 31.0) * np.cos(xx / 47.0)).astype(
        np.float32)
    zz = np.arange(Z, dtype=np.float32).reshape(Z, 1, 1)
    zprof = np.exp(-((zz - depth) ** 2) / 2.0)
    frames = np.empty((T, C, Z, H, W), np.float32)
    for t in range(T):
        p = pts + t * np.array([1.0, -0.7]) + rng.normal(0, 0.1, pts.shape)
        d, _ = cKDTree(p).query(np.stack([yy.ravel(), xx.ravel()], 1), k=2)
        ridge = np.exp(-((d[:, 1] - d[:, 0]) ** 2) / 8.0).reshape(H, W)
        frames[t, 0] = ridge[None] * zprof * 50000 + rng.normal(0, 200, (Z, H, W))
        for c in range(1, C):
            frames[t, c] = (1 - ridge)[None] * zprof * 20000
    return np.clip(frames, 0, 65535).astype(np.float32)


@pytest.fixture(scope="module")
def movie():
    return _movie()


@pytest.fixture(scope="module")
def port_whole(movie):
    return t_pipe(movie, device="cpu", **KW)


def _match(got, want):
    """Majority-overlap map from each port label to a JAX label, and the
    per-cell Dice of each pair."""
    mapping, dice = {}, []
    for lab in np.unique(got):
        if lab == 0:
            continue
        m = got == lab
        cand = np.bincount(want[m])
        cand[0] = 0
        if cand.max() == 0:
            dice.append(0.0)
            continue
        w = int(cand.argmax())
        mapping[int(lab)] = w
        dice.append(2 * cand[w] / (m.sum() + (want == w).sum()))
    return mapping, dice


def _assert_matches_jax(got, want):
    """Labels on >= 99.5% of pixels, per-cell Dice >= 0.99, drifts to 1e-4,
    and >= 99% of the matched cells' ids consistent."""
    wl, gl = np.asarray(want["labels"]), got["labels"].numpy()
    assert gl.shape == wl.shape
    assert (gl == wl).mean() >= 0.995
    np.testing.assert_allclose(got["drifts"], np.asarray(want["drifts"]),
                               atol=1e-4)
    pairs, total = 0, 0
    id_map = {}
    for t in range(gl.shape[0]):
        mapping, dice = _match(gl[t], wl[t])
        assert min(dice) >= 0.99, (t, min(dice))
        for lab, w in mapping.items():
            gi, wi = got["ids"][t, lab - 1], want["ids"][t, w - 1]
            if gi == 0 and wi == 0:
                continue
            total += 1
            pairs += id_map.setdefault(gi, wi) == wi
    assert total > 0 and pairs / total >= 0.99


def test_pipeline_matches_jax(movie, port_whole):
    _assert_matches_jax(port_whole, j_pipe(jnp.asarray(movie), **KW))


def _assert_runs_equal(got, want):
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"].numpy())
    np.testing.assert_array_equal(got["ids"], want["ids"])
    for field in ("area", "perimeter", "cx", "cy", "label", "valid",
                  "n_neighbors", "neighbors", "bbox"):
        np.testing.assert_array_equal(getattr(got["tables"], field).numpy(),
                                      getattr(want["tables"], field).numpy(),
                                      err_msg=field)
    np.testing.assert_array_equal(got["drifts"], want["drifts"])


@pytest.mark.parametrize("batch", [1, 4])
def test_flood_batch_leaves_results_unchanged(movie, port_whole, batch):
    """T = 6 flooded in groups of 1 and of 4 (a short last group of 2)
    equals the groups of 2 of ``port_whole`` exactly."""
    _assert_runs_equal(t_pipe(movie, device="cpu", **{**KW, "batch": batch}),
                       port_whole)


def test_ragged_flood_batch_matches_jax(movie):
    """T % batch != 0: the port floods 4 + 2 frames, the JAX package groups
    of _flood_batch(6, 4) = 3; the runs agree under the criteria above."""
    kw = {**KW, "batch": 4}
    _assert_matches_jax(t_pipe(movie, device="cpu", **kw),
                        j_pipe(jnp.asarray(movie), **kw))


@pytest.mark.parametrize("chunk", [3, 7])
def test_chunked_equals_unchunked(movie, port_whole, chunk):
    got = t_pipe_chunked(movie, chunk_frames=chunk, device="cpu", **KW)
    np.testing.assert_array_equal(got["ids"], port_whole["ids"])
    np.testing.assert_array_equal(got["labels"], port_whole["labels"].numpy())
    np.testing.assert_array_equal(got["tables"].area.numpy(),
                                  port_whole["tables"].area.numpy())
    np.testing.assert_array_equal(got["drifts"], port_whole["drifts"])


def test_chunked_without_labels(movie, port_whole):
    """``keep_labels=False``: no labels come back, everything else is the
    whole run's; an ``on_chunk`` receives each chunk's labels."""
    got = t_pipe_chunked(movie, chunk_frames=4, keep_labels=False,
                         device="cpu", **KW)
    assert got["labels"] is None
    np.testing.assert_array_equal(got["ids"], port_whole["ids"])
    np.testing.assert_array_equal(got["tables"].area.numpy(),
                                  port_whole["tables"].area.numpy())
    seen = {}
    t_pipe_chunked(movie, chunk_frames=4, keep_labels=False, device="cpu",
                   on_chunk=lambda t0, out: seen.update({t0: out["labels"]}),
                   **KW)
    np.testing.assert_array_equal(np.concatenate([seen[0], seen[4]]),
                                  port_whole["labels"].numpy())


def test_stage_timings_leave_results_unchanged(movie, port_whole):
    timings = {}
    got = t_pipe(movie, device="cpu", timings=timings, **KW)
    assert sorted(timings) == sorted(["upload", "segment", "tables", "drift",
                                      "adaptive_radii", "track"])
    assert all(v >= 0.0 for v in timings.values())
    np.testing.assert_array_equal(got["ids"], port_whole["ids"])
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  port_whole["labels"].numpy())


def test_import_pulls_in_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import tissue_image_processing_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'tissue_image_processing_tpu_torch.models.unet' in sys.modules\n"
        "assert 'tissue_image_processing_tpu_torch.models.predictor' in sys.modules\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'tissue_image_processing_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_cuda_without_card_raises(movie, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        t_pipe(movie[:2], **KW)


def _zmovie(airyscan: bool):
    """(4, 2, 6, 128, 128) uint16 raw z-stack movie; with ``airyscan`` the
    intensities carry the airyscan offset."""
    mv = _movie(T=4, Z=6, seed=3)
    return np.clip(mv + (10000.0 if airyscan else 0.0), 0, 65535).astype(np.uint16)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "airyscan"])
def zcase(request):
    mv = _zmovie(request.param)
    return mv, request.param, t_pipe(mv, device="cpu", airyscan=request.param,
                                      **KW)


def test_z_stack_pipeline_matches_jax(zcase):
    """Both packages project every frame (the unfused route on the CPU) and
    segment and track the projections; the runs agree exactly."""
    from tissue_image_processing_tpu.projection.surface import (
        project_timepoint_auto as j_proj)
    from tissue_image_processing_tpu_torch.projection.surface import (
        project_timepoint_auto as t_proj)

    mv, airyscan, got = zcase
    for t in range(mv.shape[0]):
        wp, wz = j_proj(jnp.asarray(mv[t]), airyscan=airyscan)
        gp, gz = t_proj(torch.from_numpy(mv[t]), airyscan=airyscan)
        np.testing.assert_array_equal(gz.numpy(), np.asarray(wz))
        np.testing.assert_allclose(gp[0].numpy(), np.asarray(wp)[0],
                                   rtol=1e-4, atol=1e-3)
    want = j_pipe(jnp.asarray(mv), airyscan=airyscan, **KW)
    gl, wl = got["labels"].numpy(), np.asarray(want["labels"])
    assert gl.shape == wl.shape == (4, 128, 128)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["tables"].area.numpy(),
                                  np.asarray(want["tables"].area))
    np.testing.assert_allclose(got["drifts"], np.asarray(want["drifts"]),
                               atol=1e-4)


def test_z_stack_chunked_equals_unchunked(zcase):
    mv, airyscan, whole = zcase
    got = t_pipe_chunked(mv, chunk_frames=3, device="cpu", airyscan=airyscan,
                         **KW)
    np.testing.assert_array_equal(got["ids"], whole["ids"])
    np.testing.assert_array_equal(got["labels"], whole["labels"].numpy())
    np.testing.assert_array_equal(got["tables"].area.numpy(),
                                  whole["tables"].area.numpy())
    np.testing.assert_array_equal(got["drifts"], whole["drifts"])


def test_z_stack_timings_include_projection(zcase):
    mv, airyscan, whole = zcase
    timings = {}
    got = t_pipe(mv, device="cpu", airyscan=airyscan, timings=timings, **KW)
    assert sorted(timings) == sorted(["upload", "project", "segment", "tables",
                                      "drift", "adaptive_radii", "track"])
    np.testing.assert_array_equal(got["labels"].numpy(), whole["labels"].numpy())


def _profiled(run):
    """``run()`` under the CPU profiler inside a ``test.call`` range: its
    result, the thread ids of that range, and the ``stage.*`` events as
    (name, seconds, thread id)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.call"):
            out = run()
    events = list(prof.profiler.kineto_results.events())
    tids = {ev.start_thread_id() for ev in events if ev.name() == "test.call"}
    stages = [(ev.name(), ev.duration_ns() * 1e-9, ev.start_thread_id())
              for ev in events if ev.name().startswith("stage.")]
    return out, tids, stages


@pytest.mark.parametrize("case", ["z_stack", "unet"])
def test_stage_spans_on_the_profiler_clock(movie, case):
    """With ``timings`` every stage is a ``stage.<key>`` event on the
    calling thread whose summed length is the stage's seconds; without
    ``timings`` there is none. The run counts the movie's host bytes
    uploaded: every frame of a Z > 1 movie, every channel's plane of a
    Z == 1 movie on the U-Net branch."""
    if case == "z_stack":
        mv, kw = _zmovie(False), KW
        uploaded = sum(mv[t].nbytes for t in range(mv.shape[0]))
    else:
        mv, kw = movie, dict(KW, unet=_unet_configs()[1])
        uploaded = mv[:, :, 0].nbytes
    timings = {}
    _device.reset_launches()
    _, tids, stages = _profiled(
        lambda: t_pipe(mv, device="cpu", timings=timings, **kw))
    assert _device.COUNTS["upload_bytes"] == uploaded
    assert len(tids) == 1 and {tid for *_, tid in stages} == tids
    summed = collections.Counter()
    for name, seconds, _ in stages:
        summed[name[len("stage."):]] += seconds
    assert set(summed) == set(timings)
    if case == "unet":
        assert set(timings) == {"upload", "normalize", "unet", "postprocess",
                                "tables", "drift", "adaptive_radii", "track"}
    for key, seconds in timings.items():
        assert abs(summed[key] - seconds) <= 0.1 * seconds + 1e-3, (
            key, summed[key], seconds)
    _, _, stages = _profiled(lambda: t_pipe(mv, device="cpu", **kw))
    assert stages == []


@pytest.mark.parametrize("source", ["numpy", "tensor"])
def test_upload_bytes_count_the_host_bytes(movie, source):
    """The watershed branch on a Z == 1 movie uploads the reference
    channel's plane alone; a movie already a tensor on the device counts
    nothing."""
    mv = movie[:3]
    _device.reset_launches()
    t_pipe(mv if source == "numpy" else torch.from_numpy(mv), device="cpu",
           **KW)
    want = mv[:, [0], 0].nbytes if source == "numpy" else 0
    assert _device.COUNTS["upload_bytes"] == want


@pytest.mark.cuda
def test_pipeline_on_card_matches_cpu(movie, port_whole):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = t_pipe(movie, device="cuda", **KW)
    assert (got["labels"].cpu().numpy()
            == port_whole["labels"].numpy()).mean() >= 0.995


@pytest.mark.cuda
def test_z_stack_pipeline_on_card_matches_cpu():
    # 96^2 is refused by the fused gate, so card and CPU take the same route
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mv = _movie(T=4, Z=6, H=96, W=96, seed=4).astype(np.uint16)
    got = t_pipe(mv, device="cuda", **KW)
    want = t_pipe(mv, device="cpu", **KW)
    assert (got["labels"].cpu().numpy() == want["labels"].numpy()).mean() >= 0.995


# --- the U-Net branch -----------------------------------------------------------

UNET_DEPTH, UNET_FILTERS = 2, 8
# HC (p0 > 0.1) where the normalised channel 1 exceeds 217.5 / 256 (about half
# of the pixels of these movies, ~45 labels a frame): the threshold sits
# midway between two neighbouring bfloat16 values
_GAIN, _CUT = 64.0, 217.5 / 256


def passthrough_variables(depth=UNET_DEPTH, base_filters=UNET_FILTERS):
    """Flax variables (``norm="shift"``) of a U-Net that passes input channel
    1 through its first and last blocks and skip connection by centre taps of
    1, with every other weight 0, and reads the logits ``(GAIN * x - c, 0)``
    off it.

    Every conv output then is a sum with ONE nonzero term, so the bfloat16
    forward does not depend on the order of summation and the two frameworks
    agree to the last bit of the logits; only the softmax differs (1e-7). The
    pipeline comparison therefore tests everything around the convolutions
    exactly — normalisation, layout, padding, crop, post-process, flood,
    tables, drift, tracking — while ``tests/test_torch_unet.py`` holds the
    convolutions themselves to Flax on random weights."""
    f = base_filters
    n_blocks = 2 * depth + 1
    widths = [f * 2 ** i for i in range(depth)]
    cin = [2] + widths[:-1] + [widths[-1]] + [2 * w for w in reversed(widths)]
    cout = widths + [2 * widths[-1]] + list(reversed(widths))
    params = {}
    for k in range(n_blocks):
        params[f"DoubleConv_{k}"] = {
            "Conv_0": {"kernel": np.zeros((3, 3, cin[k], cout[k]), np.float32),
                       "bias": np.zeros(cout[k], np.float32)},
            "Conv_1": {"kernel": np.zeros((3, 3, cout[k], cout[k]), np.float32),
                       "bias": np.zeros(cout[k], np.float32)},
            "Shift_0": np.zeros(cout[k], np.float32),
            "Shift_1": np.zeros(cout[k], np.float32)}
    for j, w in enumerate(reversed(widths)):
        params[f"ConvTranspose_{j}"] = {
            "kernel": np.zeros((3, 3, 2 * w, w), np.float32),
            "bias": np.zeros(w, np.float32)}
    first, last = params["DoubleConv_0"], params[f"DoubleConv_{n_blocks - 1}"]
    first["Conv_0"]["kernel"][1, 1, 1, 0] = 1.0   # input channel 1 -> feature 0
    first["Conv_1"]["kernel"][1, 1, 0, 0] = 1.0
    last["Conv_0"]["kernel"][1, 1, f, 0] = 1.0    # the skip half of the concat
    last["Conv_1"]["kernel"][1, 1, 0, 0] = 1.0
    head = np.zeros((1, 1, f, 2), np.float32)
    head[0, 0, 0, 0] = _GAIN
    logit_cut = np.log(0.1 / 0.9)                  # p0 == 0.1
    params["Conv_0"] = {"kernel": head, "bias": np.array(
        [logit_cut - _GAIN * _CUT, 0.0], np.float32)}
    return {"params": params}


def _unet_configs(batch=2):
    variables = passthrough_variables()
    common = {"depth": UNET_DEPTH, "base_filters": UNET_FILTERS,
              "norm": "shift", "batch": batch}
    return ({"params": variables, **common},
            {"params": unet_state_from_flax(variables), **common})


def _assert_forward_margin(projections, cfg_j, cfg_t):
    """The guard behind the exact comparison: on these frames no probability
    lies as close to the 0.1 threshold as the two forwards lie apart."""
    # imported here: the model module needs flax, which a machine that only
    # runs the card-marked tests may lack
    from tissue_image_processing_tpu.models.unet import UNet as JUNet

    prj = np.asarray(projections, np.float32)
    xj = jnp.transpose(jax.vmap(jax.vmap(j_normalize))(jnp.asarray(prj)),
                       (0, 3, 2, 1)).astype(jnp.bfloat16)
    pj = np.asarray(JUNet(depth=UNET_DEPTH, base_filters=UNET_FILTERS,
                          dtype=jnp.bfloat16, norm="shift")
                    .apply(cfg_j["params"], xj, train=False))[..., 0]
    xt, _ = prepare_batch(torch.from_numpy(prj))
    with torch.no_grad():
        pt = unet_from_config(cfg_t, torch.device("cpu"))(xt)[..., 0].numpy()
    err = np.abs(pt - pj).max()
    margin = np.abs(pj - 0.1).min()
    assert err < 1e-5 and margin > 100 * err, (err, margin)
    share = (pj > 0.1).mean()
    assert 0.2 < share < 0.8, share


def _assert_unet_runs_equal(got, want, min_cells=8):
    gl, wl = got["labels"].numpy(), np.asarray(want["labels"])
    assert gl.shape == wl.shape
    np.testing.assert_array_equal(gl, wl)
    assert min(int(l.max()) for l in gl) >= min_cells
    np.testing.assert_array_equal(got["ids"], want["ids"])
    for field in ("area", "perimeter", "cx", "cy", "label", "valid",
                  "n_neighbors", "neighbors", "bbox"):
        np.testing.assert_array_equal(
            getattr(got["tables"], field).numpy(),
            np.asarray(getattr(want["tables"], field)), err_msg=field)
    np.testing.assert_array_equal(got["neighbor_overflow"],
                                  want["neighbor_overflow"])
    np.testing.assert_allclose(got["drifts"], np.asarray(want["drifts"]),
                               atol=1e-4)
    assert np.abs(got["drifts"][1:]).max() > 0.3   # the movie does drift


@pytest.fixture(scope="module")
def unet_whole(movie):
    cfg_j, cfg_t = _unet_configs()
    return cfg_j, cfg_t, t_pipe(movie, unet=cfg_t, device="cpu", **KW)


def test_unet_pipeline_matches_jax(movie, unet_whole):
    cfg_j, cfg_t, got = unet_whole
    _assert_forward_margin(movie[:, :, 0], cfg_j, cfg_t)
    want = j_pipe(jnp.asarray(movie), unet=cfg_j, capacity=KW["capacity"])
    _assert_unet_runs_equal(got, want)


def test_unet_z_stack_pipeline_matches_jax():
    """A raw Z > 1 movie: every channel is projected (the model input is the
    channel pair), normalised and segmented; drifts come from the y-major
    projection with swapped columns."""
    from tissue_image_processing_tpu_torch.projection.surface import (
        project_timepoint_auto as t_proj)

    mv = _zmovie(False)
    cfg_j, cfg_t = _unet_configs()
    prj = np.stack([t_proj(torch.from_numpy(f))[0].numpy() for f in mv])
    _assert_forward_margin(prj, cfg_j, cfg_t)
    got = t_pipe(mv, unet=cfg_t, device="cpu", **KW)
    want = j_pipe(jnp.asarray(mv), unet=cfg_j, capacity=KW["capacity"])
    _assert_unet_runs_equal(got, want)


def test_unet_drift_columns_follow_the_labels(movie, unet_whole):
    """The watershed branch measures drift on x-major frames, the U-Net
    branch on the y-major projection with the columns swapped: on the same
    movie the two chains must agree."""
    _, _, got = unet_whole
    ws = t_pipe(movie, device="cpu", **KW)
    np.testing.assert_allclose(got["drifts"], ws["drifts"], atol=0.05)


@pytest.mark.parametrize("chunk", [3, 4])
def test_unet_chunked_equals_unchunked(movie, unet_whole, chunk):
    _, cfg_t, whole = unet_whole
    got = t_pipe_chunked(movie, chunk_frames=chunk, unet=cfg_t, device="cpu",
                         **KW)
    np.testing.assert_array_equal(got["ids"], whole["ids"])
    np.testing.assert_array_equal(got["labels"], whole["labels"].numpy())
    np.testing.assert_array_equal(got["tables"].area.numpy(),
                                  whole["tables"].area.numpy())
    np.testing.assert_allclose(got["drifts"], whole["drifts"], atol=1e-4)


def test_unet_chunked_channels_select_the_model_pair(movie, unet_whole):
    """``channels=`` picks the (atoh, zo) pair out of a wider store."""
    _, cfg_t, whole = unet_whole
    wide = np.concatenate([np.zeros_like(movie[:, :1]), movie[:, :1],
                           movie[:, :1] * 0.5, movie[:, 1:]], axis=1)
    got = t_pipe_chunked(wide, chunk_frames=4, unet=cfg_t, channels=[1, 3],
                         device="cpu", **KW)
    np.testing.assert_array_equal(got["ids"], whole["ids"])
    np.testing.assert_array_equal(got["labels"], whole["labels"].numpy())


def test_unet_batch_size_leaves_results_unchanged(movie, unet_whole):
    _, cfg_t, whole = unet_whole
    timings = {}
    got = t_pipe(movie, unet={**cfg_t, "batch": 4}, device="cpu",
                 timings=timings, **KW)   # T = 6: groups of 3
    assert sorted(timings) == sorted(["upload", "normalize", "unet",
                                      "postprocess", "tables", "drift",
                                      "adaptive_radii", "track"])
    np.testing.assert_array_equal(got["ids"], whole["ids"])
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  whole["labels"].numpy())


@pytest.fixture(scope="module")
def quantized_runs(movie):
    """The pass-through U-Net quantized by the JAX package on the movie's
    first two normalised frames, as both packages' pipeline configs, and
    the JAX pipeline's run with it."""
    from tissue_image_processing_tpu.models.quant import quantize_unet

    variables = passthrough_variables()
    sample, _ = prepare_batch(torch.from_numpy(movie[:2, :, 0]))
    qj = jax.device_get(quantize_unet(variables, jnp.asarray(sample.numpy()),
                                      depth=UNET_DEPTH))
    common = {"quantized": True, "depth": UNET_DEPTH,
              "base_filters": UNET_FILTERS, "norm": "shift", "batch": 2}
    cfg_j = {"params": qj, **common}
    cfg_t = {"params": quant_params_from_jax(qj), **common}
    want = j_pipe(jnp.asarray(movie), unet=cfg_j, capacity=KW["capacity"])
    return cfg_t, want


def test_unet_quantized_pipeline_matches_jax(movie, quantized_runs):
    """``unet={"quantized": True}`` runs the int8 forward (the plain
    ``conv3x3_s8`` on the CPU) under this file's criteria against the JAX
    package's quantized pipeline on the same int8 parameters."""
    cfg_t, want = quantized_runs
    got = t_pipe(movie, unet=cfg_t, device="cpu", **KW)
    _assert_matches_jax(got, want)
    assert min(int(l.max()) for l in got["labels"]) >= 8


@pytest.mark.parametrize("chunk", [3, 4])
def test_unet_quantized_chunked_matches_jax(movie, quantized_runs, chunk):
    cfg_t, want = quantized_runs
    got = t_pipe_chunked(movie, chunk_frames=chunk, unet=cfg_t, device="cpu",
                         **KW)
    got["labels"] = torch.from_numpy(got["labels"])
    _assert_matches_jax(got, want)


@pytest.mark.cuda
def test_unet_pipeline_on_card_matches_cpu(movie, unet_whole):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, cfg_t, whole = unet_whole
    got = t_pipe(movie, unet=cfg_t, device="cuda", **KW)
    np.testing.assert_array_equal(got["labels"].cpu().numpy(),
                                  whole["labels"].numpy())
    np.testing.assert_array_equal(got["ids"], whole["ids"])
