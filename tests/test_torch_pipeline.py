"""PyTorch port vs the JAX package: the whole watershed movie pipeline.

A pre-projected (Z == 1) drifting membrane movie goes through both
``movie_pipeline``s. The blur is not bit-exact across frameworks (XLA fuses
its multiply-adds) and round-off can flip plateau ties, so labels must agree
on >= 99.5% of pixels with per-cell Dice >= 0.99, and track ids are compared
through the label matching. The port's chunked run must equal its unchunked
run exactly. A raw z-stack movie (Z > 1, uint16, with and without the
airyscan offset) goes through both packages too: each projects every frame
(on the CPU both take the unfused route), and there the runs agree exactly.
Also: the package imports no JAX, and asking for the card without one
raises.
"""

import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tissue_image_processing_tpu.core.pipeline import movie_pipeline as j_pipe
from tissue_image_processing_tpu_torch.core.pipeline import (
    movie_pipeline as t_pipe, movie_pipeline_chunked as t_pipe_chunked)
from tissue_image_processing_tpu_torch import resolve_device

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


def test_pipeline_matches_jax(movie, port_whole):
    want = j_pipe(jnp.asarray(movie), **KW)
    got = port_whole
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


@pytest.mark.parametrize("chunk", [3, 7])
def test_chunked_equals_unchunked(movie, port_whole, chunk):
    got = t_pipe_chunked(movie, chunk_frames=chunk, device="cpu", **KW)
    np.testing.assert_array_equal(got["ids"], port_whole["ids"])
    np.testing.assert_array_equal(got["labels"], port_whole["labels"].numpy())
    np.testing.assert_array_equal(got["tables"].area.numpy(),
                                  port_whole["tables"].area.numpy())
    np.testing.assert_array_equal(got["drifts"], port_whole["drifts"])


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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('tissue_image_processing_tpu.')\n"
        "       or m == 'tissue_image_processing_tpu']\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_cuda_without_card_raises(movie, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        t_pipe(movie[:2], **KW)


def test_projection_and_unet_branches_not_ported_yet(movie):
    # the projection branch is ported (the Z > 1 tests below); U-Net is not
    with pytest.raises(NotImplementedError):
        t_pipe(movie[:2], unet={"params": None}, device="cpu", **KW)


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
