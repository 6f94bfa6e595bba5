"""PyTorch port vs the JAX package: percentiles, the fast blur routes, block
reduction, resizing and the surface projection (fused and unfused).

Inputs come from a numpy seed and go through both packages. The JAX fused
kernels run in Pallas interpret mode on the CPU. Tolerances:

- percentiles: exact (both sides return the exact order statistic);
- box-cascade blur rtol 1e-5 with atol 1e-5 of the data range (the
  cumulative sums run in another order, their rounding grows with the
  running sum, and the ``hi - lo`` cancellation carries it into every
  output); band-matrix blur rtol 1e-5 /
  atol 1e-3 (another summation order of the product); ``block_reduce`` exact
  for max, rtol 1e-6 for mean and var; ``resize_bilinear`` atol 1e-5;
- score and project passes: the plain versions against the Pallas kernels to
  rtol 1e-5 (the Pallas kernels fold the y/x taps into matrix products);
- whole projections: z-maps equal (the runs show exact equality; the stated
  class is >= 99.9% equal with |dz| <= 1 everywhere), projections rtol 1e-4
  where the z-maps agree.

The CUDA kernels are checked against their plain versions on the card
(``cuda`` marker) and by ``chip_smoke.py``.
"""

import importlib

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tissue_image_processing_tpu.projection import fused as j_fused
from tissue_image_processing_tpu.projection import surface as j_surface
from tissue_image_processing_tpu_torch.ops import filters as t_filters
from tissue_image_processing_tpu_torch.projection import fused as t_fused
from tissue_image_processing_tpu_torch.projection import surface as t_surface

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

# ``tissue_image_processing_tpu.ops`` re-exports functions under these
# modules' names, so the modules themselves come through importlib
j_filters = importlib.import_module("tissue_image_processing_tpu.ops.filters")
j_pct = importlib.import_module("tissue_image_processing_tpu.ops.percentile")
t_pct = importlib.import_module(
    "tissue_image_processing_tpu_torch.ops.percentile")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_jax_programs():
    """Leave the worker without the JAX programs this file compiled. With
    them, ``tests/test_projection_fused.py`` on the same worker makes a
    cached fused-projection call right behind an uncached one, and Mosaic
    interpret mode under the CPU's async dispatch can deadlock there
    (ROADMAP section 1, fault 11)."""
    yield
    jax.clear_caches()


def make_stack(C=2, Z=8, Y=128, X=128, seed=0, offset=0.0):
    """Membrane sheet lit at a smooth depth (the recipe of
    tests/test_projection_fused.py), uint16."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:Y, 0:X].astype(np.float32)
    depth = Z / 2 + (Z / 4) * np.sin(yy / 37.0) * np.cos(xx / 53.0)
    zz = np.arange(Z, dtype=np.float32).reshape(Z, 1, 1)
    zprof = np.exp(-((zz - depth) ** 2) / 2.0)
    img = np.empty((C, Z, Y, X), np.float32)
    for c in range(C):
        tex = rng.random((Y, X)).astype(np.float32) * 0.5 + 0.5
        img[c] = zprof * tex[None] * 40000 + rng.normal(0, 150, (Z, Y, X)) + offset
    return np.clip(img, 0, 65535).astype(np.uint16)


def _u16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_zmaps_and_projections(got, want):
    (gp, gz), (wp, wz) = got, want
    gp, gz = gp.numpy(), gz.numpy()
    wp, wz = np.asarray(wp), np.asarray(wz)
    assert gz.dtype == np.int32 and gz.shape == wz.shape
    np.testing.assert_array_equal(gz, wz)
    np.testing.assert_allclose(gp, wp, rtol=1e-4, atol=1e-3)


# --------------------------------------------------------------- percentiles

@pytest.mark.parametrize("shape", [(40, 250), (3, 100, 1000), (20, 250, 1000),
                                   (4200001,)],
                             ids=["sort", "bisect", "row-subsample",
                                  "element-subsample"])
def test_percentiles_match_jax(shape):
    x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
    m = x > -0.3
    for q in (95.0, 37.5):
        want = float(j_pct.masked_percentile(jnp.asarray(x), jnp.asarray(m), q))
        got = t_pct.masked_percentile(torch.from_numpy(x), torch.from_numpy(m), q)
        assert got.dim() == 0 and got.dtype == torch.float32
        assert float(got) == want
        assert float(t_pct.percentile(torch.from_numpy(x), q)) == float(
            j_pct.percentile(jnp.asarray(x), q))


@pytest.mark.parametrize("q", [0.0, 33.3, 50.0, 95.0, 100.0])
def test_segment_percentile_matches_jax(q):
    """Per-segment percentiles, exactly: ids outside [0, 50) are ignored
    and segments 45-49 have no members (0)."""
    rng = np.random.default_rng(7)
    v = (rng.random(5000) * 100).astype(np.float32)
    seg = rng.integers(-3, 60, 5000).astype(np.int32)
    seg[(seg >= 45) & (seg < 50)] = 70
    want = np.asarray(j_pct.segment_percentile(jnp.asarray(v), jnp.asarray(seg),
                                               50, q))
    got = t_pct.segment_percentile(torch.from_numpy(v), torch.from_numpy(seg),
                                   50, q)
    assert got.dtype == torch.float32 and got.shape == (50,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[45:].any()


def test_masked_percentile_empty_mask_is_zero():
    x = torch.ones(300, 1000)
    assert float(t_pct.masked_percentile(x, x < 0, 95.0)) == 0.0


# ----------------------------------------------------- blur routes, reductions

@pytest.mark.parametrize("shape,std,rtol,atol", [
    ((3, 40, 600), (0.5, 0.0, 8.0), 1e-5, 0.6),      # box cascade along x
    ((2, 520, 48), (0.0, 30.0, 1.0), 1e-5, 0.6),     # box cascade along y
    ((4, 64, 96), (0.5, 7.5, 7.5), 1e-5, 1e-3),      # band matrix, 61 taps
    ((2, 300, 40), (0.0, 30.0, 0.0), 1e-5, 1e-3),    # band matrix, 241 taps
    ((96, 80), (3.9, 2.0), 1e-5, 1e-3),              # 33 taps: band matrix
], ids=["box-x", "box-y", "band-61", "band-241", "band-33"])
def test_gaussian_blur_fast_routes_match_jax(shape, std, rtol, atol):
    x = (np.random.default_rng(1).random(shape) * 60000).astype(np.float32)
    want = np.asarray(j_filters.gaussian_blur(jnp.asarray(x), std, fast=True))
    got = t_filters.gaussian_blur(torch.from_numpy(x), std, fast=True).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("func", ["mean", "var", "max"])
@pytest.mark.parametrize("shape,block", [((6, 64, 64), (1, 4, 4)),
                                         ((5, 30, 27), (1, 4, 2)),
                                         ((31, 17), (3, 5))])
def test_block_reduce_matches_jax(func, shape, block):
    x = (np.random.default_rng(2).random(shape) * 1000).astype(np.float32)
    want = np.asarray(j_filters.block_reduce(jnp.asarray(x), block, func))
    got = t_filters.block_reduce(torch.from_numpy(x), block, func).numpy()
    if func == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("src,dst", [((32, 32), (128, 128)),
                                     ((6, 10, 10), (6, 40, 40)),
                                     ((64, 48), (20, 30)),
                                     ((17, 23), (50, 9))],
                         ids=["up-2d", "up-3d", "down", "mixed"])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(3).random(src).astype(np.float32)
    want = np.asarray(j_filters.resize_bilinear(jnp.asarray(x), dst))
    got = t_filters.resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert got.shape == tuple(dst)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_taps_match_jax():
    for sigma in (0.5, 1.0, 2.0):
        assert t_fused._taps(sigma) == j_fused._taps(sigma)


# ------------------------------------------------------------ the two passes

@pytest.mark.parametrize("off", [0.0, 10000.0])
def test_score_pass_plain_matches_pallas(off):
    vol = make_stack(C=1, seed=4, offset=off)[0]
    p95 = np.float32(30000.0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_fused._score_pass(jnp.asarray(vol), jnp.asarray(p95),
                                              airyscan_offset=off))
    got = t_fused.score_pass(_u16(vol), torch.tensor(p95), off)
    assert tuple(got.shape) == (8, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("Z", [1, 2, 3])
def test_score_pass_plain_matches_pallas_on_thin_stacks(Z):
    """Stacks thinner than the five z taps: every output plane reads the
    edge planes more than once."""
    vol = make_stack(C=1, Z=Z, seed=6)[0]
    p95 = np.float32(25000.0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_fused._score_pass(jnp.asarray(vol), jnp.asarray(p95)))
    got = t_fused.score_pass(_u16(vol), torch.tensor(p95))
    assert tuple(got.shape) == (Z, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("shift,off", [(0, 0.0), (1, 0.0), (-2, 10000.0),
                                       (0, 10000.0), (3, 10000.0), (-1, 0.0)])
def test_project_pass_plain_matches_pallas(shift, off):
    img = make_stack(seed=5, offset=off)
    yy, xx = np.mgrid[0:128, 0:128]
    rel_z = np.clip(np.round(4 + 3 * np.sin(yy / 19.0) * np.cos(xx / 29.0)),
                    0, 7).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_fused._project_pass(
            jnp.asarray(img), jnp.asarray(rel_z), airyscan_offset=off,
            ref_channel=0, atoh_shift=shift))
    got = t_fused.project_pass(_u16(img), torch.from_numpy(rel_z), off, 0, shift)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def _step_zmap(Y, X, Z):
    """0 on the left, Z - 1 on the right: the tiles on the step admit every
    plane."""
    return np.where(np.arange(X)[None, :] < X // 2 + 3, 0, Z - 1
                    ).astype(np.int32).repeat(Y, axis=0)


PROJECT_CASES = {
    "step": dict(zmap="step"),
    "step_shift_offset": dict(zmap="step", shift=-2, off=10000.0),
    "ref_channel_1": dict(shift=2, ref=1),
    "ragged": dict(shape=(7, 97, 100)),
    "ragged_shift_offset": dict(shape=(7, 97, 100), shift=1, off=10000.0),
    "ragged_step": dict(shape=(5, 70, 90), zmap="step", shift=-1),
}


def _project_case(name, seed=5):
    """(img (2, Z, Y, X) float32, z-map int32, offset, ref_channel, shift)."""
    c = PROJECT_CASES[name]
    Z, Y, X = c.get("shape", (8, 128, 128))
    off = c.get("off", 0.0)
    img = make_stack(Z=Z, Y=Y, X=X, seed=seed, offset=off)
    if c.get("zmap") == "step":
        rel_z = _step_zmap(Y, X, Z)
    else:
        rel_z = np.random.default_rng(seed).integers(0, Z, (Y, X)).astype(np.int32)
    return img, rel_z, off, c.get("ref", 0), c.get("shift", 0)


@pytest.mark.parametrize("name", sorted(PROJECT_CASES))
def test_project_pass_plain_matches_pallas_on_hard_inputs(name):
    """The shifted mask with either reference channel, the airyscan offset,
    a full-range step in the z-map, and ragged stacks. The Pallas kernel
    takes whole 64 x 128 blocks only, so a ragged stack goes to it padded to
    (128, 128): the z-map by edge replication (>= 8 pixels, the blur's
    radius: the mask of a replicated z-map is the replicated mask) and the
    channels by zeros; the crop is the ragged result."""
    img, rel_z, off, ref, shift = _project_case(name)
    Y, X = rel_z.shape
    pad = ((0, 128 - Y), (0, 128 - X))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_fused._project_pass(
            jnp.asarray(np.pad(img, ((0, 0), (0, 0)) + pad)),
            jnp.asarray(np.pad(rel_z, pad, mode="edge")), airyscan_offset=off,
            ref_channel=ref, atoh_shift=shift))[:, :Y, :X]
    got = t_fused.project_pass(_u16(img), torch.from_numpy(rel_z), off, ref, shift)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert got.numpy().max() > 0


def test_passes_reject_bad_input():
    with pytest.raises(ValueError):
        t_fused.score_pass(torch.zeros(2, 10, 8, dtype=torch.uint16),
                           torch.tensor(1.0))
    with pytest.raises(ValueError):
        t_fused.project_pass(torch.zeros(2, 3, 8, 8, dtype=torch.uint16),
                             torch.zeros(8, 9, dtype=torch.int32))
    with pytest.raises(ValueError):
        t_fused.project_pass(torch.zeros(2, 3, 8, 8, dtype=torch.uint16),
                             torch.zeros(8, 8, dtype=torch.int32), ref_channel=2)


# ------------------------------------------------------- whole projections

@pytest.mark.parametrize("airyscan,shift", [(False, 0), (True, 1)])
def test_fused_projection_matches_jax(airyscan, shift):
    stack = make_stack(seed=6, offset=10000.0 if airyscan else 0.0)
    with pltpu.force_tpu_interpret_mode():
        want = j_fused.fused_projection(jnp.asarray(stack), airyscan=airyscan,
                                        atoh_shift=shift)
    got = t_fused.fused_projection(_u16(stack), airyscan=airyscan,
                                   atoh_shift=shift)
    _assert_zmaps_and_projections(got, want)


def test_fused_projection_supported_gate():
    for shape, ok in [((2, 8, 128, 128), True), ((2, 8, 100, 128), False),
                      ((2, 8, 128, 96), False), ((2, 8, 64, 128), False),
                      ((2, 65, 128, 128), False), ((8, 128, 128), False)]:
        assert t_fused.fused_projection_supported(shape) is ok
        assert j_fused.fused_projection_supported(shape) is ok


_CONFIGS = {
    "default": dict(),
    "no-airyscan": dict(airyscan=False),
    "bin2": dict(airyscan=False, bin_size=2),
    "max_std": dict(airyscan=False, method="max_std", bin_size=2),
    "multi_channel": dict(airyscan=False, method="multi_channel", bin_size=2,
                          atoh_shift=1),
    "z-window": dict(airyscan=False, min_z=2, max_z=10),
    "precise": dict(airyscan=False, precise=True),
    "manifold": dict(airyscan=False, build_manifold=True),
    "manifold-bin2": dict(airyscan=False, build_manifold=True, bin_size=2),
}


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_time_point_surface_projection_matches_jax(name):
    kw = _CONFIGS[name]
    stack = make_stack(Z=12, Y=48, X=56, seed=7, offset=10000.0)
    want = j_surface.time_point_surface_projection(
        jnp.asarray(stack.astype(np.float32)), **kw)
    got = t_surface.time_point_surface_projection(_u16(stack), **kw)
    _assert_zmaps_and_projections(got, want)


def test_time_point_surface_projection_decimated_score_matches_jax():
    # at >= 512^2 the fast score blur decimates 4x and the small score is
    # resized back: block_reduce, the 61-tap band blur and resize_bilinear
    stack = make_stack(C=1, Z=5, Y=512, X=512, seed=8)
    want = j_surface.time_point_surface_projection(jnp.asarray(stack),
                                                   airyscan=False)
    got = t_surface.time_point_surface_projection(_u16(stack), airyscan=False)
    _assert_zmaps_and_projections(got, want)


def test_build_continuous_manifold_matches_jax():
    rng = np.random.default_rng(9)
    score = rng.random((7, 30, 26)).astype(np.float32)
    score[5, 3:9, 4:8] += 3.0  # an outlier the front has to route around
    want = np.asarray(j_surface.build_continuous_manifold(jnp.asarray(score)))
    got = t_surface.build_continuous_manifold(torch.from_numpy(score)).numpy()
    np.testing.assert_array_equal(got, want)


def test_project_timepoint_auto_on_cpu_takes_unfused_route(monkeypatch):
    def no_fused(*args, **kwargs):
        raise AssertionError("the fused route ran for a CPU stack")

    monkeypatch.setattr(t_surface, "fused_projection", no_fused)
    stack = _u16(make_stack(seed=10, offset=10000.0))
    got = t_surface.project_timepoint_auto(stack, airyscan=True)
    want = t_surface.time_point_surface_projection(stack, airyscan=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_movie_projection_batch_is_per_frame():
    stacks = np.stack([make_stack(Z=6, Y=32, X=32, seed=s) for s in (11, 12)])
    proj, zmap = t_surface.movie_projection_batch(_u16(stacks), airyscan=False)
    assert tuple(proj.shape) == (2, 2, 32, 32) and tuple(zmap.shape) == (2, 32, 32)
    one, z1 = t_surface.time_point_surface_projection(_u16(stacks[1]),
                                                      airyscan=False)
    torch.testing.assert_close(proj[1], one, rtol=0, atol=0)
    torch.testing.assert_close(zmap[1], z1, rtol=0, atol=0)


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("off", [0.0, 10000.0])
def test_score_kernel_matches_plain(cuda_device, off):
    vol = _u16(make_stack(C=1, Z=30, Y=256, X=256, seed=13, offset=off)[0]
               ).to(cuda_device)
    p95 = torch.tensor(30000.0, device=cuda_device)
    got = t_fused.score_pass(vol, p95, off)
    want = t_fused.score_pass_plain(vol, p95, off)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _score_case(Z, X, off, clip, seed=17):
    """(Z, 128, X) uint16 over the whole range and a p95 below every
    converted value (everything clipped) or above every one (nothing)."""
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, 65536, (Z, 128, X)).astype(np.uint16)
    v = np.maximum(vol.astype(np.float32) - off, 0.0)
    p95 = v.min() - 0.5 if clip == "below" else v.max() + 0.5
    return vol, np.float32(p95)


@pytest.mark.cuda
@pytest.mark.parametrize("clip", ["below", "above"])
@pytest.mark.parametrize("off", [0.0, 10000.0])
@pytest.mark.parametrize("X", [128, 1024])
@pytest.mark.parametrize("Z", [1, 2, 3, 30, 64])
def test_score_kernel_matches_plain_on_hard_inputs(cuda_device, Z, X, off, clip):
    vol, p95 = _score_case(Z, X, off, clip)
    vol = _u16(vol).to(cuda_device)
    p95 = torch.tensor(p95, device=cuda_device)
    got = t_fused.score_pass(vol, p95, off)
    want = t_fused.score_pass_plain(vol, p95, off)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(t_fused.score_pass(vol, p95, off), got), "two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, -3])
def test_project_kernel_matches_plain(cuda_device, shift):
    img = _u16(make_stack(Z=30, Y=256, X=192, seed=14)).to(cuda_device)
    yy, xx = np.mgrid[0:256, 0:192]
    rel_z = torch.from_numpy(np.clip(np.round(15 + 8 * np.sin(yy / 23.0)
                                              * np.cos(xx / 31.0)), 0, 29
                                     ).astype(np.int32)).to(cuda_device)
    got = t_fused.project_pass(img, rel_z, 0.0, 0, shift)
    want = t_fused.project_pass_plain(img, rel_z, 0.0, 0, shift)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(PROJECT_CASES))
def test_project_kernel_matches_plain_on_hard_inputs(cuda_device, name, channels):
    img, rel_z, off, ref, shift = _project_case(name, seed=16)
    img = np.concatenate([img, img[:1] // 2])[:channels]
    img = _u16(img).to(cuda_device)
    rel_z = torch.from_numpy(rel_z).to(cuda_device)
    ref = min(ref, channels - 1)
    got = t_fused.project_pass(img, rel_z, off, ref, shift)
    want = t_fused.project_pass_plain(img, rel_z, off, ref, shift)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_fused_projection_on_card_matches_cpu(cuda_device):
    stack = _u16(make_stack(seed=15))
    gp, gz = t_fused.fused_projection(stack.to(cuda_device))
    wp, wz = t_fused.fused_projection(stack)
    torch.testing.assert_close(gz.cpu(), wz, rtol=0, atol=0)
    torch.testing.assert_close(gp.cpu(), wp, rtol=2e-6, atol=1e-4)
