"""PyTorch port vs the JAX package: TV-L1 optical flow
(``ops/optical_flow.py``) and the flow branch of the nearest-pixel tracker.

The port runs on the CPU (``device="cpu"``), JAX on its CPU backend (its
TV-L1 is plain ``jax.numpy``, no Pallas). Tolerances:

- ``warp_bilinear``: <= 1e-6 (the runs read exact); ``_grad`` and ``_div``
  exact (differences of the same float32 values);
- ``_tvl1_level`` (one level, a few warps): <= 1e-5 px;
- ``optical_flow_tvl1`` on the textures of ``tests/test_optical_flow.py``
  (192^2 and 96 x 160): max |dflow| <= 5e-3 px (the runs read <= 8e-4 px:
  XLA fuses and reorders the ~50 float32 passes of a level, the port runs
  them as written, and its resize contracts a weight matrix in another
  order). On larger frames a few values land on the other side of the
  solver's pointwise threshold and move by up to ~1 px (512^2: 233 of
  524,288 values beyond 5e-3 px, the largest 0.89 px), so the class for a
  whole frame is: |dflow| <= 5e-3 px on >= 99.9% of the values and mean
  |dflow| <= 1e-3 px. The 512^2 frame of ``utils/synthetic.make_movie``
  is held to it, and so is the card against the CPU in ``chip_smoke.py``;
- the three cases of ``tests/test_optical_flow.py`` on the port (integer
  shift warp, uniform translation, the non-uniform tracker) with their own
  bars, and the flow tracker's ids equal to the JAX tracker's exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_optical_flow import _texture, _voronoi_movie
from tissue_image_processing_tpu.core import tracking as jtr
from tissue_image_processing_tpu.ops import optical_flow as jof
from tissue_image_processing_tpu_torch.core import tracking as ttr
from tissue_image_processing_tpu_torch.ops import optical_flow as tof

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)


def fields(h, w, seed):
    rng = np.random.default_rng(seed)
    img = _texture(h, w, seed)
    # displacements that reach past every edge, so the clamps are exercised
    u = rng.normal(0.0, 4.0, (h, w)).astype(np.float32)
    v = rng.normal(0.0, 4.0, (h, w)).astype(np.float32)
    return img, u, v


@pytest.mark.parametrize("shape", [(32, 32), (17, 40)])
def test_warp_bilinear_matches_jax(shape):
    img, u, v = fields(*shape, seed=1)
    want = np.asarray(jof.warp_bilinear(jnp.asarray(img), jnp.asarray(u),
                                        jnp.asarray(v)))
    got = tof.warp_bilinear(torch.from_numpy(img), torch.from_numpy(u),
                            torch.from_numpy(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(32, 32), (17, 40)])
def test_grad_and_div_match_jax(shape):
    img, u, _ = fields(*shape, seed=2)
    for g, w in zip(tof._grad(torch.from_numpy(img)),
                    jof._grad(jnp.asarray(img))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tof._div(torch.from_numpy(img), torch.from_numpy(u)).numpy(),
        np.asarray(jof._div(jnp.asarray(img), jnp.asarray(u))))


def test_tvl1_level_matches_jax():
    I0 = _texture(32, 48, seed=3)
    I1 = np.roll(I0, (1, -2), axis=(0, 1))
    z = np.zeros_like(I0)
    want = jof._tvl1_level(jnp.asarray(I0), jnp.asarray(I1), jnp.asarray(z),
                           jnp.asarray(z), 15.0, 0.3, 2, 3)
    got = tof._tvl1_level(torch.from_numpy(I0), torch.from_numpy(I1),
                          torch.from_numpy(z), torch.from_numpy(z), 15.0, 0.3,
                          2, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_warp_bilinear_integer_shift():
    """``tests/test_optical_flow.py``'s case on the port."""
    img = _texture(32, 32)
    got = tof.warp_bilinear(torch.from_numpy(img), torch.full((32, 32), 3.0),
                            torch.full((32, 32), -2.0)).numpy()
    np.testing.assert_allclose(got[2:-4, 3:-1], img[5:-1, 1:-3], atol=1e-6)


@pytest.mark.parametrize("shape,shift", [((192, 192), (4, -3)),
                                         ((96, 160), (-2, 5))])
def test_tvl1_matches_jax_and_recovers_translation(shape, shift):
    """The uniform-translation case of ``tests/test_optical_flow.py`` (192^2,
    shift (4, -3)) and a non-square one: the port's flow within 5e-3 px of
    JAX's and its interior median within 0.5 px of the shift."""
    img = _texture(*shape, seed=1)
    mov = np.roll(img, shift, axis=(0, 1))
    want = np.asarray(jof.optical_flow_tvl1(jnp.asarray(img), jnp.asarray(mov)))
    got = tof.optical_flow_tvl1(img, mov, device="cpu")
    assert got.shape == (2,) + shape and got.dtype == torch.float32
    got = got.numpy()
    assert np.abs(got - want).max() <= 5e-3
    m = 16
    for axis in (0, 1):
        assert abs(np.median(got[axis, m:-m, m:-m]) - shift[axis]) < 0.5


def assert_flow_class(got, want):
    """The whole-frame class: |dflow| <= 5e-3 px on >= 99.9% of the values,
    mean |dflow| <= 1e-3 px."""
    d = np.abs(got - want)
    assert (d <= 5e-3).mean() >= 0.999, (d > 5e-3).sum()
    assert d.mean() <= 1e-3, d.mean()


def test_tvl1_matches_jax_on_a_movie_frame():
    from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

    ref, mov = make_movie(T=2, Z=1, H=512, W=512, seed=0)[:, 0, 0].astype(
        np.float32)
    want = np.asarray(jof.optical_flow_tvl1(jnp.asarray(ref), jnp.asarray(mov)))
    got = tof.optical_flow_tvl1(ref, mov, device="cpu").numpy()
    assert_flow_class(got, want)
    assert np.abs(want).max() > 1.0   # the frames do move


def test_flow_tracker_matches_jax_on_nonuniform_drift():
    """The non-uniform case of ``tests/test_optical_flow.py``: the port's
    flow tracker gives the JAX tracker's ids exactly and recovers >= 95% of
    the links, where the global-drift tracker recovers < 80%."""
    labels, images, cy, cx, mask = _voronoi_movie()
    valid = ~np.isnan(cy).any(0)
    mask = mask & ~np.isnan(cy)
    cy = np.nan_to_num(cy)
    cx = np.nan_to_num(cx)
    want = jtr.track_movie_nearest_pixel(labels, cy, cx, mask, images=images,
                                         use_flow=True)
    got = ttr.track_movie_nearest_pixel(labels, cy, cx, mask, images=images,
                                        use_flow=True, device="cpu")
    np.testing.assert_array_equal(got, want)
    plain = ttr.track_movie_nearest_pixel(labels, cy, cx, mask)
    rec_flow = (got[1][valid] == got[0][valid]).mean()
    rec_plain = (plain[1][valid] == plain[0][valid]).mean()
    assert rec_flow >= 0.95 and rec_plain < 0.80


def test_flow_entry_points_need_the_card_or_images(monkeypatch):
    img = _texture(32, 32)
    with pytest.raises(ValueError, match="requires images"):
        ttr.track_movie_nearest_pixel(np.zeros((2, 32, 32), int),
                                      np.zeros((2, 4)), np.zeros((2, 4)),
                                      np.ones((2, 4), bool), use_flow=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tof.optical_flow_tvl1(img, img)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.track_movie_nearest_pixel(np.zeros((2, 32, 32), int),
                                      np.zeros((2, 4)), np.zeros((2, 4)),
                                      np.ones((2, 4), bool),
                                      images=np.stack([img, img]),
                                      use_flow=True)


@pytest.mark.cuda
def test_tvl1_card_matches_cpu():
    """On the card: the flow of a 256^2 pair in the whole-frame class of
    the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    img = _texture(256, 256, seed=4)
    mov = np.roll(img, (3, -5), axis=(0, 1))
    got = tof.optical_flow_tvl1(img, mov)
    assert got.device.type == "cuda"
    want = tof.optical_flow_tvl1(img, mov, device="cpu")
    assert_flow_class(got.cpu().numpy(), want.numpy())
