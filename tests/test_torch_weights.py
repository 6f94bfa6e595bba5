"""PyTorch port vs the JAX package: Keras weight files and the U-Net's
up-sampling and row-split knobs.

- ``load_keras_unet_weights`` on an h5 file in both layouts the JAX reader
  takes (``model_weights/<layer>/<layer>/<name>:0`` and Keras 3
  ``layers/<name>/vars/<i>``) equals the JAX loader followed by
  ``unet_state_from_flax``, tensor for tensor. The file is written with h5py
  from seeded random arrays in Keras' shapes (``utils/synthetic.py``; no
  checkpoint ships with the repo and ``tensorflow`` is not installed);
- ``up_kind="subpixel"``: ``variables_to_subpixel`` equals the JAX
  conversion exactly, and the subpixel forward equals Flax's and the
  transposed-conv forward within 1e-5 (float32);
- ``up_kind="resize_conv"``: one up step equals ``jax.image.resize``
  (nearest) + a Flax ``nn.Conv`` within 1e-5. The JAX ``UNet`` itself cannot
  be built with this knob (its auto-named ``Conv_0`` collides with the
  head's name), so there is no Flax forward of the whole net to compare;
- ``row_split``: the split conv equals the unsplit one exactly, fixed and
  automatic, and ``_auto_row_split`` equals JAX's on a grid of shapes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tissue_image_processing_tpu_torch.models import unet as tunet
from tissue_image_processing_tpu_torch.models.weights_io import (
    keras_layer_arrays, load_keras_unet_weights)
from tissue_image_processing_tpu_torch.utils.state import unet_state_from_flax
from tissue_image_processing_tpu_torch.utils.synthetic import (
    keras_unet_arrays, write_keras_h5)

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)


class _Lazy:
    """A JAX-package module imported at first use (the model modules need
    flax)."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


junet = _Lazy("tissue_image_processing_tpu.models.unet")
jwio = _Lazy("tissue_image_processing_tpu.models.weights_io")


@pytest.mark.parametrize("layout", ["keras2", "keras3"])
@pytest.mark.parametrize("depth", [2, 3])
def test_keras_weights_match_jax_loader(tmp_path, layout, depth):
    layers = keras_unet_arrays(depth, 4, seed=depth)
    path = str(tmp_path / f"w_{layout}.h5")
    write_keras_h5(path, layers, layout)
    read = keras_layer_arrays(path)
    assert sorted(read) == sorted(layers)
    _, variables = junet.build_unet((16, 16, 2), depth=depth, base_filters=4)
    want = unet_state_from_flax(jax.device_get(
        jwio.load_keras_unet_weights(jax.device_get(variables), path)))
    model = tunet.UNet(depth=depth, base_filters=4)
    got = load_keras_unet_weights(model, path)
    from_state = load_keras_unet_weights(tunet.UNet(depth=depth, base_filters=4)
                                         .state_dict(), path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(from_state[k], v), k
        assert torch.equal(model.state_dict()[k], v), k
    # the transposed conv is only transposed: Keras' (h, w, out, in) is
    # F.conv_transpose2d's convention
    kt = layers["conv2d_transpose"]["kernel"]
    np.testing.assert_array_equal(got["ups.0.weight"].numpy(),
                                  np.transpose(kt, (3, 2, 0, 1)))


def test_keras_weights_layer_count_mismatch(tmp_path):
    layers = keras_unet_arrays(2, 4)
    del layers["conv2d_3"]
    path = str(tmp_path / "short.h5")
    write_keras_h5(path, layers, "keras2")
    with pytest.raises(ValueError, match="layer count"):
        load_keras_unet_weights(tunet.UNet(depth=2, base_filters=4), path)
    with pytest.raises(ValueError, match="shape mismatch"):
        path2 = str(tmp_path / "wide.h5")
        write_keras_h5(path2, keras_unet_arrays(2, 8), "keras3")
        load_keras_unet_weights(tunet.UNet(depth=2, base_filters=4), path2)


def test_keras_forward_matches_flax(tmp_path):
    """The loaded weights give the Flax forward of the JAX-loaded ones
    (float32, BatchNorm in inference form)."""
    path = str(tmp_path / "w.h5")
    write_keras_h5(path, keras_unet_arrays(2, 4, seed=7), "keras3")
    model, variables = junet.build_unet((32, 32, 2), depth=2, base_filters=4)
    jvars = jwio.load_keras_unet_weights(jax.device_get(variables), path)
    x = np.random.default_rng(0).random((1, 32, 32, 2)).astype(np.float32)
    want = np.asarray(model.apply(jvars, jnp.asarray(x), train=False))
    tm = tunet.UNet(depth=2, base_filters=4)
    load_keras_unet_weights(tm, path)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fold_bn", [True, False], ids=["folded", "bn"])
def test_weights_path_predictor_matches_jax(tmp_path, fold_bn):
    """``SegmentationPredictor(model_weights_path=...)`` loads the file as the
    JAX predictor does: float32 probabilities to 1e-5 and, with no pixel
    that close to the 0.1 threshold, equal HC masks and labels."""
    jpred = importlib.import_module("tissue_image_processing_tpu.models.predictor")
    from tissue_image_processing_tpu_torch.models import predictor as tpred

    path = str(tmp_path / "w.h5")
    write_keras_h5(path, keras_unet_arrays(2, 4, seed=11), "keras2")
    imgs = (np.random.default_rng(12).random((2, 2, 60, 70)) * 50000).astype(
        np.float32)
    kw = dict(depth=2, base_filters=4, fold_bn=fold_bn)
    jp = jpred.SegmentationPredictor(path, imgs[0].shape, dtype=jnp.float32, **kw)
    tp = tpred.SegmentationPredictor(path, imgs[0].shape, dtype=torch.float32,
                                     device="cpu", **kw)
    assert tp.model.norm == ("shift" if fold_bn else "bn")
    pj = np.asarray(jp._forward(jp.prepare_image(imgs[0])[0]))
    pt = tp._forward(tp.prepare_image(imgs[0])[0]).numpy()
    err = np.abs(pt - pj).max()
    assert err <= 1e-5 and np.abs(pj[..., 0] - 0.1).min() > err
    want_l, want_hc = jp.predict_batch(imgs)
    got_l, got_hc = tp.predict_batch(imgs)
    np.testing.assert_array_equal(got_hc.numpy(), np.asarray(want_hc))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


# --- up-sampling knobs --------------------------------------------------------------

@pytest.fixture(scope="module")
def convt_variables():
    _, variables = junet.build_unet((32, 32, 2), depth=2, base_filters=8, seed=4)
    return jax.device_get(variables)


def test_fold_convtranspose_matches_jax(convt_variables):
    want = unet_state_from_flax(jax.device_get(
        junet.variables_to_subpixel(convt_variables)))
    got = tunet.variables_to_subpixel(unet_state_from_flax(convt_variables))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_subpixel_forward_matches_flax_and_convt(convt_variables):
    x = np.random.default_rng(1).random((2, 32, 32, 2)).astype(np.float32)
    sub_vars = jax.device_get(junet.variables_to_subpixel(convt_variables))
    want = np.asarray(junet.UNet(depth=2, base_filters=8, up_kind="subpixel")
                      .apply(sub_vars, jnp.asarray(x), train=False))
    model = tunet.UNet(depth=2, base_filters=8, up_kind="subpixel")
    model.load_state_dict(unet_state_from_flax(sub_vars))
    convt = tunet.UNet(depth=2, base_filters=8)
    convt.load_state_dict(unet_state_from_flax(convt_variables))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        ref = convt.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_subpixel_interleave_is_jax_channel_order():
    """Output (2i + di, 2j + dj) of channel c reads packed channel
    (di * 2 + dj) * f + c: an impulse per phase pins it."""
    f = 3
    up = tunet._SubpixelUp(1, f)
    with torch.no_grad():
        up.packed.weight.zero_()
        up.packed.bias.copy_(torch.arange(4 * f, dtype=torch.float32))
    y = up(torch.zeros(1, 1, 2, 2), torch.float32)
    assert tuple(y.shape) == (1, f, 4, 4)
    for di in (0, 1):
        for dj in (0, 1):
            for c in range(f):
                assert float(y[0, c, 2 + di, 2 + dj].detach()) == \
                    (di * 2 + dj) * f + c


def test_resize_conv_up_matches_flax():
    from flax import linen as nn

    rng = np.random.default_rng(2)
    x = rng.random((2, 8, 6, 16)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, 16, 8)).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    up = jax.image.resize(jnp.asarray(x), (2, 16, 12, 16), method="nearest")
    want = np.asarray(nn.Conv(8, (3, 3), padding="SAME", dtype=jnp.float32)
                      .apply({"params": {"kernel": kernel, "bias": bias}}, up))
    model = tunet.UNet(depth=2, base_filters=8, up_kind="resize_conv")
    layer = model.ups[1]    # 16 -> 8 channels
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1))))
        layer.bias.copy_(torch.from_numpy(bias))
        got = model._up(layer, torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=1e-5)
    with torch.no_grad():
        out = tunet.build_unet((32, 32, 2), depth=2, base_filters=8,
                               up_kind="resize_conv",
                               generator=torch.Generator().manual_seed(0)
                               ).eval()(torch.rand(1, 32, 32, 2))
    assert tuple(out.shape) == (1, 32, 32, 2)
    torch.testing.assert_close(out.sum(-1), torch.ones(1, 32, 32))


def test_unknown_up_kind_raises():
    with pytest.raises(ValueError):
        tunet.UNet(up_kind="deconv")


# --- row split ------------------------------------------------------------------------

@pytest.mark.parametrize("shape,row_split", [((1, 256, 64, 2), 8),
                                             ((1, 256, 64, 2), -1),
                                             ((2, 512, 32, 2), -1),
                                             ((2, 96, 40, 5), 3)])
def test_row_split_conv_exact(shape, row_split):
    x = torch.from_numpy(np.random.default_rng(3).random(shape)
                         .astype(np.float32)).permute(0, 3, 1, 2)
    gen = torch.Generator().manual_seed(1)
    ref = tunet.DoubleConv(shape[-1], 8, norm="none")
    for conv in (ref.conv0, ref.conv1):
        tunet._variance_scaling_(conv.weight, 2.0, conv.in_channels * 9, gen)
    split = tunet.DoubleConv(shape[-1], 8, norm="none", row_split=row_split)
    split.load_state_dict(ref.state_dict())
    with torch.no_grad():
        want, got = ref.eval()(x), split.eval()(x)
    assert torch.equal(got, want)


def test_auto_row_split_matches_jax():
    for B in (1, 2, 3, 5, 8, 16):
        for H in (64, 128, 384, 512, 768, 1024, 2048):
            assert tunet._auto_row_split(B, H) == junet._auto_row_split(B, H), (B, H)
    assert tunet._auto_row_split(1, 1024) == 8
    assert tunet._auto_row_split(3, 1024) == 4
    assert tunet._auto_row_split(8, 1024) == 1
    assert tunet._auto_row_split(1, 384) == 1
