"""PyTorch port vs the JAX package: the U-Net segmentation branch, module by
module.

The same numpy-seeded inputs and the same weights (Flax variables carried
across by ``unet_state_from_flax``) go through the JAX function and its
counterpart in the port:

- binary and grey morphology, exact, borders included;
- ``normalize_channel`` and the brightness functions (rtol 1e-6: XLA may fuse
  the interpolation and the division differently, one float32 ulp);
- the ``UNet`` forward against Flax for ``norm="bn"`` and the folded
  ``norm="shift"``: float32 to 1e-5 on probabilities (summation order only);
  bfloat16 (on one 32 x 64 frame) to 3e-2, because a float32 sum that
  differs in its last bit can round to the other bfloat16 neighbour at the
  next conv's input (0.4% relative) and a few such flips reach the output
  (measured <= 9e-3 at these sizes);
- the transposed conv against the Flax module on an impulse;
- ``fold_batchnorm`` against JAX's, and its refusal of a scale <= 0;
- ``unet_postprocess`` / ``unet_postprocess_batch`` exact on given
  predictions, and the predictor end to end in float32.
"""

import copy
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tissue_image_processing_tpu_torch.models import predictor as tpred
from tissue_image_processing_tpu_torch.models.unet import (
    UNet, build_unet, fold_batchnorm)
from tissue_image_processing_tpu_torch.ops import brightness as tbr
from tissue_image_processing_tpu_torch.ops import morphology as tmo
from tissue_image_processing_tpu_torch.utils.state import unet_state_from_flax

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)



class _Lazy:
    """A JAX-package module imported at first use: the model modules need
    flax, which a machine that only runs the card-marked tests may lack."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


junet = _Lazy("tissue_image_processing_tpu.models.unet")
jpred = _Lazy("tissue_image_processing_tpu.models.predictor")
jbr = _Lazy("tissue_image_processing_tpu.ops.brightness")
jmo = _Lazy("tissue_image_processing_tpu.ops.morphology")

# (JAX dtype, port dtype, tolerance, input shape): the bfloat16 forward runs
# on one 32 x 64 frame, since XLA's bfloat16 convolutions on the CPU are slow
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, (2, 64, 64, 2)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2, (1, 32, 64, 2))}


def flax_variables(depth=2, base_filters=8, seed=1, shape=(64, 64, 2)):
    """Flax variables of the JAX U-Net as numpy arrays, with non-trivial
    BatchNorm scales, biases and running statistics (all scales > 0). Built
    once per argument set (the tests share them); each caller gets its own
    copy to change."""
    return copy.deepcopy(_flax_variables(depth, base_filters, seed, shape))


@functools.lru_cache(maxsize=None)
def _flax_variables(depth, base_filters, seed, shape):
    _, variables = junet.build_unet(shape, depth=depth,
                                    base_filters=base_filters, seed=seed)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x)
        if "kernel" in str(path):
            return x
        return (x + rng.uniform(0.01, 0.5, x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))


def torch_model(variables, depth, base_filters, dtype, norm):
    model = UNet(depth=depth, base_filters=base_filters, dtype=dtype, norm=norm)
    model.load_state_dict(unet_state_from_flax(variables))  # strict
    return model.eval()


# --- morphology -----------------------------------------------------------------

@pytest.mark.parametrize("size", [5, 7])
@pytest.mark.parametrize("op", ["binary_dilation", "binary_erosion",
                                "binary_closing"])
def test_binary_morphology_exact(op, size):
    rng = np.random.default_rng(size)
    x = rng.random((3, 61, 70)) < 0.35
    x[0, :3] = True       # structure on the frame edge: dilation pads with
    x[1, :, -2:] = True   # the minimum and erosion with the maximum, so an
    x[2, 20:45, 0:30] = True  # erosion does not eat into the border
    got = getattr(tmo, op)(torch.from_numpy(x), size).numpy()
    for b in range(3):
        want = np.asarray(getattr(jmo, op)(jnp.asarray(x[b]), size))
        np.testing.assert_array_equal(got[b], want)
    if op == "binary_erosion":
        assert got[2, 20 + size // 2:45 - size // 2, 0].all()


@pytest.mark.parametrize("op", ["grey_dilation", "grey_erosion"])
def test_grey_morphology_exact(op):
    x = np.random.default_rng(0).random((50, 37)).astype(np.float32)
    for size in (3, 4, 7):
        want = np.asarray(getattr(jmo, op)(jnp.asarray(x), size))
        got = getattr(tmo, op)(torch.from_numpy(x), size).numpy()
        np.testing.assert_array_equal(got, want)


# --- brightness -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(96, 120), (512, 512)],
                         ids=["sort", "bisection"])
def test_normalize_channel_matches_jax(shape):
    """96 x 120 sorts; 512 x 512 = 2^18 elements takes the bisection."""
    x = (np.random.default_rng(3).gamma(2.0, 4000.0, shape)).astype(np.float32)
    want = np.asarray(jbr.normalize_channel(jnp.asarray(x)))
    got = tbr.normalize_channel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got.min() == 0.0 and got.max() == 1.0


@pytest.mark.parametrize("n", [777, 11520, 16384, 131072])
def test_percentile_sort_route_exact(n):
    """Below 2^18 elements both packages sort; the port reproduces the
    arithmetic XLA gives ``jnp.percentile`` (position and interpolation), so
    the values are equal, not merely close."""
    jpc = importlib.import_module("tissue_image_processing_tpu.ops.percentile")
    tpc = importlib.import_module(
        "tissue_image_processing_tpu_torch.ops.percentile")
    x = np.random.default_rng(n).gamma(2.0, 4000.0, n).astype(np.float32)
    for q in (0.0, 1.0, 12.3, 50.0, 99.0, 99.9, 100.0):
        want = float(jpc.percentile(jnp.asarray(x), q))
        assert float(tpc.percentile(torch.from_numpy(x), q)) == want, q


def test_normalize_channel_constant_is_nan_like_jax():
    x = np.full((16, 16), 7.0, np.float32)
    assert np.isnan(np.asarray(jbr.normalize_channel(jnp.asarray(x)))).all()
    assert torch.isnan(tbr.normalize_channel(torch.from_numpy(x))).all()


@pytest.mark.parametrize("method", ["bestFit", "minMax", "none"])
def test_set_brightness_matches_jax(method):
    x = np.random.default_rng(4).integers(0, 60000, (2, 64, 48)).astype(np.uint16)
    want = np.asarray(jbr.set_brightness(jnp.asarray(x), 0, method, 1.0, 50.0))
    got = tbr.set_brightness(torch.from_numpy(x), 0, method, 1.0, 50.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    one = tbr.set_brightness(torch.from_numpy(x[0]), -1, method, 0.0).numpy()
    want1 = np.asarray(jbr.set_brightness(jnp.asarray(x[0]), -1, method, 0.0))
    np.testing.assert_allclose(one, want1, rtol=1e-6, atol=1e-7)


def test_binary_image_and_gamma_match_jax():
    x = np.random.default_rng(5).random((3, 20, 24)).astype(np.float32)
    x[1, 4, 4] = 0.5
    for thr, axis in (([0.3, 0.5, 0.7], 0), (0.5, 0), (0.5, -1)):
        want = np.asarray(jbr.binary_image(jnp.asarray(x), thr, axis))
        got = tbr.binary_image(torch.from_numpy(x), thr, axis).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        tbr.adjust_gamma(torch.from_numpy(x), 0.7, 2.0).numpy(),
        np.asarray(jbr.adjust_gamma(jnp.asarray(x), 0.7, 2.0)), rtol=1e-6)


# --- the network ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("norm", ["bn", "shift"])
def test_unet_forward_matches_flax(norm, dtype):
    jdt, tdt, tol, shape = DTYPES[dtype]
    variables = flax_variables()
    if norm == "shift":
        variables = jax.device_get(junet.fold_batchnorm(variables, depth=2))
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    want = np.asarray(junet.UNet(depth=2, base_filters=8, dtype=jdt, norm=norm)
                      .apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = torch_model(variables, 2, 8, tdt, norm)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def test_unet_forward_depth3_rectangular_matches_flax():
    variables = flax_variables(depth=3, base_filters=4, seed=5, shape=(32, 64, 2))
    x = np.random.default_rng(6).random((1, 32, 64, 2)).astype(np.float32)
    want = np.asarray(junet.UNet(depth=3, base_filters=4)
                      .apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = torch_model(variables, 3, 4, torch.float32, "bn")(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_unet_without_norm_matches_flax():
    variables = flax_variables()
    params = {k: ({kk: vv for kk, vv in v.items() if "BatchNorm" not in kk}
                  if k.startswith("DoubleConv") else v)
              for k, v in variables["params"].items()}
    x = np.random.default_rng(7).random((1, 32, 32, 2)).astype(np.float32)
    want = np.asarray(junet.UNet(depth=2, base_filters=8, norm="none")
                      .apply({"params": params}, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = torch_model({"params": params}, 2, 8, torch.float32, "none")(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_transposed_conv_impulse_matches_flax():
    """Tap k of the Flax kernel lands at output 2i + 2 - k; an impulse and a
    kernel of distinct values pin the flip and the crop in both axes."""
    from tissue_image_processing_tpu_torch.models.unet import _conv

    variables = flax_variables()      # depth 2: ConvTranspose_0 is 32 -> 16
    kernel = np.arange(1, 1 + 3 * 3 * 32 * 16, dtype=np.float32).reshape(
        3, 3, 32, 16)
    bias = np.linspace(-1.0, 2.0, 16).astype(np.float32)
    variables["params"]["ConvTranspose_0"] = {"kernel": kernel, "bias": bias}
    x = np.zeros((1, 4, 5, 32), np.float32)
    x[0, 1, 2, 0], x[0, 3, 4, 7], x[0, 0, 0, 31] = 1.0, 2.0, -1.0
    want = np.asarray(junet._FusedConvTranspose(16, dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
        jnp.asarray(x)))
    state = unet_state_from_flax(variables)
    got = _conv(torch.from_numpy(x).permute(0, 3, 1, 2), state["ups.0.weight"],
                state["ups.0.bias"], torch.float32, transpose=True)
    assert tuple(got.shape) == (1, 16, 8, 10)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # the impulse at (1, 2) puts tap (k, l) at (2 + 2 - k, 4 + 2 - l)
    assert want[0, 4, 6, 0] == kernel[0, 0, 0, 0] + bias[0]
    assert want[0, 2, 4, 0] == kernel[2, 2, 0, 0] + bias[0]


def test_fold_batchnorm_matches_jax():
    variables = flax_variables()
    want_vars = jax.device_get(junet.fold_batchnorm(variables, depth=2))
    want_state = unet_state_from_flax(want_vars)
    model = torch_model(variables, 2, 8, torch.float32, "bn")
    folded = fold_batchnorm(model)
    assert folded.norm == "shift" and not folded.training
    got_state = folded.state_dict()
    assert sorted(got_state) == sorted(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(got_state[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    x = torch.from_numpy(np.random.default_rng(8).random((1, 64, 64, 2))
                         .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(folded(x).numpy(), model(x).numpy(),
                                   rtol=0, atol=1e-5)


def test_fold_batchnorm_refuses_nonpositive_scale():
    variables = flax_variables()
    scale = variables["params"]["DoubleConv_0"]["BatchNorm_0"]["scale"]
    variables["params"]["DoubleConv_0"]["BatchNorm_0"]["scale"] = -scale
    assert junet.fold_batchnorm(variables, depth=2) is None
    assert fold_batchnorm(torch_model(variables, 2, 8, torch.float32, "bn")) is None
    shift_model = UNet(depth=2, base_filters=8, norm="shift")
    assert fold_batchnorm(shift_model) is None  # no BatchNorm to fold


def test_build_unet_draws_from_the_generator():
    a = build_unet((64, 64, 2), depth=2, base_filters=16,
                   generator=torch.Generator().manual_seed(3))
    b = build_unet((64, 64, 2), depth=2, base_filters=16,
                   generator=torch.Generator().manual_seed(3))
    c = build_unet((64, 64, 2), depth=2, base_filters=16,
                   generator=torch.Generator().manual_seed(4))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith("conv1.weight"):
            assert not torch.equal(va, vc), k
    w = a.blocks[2].conv1.weight  # he-normal: variance 2 / fan_in, cut at 2 sigma
    fan_in = w.shape[1] * 9
    assert abs(float(w.detach().std()) / (2.0 / fan_in) ** 0.5 - 1.0) < 0.05
    assert float(w.detach().abs().max()) <= 2.0 * (2.0 / fan_in) ** 0.5 / 0.8796 + 1e-6
    up = a.ups[0].weight.detach()  # lecun-normal
    assert abs(float(up.std()) / (1.0 / (up.shape[0] * 9)) ** 0.5 - 1.0) < 0.05
    assert all(float(p.detach().abs().max()) == 0.0 for n, p in a.named_parameters()
               if n.endswith("bias") and ".bn" not in n)


def test_unet_rejects_bad_shapes():
    model = UNet(depth=2, base_filters=4)
    with pytest.raises(ValueError):
        model(torch.zeros(1, 30, 32, 2))
    with pytest.raises(ValueError):
        model(torch.zeros(1, 32, 32, 3))
    with pytest.raises(ValueError):
        UNet(norm="layer")


# --- post-process and predictor ---------------------------------------------------

def _predictions(B=2, h=128, w=112, seed=3):
    rng = np.random.default_rng(seed)
    preds = np.zeros((B, h, w, 2), np.float32)
    for b in range(B):
        for _ in range(7):
            y, x = rng.integers(4, min(h, w) - 24, 2)
            preds[b, y:y + 16, x:x + 18, 0] = rng.uniform(0.2, 0.95)
        preds[b, :10, :12, 0] = 0.9   # a cell on the frame corner
    preds[..., 0] += rng.uniform(0, 0.05, preds.shape[:-1]).astype(np.float32)
    preds[..., 1] = 1.0 - preds[..., 0]
    return preds


def test_unet_postprocess_exact():
    preds = _predictions(1)[0]
    want_l, want_hc = jpred.unet_postprocess(jnp.asarray(preds))
    got_l, got_hc = tpred.unet_postprocess(torch.from_numpy(preds))
    np.testing.assert_array_equal(got_hc.numpy(), np.asarray(want_hc))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert got_l.max() >= 4


def test_unet_postprocess_batch_exact_and_equals_per_frame():
    preds = _predictions(3)
    preds[1, ..., 0], preds[1, ..., 1] = 0.0, 1.0   # a frame with no HC at all
    want_l, want_hc = jpred.unet_postprocess_batch(jnp.asarray(preds))
    got_l, got_hc = tpred.unet_postprocess_batch(torch.from_numpy(preds))
    np.testing.assert_array_equal(got_hc.numpy(), np.asarray(want_hc))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    for b in range(3):
        one_l, one_hc = tpred.unet_postprocess(torch.from_numpy(preds[b]))
        assert torch.equal(one_l, got_l[b]) and torch.equal(one_hc, got_hc[b])


def test_find_desired_shape():
    assert tpred.find_desired_shape(100, 120) == jpred.find_desired_shape(100, 120)
    assert tpred.find_desired_shape(128, 129) == (128, 256)
    assert tpred.find_desired_shape(1, 1024) == (1, 1024)


def _predictors(variables, shape, fold_bn=True):
    """A JAX and a port predictor on the same float32 weights."""
    jp = jpred.SegmentationPredictor(None, shape, depth=2, base_filters=8,
                                     dtype=jnp.float32, variables=variables,
                                     fold_bn=fold_bn)
    tp = tpred.SegmentationPredictor(
        None, shape, depth=2, base_filters=8, dtype=torch.float32,
        variables=unet_state_from_flax(variables), fold_bn=fold_bn,
        device="cpu")
    return jp, tp


def test_prepare_image_non_power_of_two():
    img = (np.random.default_rng(0).random((2, 100, 120)) * 60000).astype(np.float32)
    jp, tp = _predictors(flax_variables(), img.shape)
    want, want_pad = jp.prepare_image(img)
    got, got_pad = tp.prepare_image(img)
    assert tuple(got.shape) == (1, 128, 128, 2) and got_pad == want_pad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert float(got[0, :8].abs().max()) == 0.0 and float(got[0, :, :28].abs().max()) == 0.0
    assert tp.model_shape == jp.model_shape == (128, 128, 2)


@pytest.mark.parametrize("fold_bn", [True, False], ids=["folded", "bn"])
def test_predictor_matches_jax(fold_bn):
    """predict and predict_batch on a non-power-of-two frame, float32: the
    probabilities agree to 1e-5 and, as the guard shows no pixel within that
    of the 0.1 threshold, masks and labels are equal."""
    imgs = (np.random.default_rng(1).random((2, 2, 60, 70)) * 50000).astype(np.float32)
    jp, tp = _predictors(flax_variables(seed=2), imgs[0].shape, fold_bn)
    assert tp.model.norm == ("shift" if fold_bn else "bn")
    pj = np.asarray(jp._forward(jp.prepare_image(imgs[0])[0]))
    pt = tp._forward(tp.prepare_image(imgs[0])[0]).numpy()
    err = np.abs(pt - pj).max()
    assert err <= 1e-5
    assert np.abs(pj[..., 0] - 0.1).min() > err
    want_l, want_hc = jp.predict_batch(imgs)
    got_l, got_hc = tp.predict_batch(imgs)
    assert tuple(got_l.shape) == (2, 70, 60)
    np.testing.assert_array_equal(got_hc.numpy(), np.asarray(want_hc))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    one_l, one_hc = tp.predict(imgs[0])
    assert torch.equal(one_l, got_l[0]) and torch.equal(one_hc, got_hc[0])


def test_predictor_config_and_default_weights():
    tp = tpred.SegmentationPredictor(None, (2, 60, 70), depth=2, base_filters=4,
                                     device="cpu")
    cfg = tp.pipeline_config(batch=4)
    assert {k: cfg[k] for k in ("quantized", "depth", "base_filters", "norm",
                                "batch")} == {
        "quantized": False, "depth": 2, "base_filters": 4, "norm": "shift",
        "batch": 4}
    model = tpred.unet_from_config(cfg, torch.device("cpu"))
    assert model.dtype == torch.bfloat16 and not model.training
    assert all(not p.requires_grad for p in model.parameters())
    again = tpred.SegmentationPredictor(None, (2, 60, 70), depth=2,
                                        base_filters=4, device="cpu")
    for k, v in cfg["params"].items():   # default generator: seed 0
        assert torch.equal(v, again.model.state_dict()[k]), k


@pytest.mark.cuda
def test_unet_forward_on_card_matches_cpu():
    """float32 with TF32 off: card and CPU agree to summation order; bfloat16
    on the card rounds each conv's output once more than the CPU route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(2, 64, 64, 2, generator=gen)
    for tdt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
        model = build_unet((64, 64, 2), depth=2, base_filters=8, dtype=tdt,
                           generator=gen).eval()
        with torch.no_grad():
            for block in model.blocks:   # running statistics off the identity
                for bn in (block.bn0, block.bn1):
                    bn.running_mean.uniform_(0.0, 0.5, generator=gen)
                    bn.running_var.uniform_(0.5, 1.5, generator=gen)
            want = model(x)
            got = model.cuda()(x.cuda()).cpu()
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
def test_postprocess_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    preds = torch.from_numpy(_predictions(3))
    want_l, want_hc = tpred.unet_postprocess_batch(preds)
    got_l, got_hc = tpred.unet_postprocess_batch(preds.cuda())
    assert torch.equal(got_l.cpu(), want_l) and torch.equal(got_hc.cpu(), want_hc)
