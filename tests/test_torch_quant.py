"""PyTorch port vs the JAX package: the int8 U-Net path (``models/quant.py``).

The same numpy-seeded inputs and the same parameters (Flax variables carried
across by ``unet_state_from_flax``, JAX qparams by ``quant_params_from_jax``)
go through the JAX function and its counterpart in the port:

- the plain int8 conv's int32 sums equal JAX's ``_conv_s8`` exactly (Cin 2,
  3 and 16, odd sizes), and the split-conv identity holds;
- the int8 double convs (``_dc_int8``, ``_dc_int8_split``) equal JAX's int8
  outputs bit for bit on JAX qparams (jitted, as the JAX package runs them);
- ``quantize_unet``: ``wq`` / ``wscale`` exact, activation scales within rel
  1e-5 (they are maxima of float32 forwards summed in another order);
- ``unet_f32_apply`` equals the port's ``UNet(norm="shift")`` within 1e-5;
- ``unet_int8_apply`` on JAX qparams: within 1e-6 of JAX's ``_forward_int8``
  run eagerly. Against the jitted ``unet_int8_apply`` the bar is mean |dP| <=
  5e-3 and argmax agreement >= 0.98: on the CPU, XLA's jit keeps the
  bfloat16 dequantize product before the transposed convs and the head in
  float32, while the port rounds it to bfloat16 as the JAX code is written
  (the test pins that jitted and eager JAX differ by more than 1e-4 there);
- the quantized predictor against JAX's: HC-mask agreement >= 0.99; a
  BatchNorm that cannot be folded keeps the bfloat16 path with a warning.

The ``cuda`` cases hold the kernel to its plain version on the card, bit for
bit, and skip without one.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tissue_image_processing_tpu_torch.models import predictor as tpred
from tissue_image_processing_tpu_torch.models import quant as tq
from tissue_image_processing_tpu_torch.models.unet import UNet
from tissue_image_processing_tpu_torch.ops import conv_s8_cuda as tconv
from tissue_image_processing_tpu_torch.utils.state import (
    quant_params_from_jax, unet_state_from_flax)

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


jq = _Lazy("tissue_image_processing_tpu.models.quant")
junet = _Lazy("tissue_image_processing_tpu.models.unet")
jpred = _Lazy("tissue_image_processing_tpu.models.predictor")

DEPTH, FILTERS = 2, 8


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


@pytest.fixture(scope="module")
def folded():
    """Folded (norm="shift") Flax variables of a depth-2, 8-filter U-Net with
    BatchNorm statistics away from the identity (all scales > 0)."""
    _, variables = junet.build_unet((32, 32, 2), depth=DEPTH,
                                    base_filters=FILTERS, seed=1)
    rng = np.random.default_rng(1)

    def perturb(path, x):
        x = np.asarray(x)
        if "kernel" in str(path):
            return x
        return (x + rng.uniform(0.01, 0.5, x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb,
                                                 jax.device_get(variables))
    return jax.device_get(junet.fold_batchnorm(variables, depth=DEPTH))


@pytest.fixture(scope="module")
def sample():
    return np.random.default_rng(2).random((2, 32, 32, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def qparams(folded, sample):
    """JAX qparams (numpy leaves) and their port form."""
    qj = jax.device_get(jq.quantize_unet(folded, jnp.asarray(sample),
                                         depth=DEPTH))
    return qj, quant_params_from_jax(qj)


# --- the int8 conv ---------------------------------------------------------------

@pytest.mark.parametrize("cin", [2, 3, 16])
def test_conv_s8_sums_exact(cin):
    rng = np.random.default_rng(cin)
    x = rng.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, cin, 24)).astype(np.int8)
    x[0, :2] = 127          # the extremes, on the edge
    w[:, :, 0, 0] = -127
    want = np.asarray(jq._conv_s8(jnp.asarray(x), jnp.asarray(w)))
    got = tconv.conv3x3_s8_acc_plain(torch.from_numpy(x), _oihw(w))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv_s8_split_identity():
    """conv(concat([a, b]), W) = conv(a, W[:, :Ca]) + conv(b, W[:, Ca:]),
    exactly, on both packages' sums."""
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (1, 16, 16, 3)).astype(np.int8)
    b = rng.integers(-127, 128, (1, 16, 16, 5)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 8, 4)).astype(np.int8)
    full = tconv.conv3x3_s8_acc_plain(torch.from_numpy(np.concatenate([a, b], -1)),
                                      _oihw(w))
    split = (tconv.conv3x3_s8_acc_plain(torch.from_numpy(a), _oihw(w[:, :, :3]))
             + tconv.conv3x3_s8_acc_plain(torch.from_numpy(b), _oihw(w[:, :, 3:])))
    assert torch.equal(full, split)
    want = np.asarray(jq._conv_s8(jnp.asarray(np.concatenate([a, b], -1)),
                                  jnp.asarray(w)))
    np.testing.assert_array_equal(full.numpy(), want)


def test_pack_conv_s8_weight_layout():
    """Row n holds channel n's weights at k = (dy * 3 + dx) * Cin + c, zero
    up to the kernel's tile sizes."""
    rng = np.random.default_rng(3)
    wq = torch.from_numpy(rng.integers(-127, 128, (5, 2, 3, 3)).astype(np.int8))
    p = tconv.pack_conv_s8_weight(wq)
    assert tuple(p.shape) == (128, 32) and p.dtype == torch.int8
    for n, dy, dx, c in ((0, 0, 0, 0), (4, 2, 1, 1), (2, 1, 2, 0)):
        assert p[n, (dy * 3 + dx) * 2 + c] == wq[n, c, dy, dx]
    assert not p[5:].any() and not p[:, 18:].any()


def test_exact_div_is_correctly_rounded():
    """exact_div against float64 division rounded once to float32."""
    x = np.random.default_rng(4).gamma(2.0, 3.0, 4096).astype(np.float32)
    got = tconv.exact_div(torch.from_numpy(x), 127.0).numpy()
    np.testing.assert_array_equal(got, (x.astype(np.float64) / 127.0)
                                  .astype(np.float32))
    got = tconv.exact_div(127.0, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, (127.0 / x.astype(np.float64))
                                  .astype(np.float32))


# --- the int8 double convs ---------------------------------------------------------

def test_dc_int8_exact(qparams):
    qj, qt = qparams
    rng = np.random.default_rng(5)
    for k, cin, hw in ((0, 2, (17, 13)), (1, 8, (16, 16))):
        xq = rng.integers(-127, 128, (2, *hw, cin)).astype(np.int8)
        d = qj["params"][f"DoubleConv_{k}"]
        want, want_s = jax.jit(lambda a, d=d: jq._dc_int8(a, jnp.float32(0.7),
                                                         d))(jnp.asarray(xq))
        got, got_s = tq._dc_int8(torch.from_numpy(xq), torch.tensor(0.7),
                                 tq._block(qt, k))
        assert got.dtype == torch.int8 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got_s) == float(want_s)
        assert len(np.unique(got.numpy())) > 20   # not saturated or empty


def test_dc_int8_split_exact(qparams):
    qj, qt = qparams
    rng = np.random.default_rng(6)
    upq = rng.integers(-127, 128, (2, 16, 14, 16)).astype(np.int8)
    skq = rng.integers(-127, 128, (2, 16, 14, 16)).astype(np.int8)
    d = qj["params"]["DoubleConv_3"]
    want, _ = jax.jit(lambda a, b: jq._dc_int8_split(
        a, jnp.float32(0.9), b, jnp.float32(1.3), d))(jnp.asarray(upq),
                                                      jnp.asarray(skq))
    got, _ = tq._dc_int8_split(torch.from_numpy(upq), torch.tensor(0.9),
                               torch.from_numpy(skq), torch.tensor(1.3),
                               tq._block(qt, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pool2_and_quant_match_jax():
    rng = np.random.default_rng(7)
    x = rng.integers(-127, 128, (2, 6, 10, 3)).astype(np.int8)
    np.testing.assert_array_equal(tq._pool2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jq._pool2(jnp.asarray(x))))
    y = (rng.standard_normal((3, 64)) * 4).astype(np.float32)
    y[0, :4] = [0.5, 1.5, -2.5, 1000.0]   # halves round to even; clipping
    for a in (1.0, 3.7, 250.0):
        np.testing.assert_array_equal(
            tq._quant(torch.from_numpy(y), torch.tensor(a)).numpy(),
            np.asarray(jq._quant(jnp.asarray(y), jnp.float32(a))))


# --- quantization and the forwards ----------------------------------------------------

def test_quantize_unet_matches_jax(folded, sample, qparams):
    _, want = qparams
    got = tq.quantize_unet(unet_state_from_flax(folded), torch.from_numpy(sample),
                           depth=DEPTH)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v.dtype == torch.int8 or k.endswith(".wscale"):
            assert torch.equal(got[k], v), k
        else:
            torch.testing.assert_close(got[k], v, rtol=1e-5, atol=0, msg=k)


def test_unet_f32_apply_matches_model(folded, sample):
    state = unet_state_from_flax(folded)
    model = UNet(depth=DEPTH, base_filters=FILTERS, norm="shift")
    model.load_state_dict(state)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(sample))
    got = tq.unet_f32_apply(state, torch.from_numpy(sample), depth=DEPTH)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    jwant = np.asarray(jq.unet_f32_apply(folded, jnp.asarray(sample), depth=DEPTH))
    np.testing.assert_allclose(got.numpy(), jwant, rtol=0, atol=1e-5)


def test_unet_int8_apply_matches_jax(qparams, sample):
    qj, qt = qparams
    got = tq.unet_int8_apply(qt, torch.from_numpy(sample), depth=DEPTH).numpy()
    assert got.shape == (2, 32, 32, 2)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    with jax.disable_jit():
        eager = np.asarray(jq._forward_int8(
            jax.tree_util.tree_map(jnp.asarray, qj["params"]),
            jnp.asarray(sample), DEPTH))
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-6)
    jitted = np.asarray(jq.unet_int8_apply(qj, jnp.asarray(sample), depth=DEPTH))
    assert np.abs(eager - jitted).mean() > 1e-4   # the reference's own gap
    assert np.abs(got - jitted).mean() <= 5e-3
    assert (got.argmax(-1) == jitted.argmax(-1)).mean() >= 0.98


def test_int8_close_to_float(folded, sample, qparams):
    _, qt = qparams
    got = tq.unet_int8_apply(qt, torch.from_numpy(sample), depth=DEPTH)
    want = tq.unet_f32_apply(unet_state_from_flax(folded),
                             torch.from_numpy(sample), depth=DEPTH)
    assert float((got - want).abs().mean()) < 0.02
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) > 0.98


# --- the predictor ---------------------------------------------------------------------

def test_quantized_predictor_matches_jax():
    """Both predictors on the same float32 weights with quantize=True: lazy
    calibration on the first batch, then HC masks within 1% of each other;
    the port's int8 parameters equal JAX's scales to rel 1e-5."""
    _, variables = junet.build_unet((64, 64, 2), depth=DEPTH,
                                    base_filters=FILTERS, seed=3)
    variables = jax.device_get(variables)
    imgs = (np.random.default_rng(8).random((2, 2, 60, 70)) * 50000).astype(
        np.float32)
    kw = dict(depth=DEPTH, base_filters=FILTERS)
    jp = jpred.SegmentationPredictor(None, imgs[0].shape, dtype=jnp.float32,
                                     variables=variables, quantize=True, **kw)
    tp = tpred.SegmentationPredictor(None, imgs[0].shape, dtype=torch.float32,
                                     variables=unet_state_from_flax(variables),
                                     quantize=True, device="cpu", **kw)
    assert jp.quantize and tp.quantize
    with pytest.raises(ValueError):
        tp.pipeline_config()           # no scales yet
    _, want_hc = jp.predict_batch(imgs)
    got_l, got_hc = tp.predict_batch(imgs)
    assert tp._qparams is not None
    agree = float((got_hc.numpy() == np.asarray(want_hc)).mean())
    assert agree >= 0.99, agree
    assert got_l.max() > 0
    want_q = quant_params_from_jax(jax.device_get(jp._qparams))
    for k in ("in_scale", "blocks.0.out_scale", "ups.0.out_scale"):
        torch.testing.assert_close(tp._qparams[k], want_q[k], rtol=1e-5, atol=0)
    cfg = tp.pipeline_config(batch=2)
    assert cfg["quantized"] and cfg["params"] is tp._qparams
    assert isinstance(tpred.unet_from_config(cfg, torch.device("cpu")),
                      tq.Int8UNet)


def test_predictor_calibrate_and_blank_warning():
    imgs = (np.random.default_rng(9).random((2, 64, 64)) * 50000).astype(np.float32)
    tp = tpred.SegmentationPredictor(None, imgs.shape, depth=DEPTH,
                                     base_filters=4, dtype=torch.float32,
                                     quantize=True, device="cpu")
    tp.calibrate(imgs)
    q = tp._qparams
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tp.predict(imgs)               # calibrated: no new scales, no warning
    assert tp._qparams is q
    blank = tpred.SegmentationPredictor(None, imgs.shape, depth=DEPTH,
                                        base_filters=4, dtype=torch.float32,
                                        quantize=True, device="cpu")
    with pytest.warns(UserWarning, match="near-constant"):
        blank._forward(torch.zeros(1, 64, 64, 2))


def test_quantize_keeps_bf16_when_the_fold_fails():
    """A BatchNorm scale <= 0 blocks the fold; like JAX, the predictor warns
    and keeps the float path (the int8 path needs the folded model)."""
    model = UNet(depth=DEPTH, base_filters=4)
    with torch.no_grad():
        model.blocks[0].bn0.weight[0] = -1.0
    with pytest.warns(UserWarning, match="folded-BatchNorm"):
        tp = tpred.SegmentationPredictor(None, (2, 32, 32), depth=DEPTH,
                                         base_filters=4, variables=model.state_dict(),
                                         quantize=True, device="cpu")
    assert not tp.quantize and tp.model.norm == "bn"
    assert tp.pipeline_config()["quantized"] is False


def test_int8_witness_pair_matches_jax():
    """``tests/int8_witness.py`` (the JAX package's int8-vs-bfloat16 pair on
    the smoke run's random network) at a small size: its Flax variables
    carry the port's folded state exactly, the two packages' bfloat16
    forwards agree to 1e-6, their int8 forwards within the jitted JAX gap
    (``test_unet_int8_apply_matches_jax``), and so do their accuracy
    pairs."""
    from int8_witness import flax_from_unet_state, int8_pair

    from tissue_image_processing_tpu_torch.models.unet import fold_batchnorm
    from tissue_image_processing_tpu_torch.utils.synthetic import (
        make_movie, random_unet)

    model = random_unet(DEPTH, FILTERS, seed=0, dtype=torch.bfloat16)
    state = fold_batchnorm(model).state_dict()
    back = unet_state_from_flax(flax_from_unet_state(state, DEPTH))
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    frames = torch.from_numpy(make_movie(T=2, Z=1, H=64, W=64, seed=0)[:, :, 0])
    x, _ = tpred.prepare_batch(frames)
    out, probs = int8_pair(model, x, DEPTH, FILTERS)
    assert out["port_vs_jax_bf16_mean_abs_dp"] <= 1e-6
    assert out["port_vs_jax_int8_mean_abs_dp"] <= 5e-3
    assert out["port_vs_jax_int8_hc_agreement"] >= 0.98
    assert abs(out["port_hc_agreement"] - out["jax_hc_agreement"]) <= 0.02
    assert abs(out["port_dice"] - out["jax_dice"]) <= 0.05
    assert all(p.shape == (2, 64, 64, 2) for p in probs.values())


# --- the kernel on the card --------------------------------------------------------------

def _random_conv(rng, B, H, W, cin, cout, device, skip_cin=0):
    def t(a):
        return torch.from_numpy(a).to(device)

    x = t(rng.integers(-127, 128, (B, H, W, cin)).astype(np.int8))
    skip = (t(rng.integers(-127, 128, (B, H, W, skip_cin)).astype(np.int8))
            if skip_cin else None)
    wq = t(rng.integers(-127, 128, (cout, cin + skip_cin, 3, 3)).astype(np.int8))
    wscale = t((rng.random(cout) * 2e-3 + 1e-4).astype(np.float32))
    bias = t((rng.standard_normal(cout) * 0.1).astype(np.float32))
    shift = t((rng.standard_normal(cout) * 0.1).astype(np.float32))
    scales = [t(np.array(s, np.float32)) for s in (0.8, 1.1, 1.7)]
    return x, skip, wq, wscale, bias, shift, scales


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,cin,cout,skip_cin", [
    (2, 64, 64, 2, 128, 0), (1, 33, 17, 3, 24, 0), (2, 16, 16, 32, 40, 0),
    (1, 64, 48, 128, 256, 0), (2, 32, 32, 64, 64, 64), (1, 19, 23, 16, 8, 5),
    (1, 129, 130, 96, 136, 0)])
def test_conv3x3_s8_kernel_matches_plain(B, H, W, cin, cout, skip_cin):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import tissue_image_processing_tpu_torch as tipt

    rng = np.random.default_rng(cin * 1000 + cout)
    x, skip, wq, wscale, bias, shift, (s0, s1, so) = _random_conv(
        rng, B, H, W, cin, cout, "cuda", skip_cin)
    kw = dict(skip=skip, skip_scale=s1 if skip_cin else None)
    n = tipt.LAUNCHES["conv3x3_s8"]
    got = tconv.conv3x3_s8(x, wq, wscale, bias, shift, s0, so, **kw)
    assert tipt.LAUNCHES["conv3x3_s8"] == n + 1
    want = tconv.conv3x3_s8_plain(x, wq, wscale, bias, shift, s0, so, **kw)
    assert torch.equal(got, want)
    assert len(torch.unique(got)) > 20
    cpu = tconv.conv3x3_s8_plain(*(t.cpu() if t is not None else None for t in (
        x, wq, wscale, bias, shift, s0, so)), skip=None if skip is None else
        skip.cpu(), skip_scale=None if skip is None else s1.cpu())
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_int8_unet_on_card_matches_cpu(sample):
    """The whole int8 forward: the int8 blocks are exact on both; the
    bfloat16 transposed convs and head round once more on the card (cuDNN
    returns bfloat16), so probabilities agree to 0.02 and argmax on >= 0.99.
    (The port's own quantizer: the card's machine has no flax.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tissue_image_processing_tpu_torch.models.unet import (
        build_unet, fold_batchnorm)

    model = fold_batchnorm(build_unet((32, 32, 2), depth=DEPTH,
                                      base_filters=FILTERS,
                                      generator=torch.Generator().manual_seed(5)))
    x = torch.from_numpy(sample)
    qt = tq.quantize_unet(model, x, depth=DEPTH)
    want = tq.unet_int8_apply(qt, x, depth=DEPTH)
    got = tq.unet_int8_apply(qt, x.cuda(), depth=DEPTH).cpu()
    assert float((got - want).abs().max()) <= 0.02
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) >= 0.99
