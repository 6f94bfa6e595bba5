"""PyTorch port vs the JAX package: U-Net training (``models/train.py``).

- ``crop_generator`` equals the JAX generator draw for draw (same seed,
  several batches, boundary-heavy crops rejected the same way);
- one float32 train step of a depth-2, 4-filter U-Net on 32 x 32 crops
  (dropout 0 on both sides: the two frameworks' dropout streams cannot
  match) against the optax step from the same weights: the loss to rel
  1e-5; each gradient to 1e-4 of its largest magnitude (float32 sums in
  another order through a deeper graph: measured <= 4.4e-6, and up to 1e-5
  when XLA fuses the gradient differently); the BatchNorm running statistics (Flax's momentum 0.99
  and biased variance) to 1e-6; the stepped parameters to 2 x lr (Adam's
  first step is about lr * sign(g), so a gradient within round-off of 0 may
  step the other way);
- ``save_checkpoint`` round trip; ``train_unet`` on the CPU at a small size.
"""

import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tissue_image_processing_tpu_torch.models import train as ttrain
from tissue_image_processing_tpu_torch.models.unet import UNet
from tissue_image_processing_tpu_torch.utils.state import unet_state_from_flax

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)


class _Lazy:
    """A JAX-package module imported at first use (the model modules need
    flax and optax)."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jtrain = _Lazy("tissue_image_processing_tpu.models.train")
junet = _Lazy("tissue_image_processing_tpu.models.unet")

LR = 1e-5


def _frames(seed=0, shape=(300, 320), boundary_rows=None):
    rng = np.random.default_rng(seed)
    img = (rng.random((2, *shape)) * 1000).astype(np.float32)
    lab = rng.integers(1, 3, shape).astype(np.int32)
    lab[:, ::7] = 0
    if boundary_rows is not None:
        lab[boundary_rows:] = 0
    return img, lab


@pytest.mark.parametrize("case", ["policy", "rejection"])
def test_crop_generator_draw_for_draw(case):
    if case == "policy":
        frames = [_frames(0), _frames(1, (280, 290))]
        kw = dict(batch_size=3, crop=64, seed=5)
    else:   # the lower half all boundary: those crops are drawn, then dropped
        frames = [_frames(2, (300, 300), boundary_rows=150)]
        kw = dict(batch_size=4, crop=64, seed=1)
    images, labels = [f[0] for f in frames], [f[1] for f in frames]
    want = jtrain.crop_generator(images, labels, **kw)
    got = ttrain.crop_generator(images, labels, **kw)
    for _ in range(3):
        (wx, wy), (gx, gy) = next(want), next(got)
        assert gx.shape == (kw["batch_size"], 64, 64, 2) and gx.dtype == np.float32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    if case == "rejection":
        assert (gy.sum((1, 2, 3)) > 0.7 * 64 * 64).all()


def test_crop_generator_rejects_small_frames():
    img, lab = _frames(0, (64, 300))
    with pytest.raises(ValueError):
        next(ttrain.crop_generator([img], [lab], batch_size=1, crop=64))


@pytest.fixture(scope="module")
def one_step():
    """The JAX and the port train step from the same weights on one batch:
    (jax loss, jax grads state, jax new state, port loss, port model)."""
    jmodel = junet.UNet(depth=2, base_filters=4, dtype=jnp.float32,
                        dropout_rate=0.0)
    state, tx = jtrain.create_train_state(jmodel, (32, 32, 2),
                                          learning_rate=LR, seed=0)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    rng = np.random.default_rng(0)
    x = rng.random((4, 32, 32, 2)).astype(np.float32)
    y_cls = (x[..., 0] > 0.5).astype(np.float32)
    y = np.stack([y_cls, 1 - y_cls], -1)

    def loss_fn(params):
        out, mut = jmodel.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        ce = -jnp.sum(jnp.asarray(y) * jnp.log(out + 1e-7), axis=-1)
        acc = jnp.mean(jnp.argmax(out, -1) == jnp.argmax(jnp.asarray(y), -1))
        return jnp.mean(ce), (mut["batch_stats"], acc)

    # make_train_step's body, with the gradients kept for the comparison
    (jloss, (stats, jacc)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    updates, _ = tx.update(grads, state.opt_state, state.params)
    jnew = jax.device_get({"params": optax.apply_updates(state.params, updates),
                           "batch_stats": stats})
    grads = jax.device_get(grads)

    model = UNet(depth=2, base_filters=4, dropout_rate=0.0)
    tstate, topt = ttrain.create_train_state(model, (32, 32, 2),
                                             learning_rate=LR, device="cpu")
    model.load_state_dict(unet_state_from_flax(variables))
    tstate, tloss, tacc = ttrain.make_train_step(model, topt)(tstate, x, y)
    gstate = unet_state_from_flax({"params": grads,
                                   "batch_stats": variables["batch_stats"]})
    return dict(jloss=float(jloss), jacc=float(jacc), grads=gstate,
                jnew=unet_state_from_flax(jnew),
                start=unet_state_from_flax(variables), tloss=float(tloss),
                tacc=float(tacc), model=model, tstate=tstate)


def test_train_step_loss_and_accuracy(one_step):
    s = one_step
    assert s["tstate"].step == 1
    assert abs(s["tloss"] - s["jloss"]) <= 1e-5 * abs(s["jloss"])
    assert s["tacc"] == s["jacc"]


def test_train_step_gradients(one_step):
    s = one_step
    named = dict(s["model"].named_parameters())
    assert sorted(named) == sorted(k for k in s["grads"]
                                   if "running" not in k and "num_batches" not in k)
    for k, p in named.items():
        want = s["grads"][k]
        scale = float(want.abs().max())
        assert scale > 0, k
        torch.testing.assert_close(p.grad, want, rtol=0, atol=1e-4 * scale,
                                   msg=k)


def test_train_step_batch_statistics_and_update(one_step):
    s = one_step
    got = s["model"].state_dict()
    for k, want in s["jnew"].items():
        if "running" in k:
            torch.testing.assert_close(got[k], want, rtol=0, atol=1e-6, msg=k)
            assert not torch.equal(want, s["start"][k]), k   # it moved
        elif "num_batches" not in k:
            torch.testing.assert_close(got[k], want, rtol=0, atol=2 * LR, msg=k)
            moved = (want - s["start"][k]).abs()
            assert float(moved.max()) > 0.5 * LR, k


def test_save_checkpoint_round_trip(tmp_path):
    model = UNet(depth=2, base_filters=4)
    history = {"loss": [0.7, 0.5], "accuracy": [0.5, 0.6]}
    path = tmp_path / "ckpt.pt"
    ttrain.save_checkpoint(str(path), model.state_dict(), history)
    loaded = torch.load(str(path))
    assert sorted(loaded) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(loaded[k], v), k
    with open(str(path) + ".history.pkl", "rb") as f:
        assert pickle.load(f) == history
    again = UNet(depth=2, base_filters=4)
    again.load_state_dict(loaded)


def test_train_unet_small_on_cpu():
    frames = [_frames(s, (80, 96)) for s in range(2)]
    model, state, history = ttrain.train_unet(
        [f[0] for f in frames], [f[1] for f in frames], epochs=2,
        steps_per_epoch=2, batch_size=2, crop=32, depth=2, base_filters=4,
        learning_rate=1e-3, dtype=torch.float32, device="cpu", verbose=False)
    assert len(history["loss"]) == 2 and np.isfinite(history["loss"]).all()
    assert not model.training and sorted(state) == sorted(model.state_dict())
    assert 0.0 <= history["accuracy"][-1] <= 1.0


def test_main_reads_npy_only(tmp_path, monkeypatch):
    """``main`` reads its frames as the JAX ``main`` does, through
    ``io/tiff.read_whole_image``: ``.tif`` and ``.npy`` alike (the name is
    from when the port read ``.npy`` only)."""
    from tissue_image_processing_tpu_torch.io.tiff import save_tiff

    rng = np.random.default_rng(0)
    image0 = (rng.random((2, 8, 8)) * 60000).astype(np.uint16)
    image1 = rng.random((2, 8, 8)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 8, 8)).astype(np.uint8)
    save_tiff(str(tmp_path / "image_0.tif"), image0, axes="CYX")
    np.save(tmp_path / "image_1.npy", image1)
    save_tiff(str(tmp_path / "labels_0.tif"), labels[0], axes="YX")
    np.save(tmp_path / "labels_1.npy", labels[1])
    seen = {}

    def fake_train(images, labels, **kwargs):
        seen.update(images=images, labels=labels, **kwargs)
        return None, {"w": torch.zeros(1)}, {"loss": [0.5]}

    monkeypatch.setattr(ttrain, "train_unet", fake_train)
    out = tmp_path / "out" / "ckpt.pt"
    assert ttrain.main(["--data-path", str(tmp_path), "--epochs", "1",
                        "--out", str(out), "--device", "cpu"]) == 0
    for got, want in zip(seen["images"] + seen["labels"],
                         [image0, image1, labels[0], labels[1]]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert seen["epochs"] == 1 and seen["device"] == "cpu"
    assert torch.load(str(out))["w"].shape == (1,)
    (tmp_path / "labels_2.png").write_bytes(b"")
    with pytest.raises(ValueError, match="unsupported image container"):
        ttrain.main(["--data-path", str(tmp_path), "--out", str(out)])
