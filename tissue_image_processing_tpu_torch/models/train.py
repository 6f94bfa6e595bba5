"""U-Net training: Adam, a BatchNorm-aware train step and the reference's
data policy.

Port of ``tissue_image_processing_tpu/models/train.py``: random 256 x 256
crops of annotated (image, label) frames, each crop divided by its maximum,
rotated by k x 90 degrees, two-channel one-hot targets (label 1 -> HC
channel, label 2 -> SC channel), crops with 30% or more boundary pixels
rejected; Adam at lr 1e-5, batch 32, categorical cross-entropy. Batches are
made on the host by a numpy generator that draws exactly as the JAX one.

The convolutions are library calls and autograd takes their gradients (no
kernel of the port lies on this path). BatchNorm normalises with the batch's
biased variance and updates its running statistics as Flax does
(``models/unet.py``). Dropout draws from PyTorch's generator, so its masks
are not the JAX package's.

Run: ``python -m tissue_image_processing_tpu_torch.models.train --data-path
DIR`` with ``image_*`` / ``labels_*`` pairs ((C, Y, X) frames and (Y, X)
label maps; ``.tif``, ``.npy`` or ``.czi``, read as the JAX ``main`` reads
them).
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tissue_image_processing_tpu_torch._device import resolve_device
from tissue_image_processing_tpu_torch.models.unet import (
    UNet, _full_float32_convs, init_unet_)

__all__ = ["TrainState", "create_train_state", "make_train_step",
           "crop_generator", "train_unet", "save_checkpoint", "main"]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and
    the number of steps taken."""
    model: UNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: UNet, input_shape, learning_rate: float = 1e-5,
                       seed: int = 0, device=None):
    """Initialise ``model`` from ``seed`` (``init_unet_``; ``input_shape =
    (X, Y, C)`` must match its input channels), move it to ``device``
    (None: the card) in training mode, and pair it with Adam (optax's
    defaults: betas 0.9 / 0.999, eps 1e-8). Returns (state, optimizer)."""
    if input_shape[-1] != model.in_channels:
        raise ValueError(f"input_shape {tuple(input_shape)} does not match the "
                         f"model's {model.in_channels} input channels")
    dev = resolve_device(device)
    init_unet_(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    tx = torch.optim.Adam(model.parameters(), lr=learning_rate,
                          betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, tx, 0), tx


def _loss_and_accuracy(out: torch.Tensor, batch_y: torch.Tensor):
    """Categorical cross-entropy of the softmax ``out`` (eps 1e-7 inside the
    log, as the JAX package) and the argmax accuracy."""
    ce = -(batch_y * torch.log(out + 1e-7)).sum(dim=-1)
    acc = (out.argmax(-1) == batch_y.argmax(-1)).float().mean()
    return ce.mean(), acc


def make_train_step(model: UNet, tx: torch.optim.Optimizer):
    """``step(state, batch_x, batch_y) -> (state, loss, accuracy)``: one Adam
    step on (B, X, Y, C) inputs and (B, X, Y, 2) one-hot targets (tensors
    or numpy arrays, moved to the model's device). ``loss`` and
    ``accuracy`` stay on the device."""
    def train_step(state: TrainState, batch_x, batch_y):
        dev = next(state.model.parameters()).device
        bx = torch.as_tensor(batch_x, dtype=torch.float32).to(dev)
        by = torch.as_tensor(batch_y, dtype=torch.float32).to(dev)
        state.model.train()
        tx.zero_grad(set_to_none=True)
        loss, acc = _loss_and_accuracy(state.model(bx), by)
        with _full_float32_convs(dev):   # float32 gradients without TF32
            loss.backward()
        tx.step()
        state.step += 1
        return state, loss.detach(), acc

    return train_step


def crop_generator(images: Sequence[np.ndarray], labels: Sequence[np.ndarray],
                   batch_size: int = 32, crop: int = 256,
                   max_boundary_fraction: float = 0.3, seed: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The reference's crop / augment policy, draw for draw the JAX
    package's (``np.random.default_rng(seed)``, the same calls in the same
    order).

    ``images``: (C, Y, X) annotated frames; ``labels``: (Y, X) maps with
    0 = boundary, 1 = HC, 2 = SC. Yields (B, crop, crop, C) inputs (x-major
    like the predictor) and (B, crop, crop, 2) one-hot targets."""
    rng = np.random.default_rng(seed)
    while True:
        xs, ys = [], []
        while len(xs) < batch_size:
            i = rng.integers(0, len(images))
            img, lab = images[i], labels[i]
            _, Y, X = img.shape
            if Y <= crop or X <= crop:
                raise ValueError("frames must be larger than the crop size")
            r0 = rng.integers(1, Y - crop)
            c0 = rng.integers(1, X - crop)
            k = rng.integers(0, 4)
            sub = img[:, r0:r0 + crop, c0:c0 + crop].astype(np.float32)
            m = sub.max() or 1.0
            sub = sub / m
            sub_lab = lab[r0:r0 + crop, c0:c0 + crop]
            sub = np.rot90(sub, k, axes=(2, 1))
            sub_lab = np.rot90(sub_lab, k, axes=(1, 0))
            boundary_fraction = np.count_nonzero(sub_lab == 0) / sub_lab.size
            if boundary_fraction >= max_boundary_fraction:
                continue
            onehot = np.zeros((crop, crop, 2), np.float32)
            onehot[..., 0][sub_lab.T == 1] = 1
            onehot[..., 1][sub_lab.T == 2] = 1
            xs.append(np.transpose(sub))  # (crop, crop, C), x-major
            ys.append(onehot)
        yield np.stack(xs), np.stack(ys)


def train_unet(images, labels, epochs: int = 50, steps_per_epoch: int = 8,
               batch_size: int = 32, crop: int = 256,
               learning_rate: float = 1e-5, depth: int = 2,
               base_filters: int = 128, seed: int = 0,
               dtype: torch.dtype = torch.bfloat16, device=None,
               verbose: bool = True):
    """The training loop with the reference's recipe (a depth-2 net, 512
    bottleneck, bfloat16 convs with float32 parameters). Returns (model,
    its ``state_dict``, history with per-epoch mean ``loss`` and
    ``accuracy``)."""
    model = UNet(depth=depth, base_filters=base_filters, dtype=dtype,
                 in_channels=images[0].shape[0])
    state, tx = create_train_state(model, (crop, crop, images[0].shape[0]),
                                   learning_rate, seed, device)
    step_fn = make_train_step(model, tx)
    gen = crop_generator(images, labels, batch_size, crop, seed=seed)
    torch.manual_seed(seed + 1)   # dropout
    history: Dict[str, List[float]] = {"loss": [], "accuracy": []}
    for epoch in range(epochs):
        losses, accs = [], []
        for _ in range(steps_per_epoch):
            bx, by = next(gen)
            state, loss, acc = step_fn(state, bx, by)
            losses.append(loss)
            accs.append(acc)
        # one host read an epoch
        history["loss"].append(float(torch.stack(losses).mean()))
        history["accuracy"].append(float(torch.stack(accs).mean()))
        if verbose:
            print(f"epoch {epoch + 1}/{epochs}: loss={history['loss'][-1]:.4f} "
                  f"acc={history['accuracy'][-1]:.4f}", flush=True)
    model.eval()
    return model, model.state_dict(), history


def save_checkpoint(path: str, state_dict, history: Optional[dict] = None
                    ) -> None:
    """``torch.save`` of the trained ``state_dict`` (host copies) at
    ``path``, and the history pickled at ``path + ".history.pkl"`` (the
    reference pickles its Keras history; the JAX package writes an orbax
    checkpoint)."""
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, str(path))
    if history is not None:
        with open(str(path) + ".history.pkl", "wb") as f:
            pickle.dump(history, f)


def _read_frames(pattern: str) -> List[np.ndarray]:
    """Every file matching ``pattern``, in name order, through
    ``io/tiff.read_whole_image`` (``.tif`` / ``.tiff``, ``.npy``, ``.czi``)."""
    import glob

    from tissue_image_processing_tpu_torch.io.tiff import read_whole_image

    return [read_whole_image(f)[0] for f in sorted(glob.glob(pattern))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--data-path", dest="data_path", default="data")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--steps-per-epoch", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--out", default="outputs/unet_ckpt.pt")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    import os

    images = _read_frames(os.path.join(args.data_path, "image_*"))
    labels = _read_frames(os.path.join(args.data_path, "labels_*"))
    _, state_dict, history = train_unet(
        images, labels, epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch, batch_size=args.batch_size,
        device=args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_checkpoint(os.path.abspath(args.out), state_dict, history)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
