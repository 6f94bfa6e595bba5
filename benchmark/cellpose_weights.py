"""The benchmark's Cellpose network, made on the card at set-up: seeded
initial weights, then a short training on frames of the benchmark's own
synthetic tissue, so that the network's flows point at the cells' centres
and the post-process sees the traffic's ~2,200 cells a 2000^2 frame. No
trained Cellpose file is in the repository.

The state dictionary has the keys of Cellpose v2's ``CPnet`` (the
reference's copy, ``reference/cellpose.py``). :func:`cellpose_state`
draws it from one ``torch.Generator`` on the device in two calls: one
uniform draw for every conv and ``Linear`` weight and bias, in +-1 /
sqrt(fan_in) as PyTorch initialises a freshly built ``CPnet``; one
uniform draw for every BatchNorm scale, bias and running statistic, away
from the identity (scales and variances in [0.5, 1.5]). ``diam_mean`` and
``diam_labels`` are 30, as in the ``cyto`` models.

:func:`trained_state` then trains it as Cellpose trains (its loss and its
targets: 5 x the unit flows of ``masks_to_flows`` and the cell mask) on
the frames of a movie of the configuration's training traffic drawn from
``weights_seed``, which no run draws; the cells of those frames are the
generator's Voronoi tessellation, read back from the membrane channel
(:func:`cell_labels`).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import scipy.ndimage as ndi
import torch
import torch.nn.functional as F

from benchmark.reference.cellpose import (
    CPnet, _normalize, eval_input, masks_to_flows)

__all__ = ["cellpose_state", "cell_labels", "training_set", "train",
           "trained_state"]

_BN_RANGES = {"weight": (0.5, 1.5), "bias": (-0.2, 0.2),
              "running_mean": (0.0, 0.5), "running_var": (0.5, 1.5)}
DIAM_MEAN = 30.0


def cellpose_state(seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 weights of ``CPnet`` drawn from ``seed`` on ``device``."""
    with torch.device("meta"):
        net = CPnet()
    shapes = net.state_dict()
    bns = {name + "." + k for name, m in net.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d) for k in _BN_RANGES}
    # conv and Linear weights and biases, by the weight's fan-in
    fans = {}
    for k, v in shapes.items():
        if k.endswith(".weight") and k not in bns:
            fans[k] = fans[k[:-len("weight")] + "bias"] = math.prod(
                v.shape[1:])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n_u = sum(math.prod(shapes[k].shape) for k in fans)
    n_bn = sum(math.prod(shapes[k].shape) for k in bns)
    u = torch.rand(n_u, generator=g, device=device, dtype=torch.float32)
    r = torch.rand(n_bn, generator=g, device=device, dtype=torch.float32)
    state, at_u, at_r = {}, 0, 0
    for key, ref in shapes.items():
        n = math.prod(ref.shape)
        if key in fans:
            bound = 1.0 / math.sqrt(fans[key])
            state[key] = (bound * (2.0 * u[at_u:at_u + n] - 1.0)).reshape(
                ref.shape)
            at_u += n
        elif key in bns:
            lo, hi = _BN_RANGES[key.rsplit(".", 1)[1]]
            state[key] = (lo + (hi - lo) * r[at_r:at_r + n]).reshape(ref.shape)
            at_r += n
        elif key in ("diam_mean", "diam_labels"):
            state[key] = torch.full(ref.shape, DIAM_MEAN, device=device)
        else:  # num_batches_tracked
            state[key] = torch.zeros(ref.shape, dtype=ref.dtype, device=device)
    return state


def cell_labels(frame: torch.Tensor, membrane: int = 0) -> np.ndarray:
    """The cells of one (C, Y, X) synthetic frame: 4-connected components
    of the pixels whose membrane channel, normalised as the eval path does
    (1st to 99th percentile), is below one half. The generator's ridges
    peak at 0.75-0.97 of the channel's scale over noise of 0.4%, so this
    is the Voronoi tessellation less its ridges. (Y, X) int64 labels."""
    img = _normalize(frame[membrane].to(torch.float32))
    return ndi.label((img < 0.5).cpu().numpy())[0]


def training_set(frames: torch.Tensor, diameter: float, channels=(0, 1),
                 min_size: int = 15) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, C, Y, X) frames -> the network's inputs (T, 2, LY, LX), as the
    eval path makes them, and Cellpose's training targets (T, 3, LY, LX):
    5 x the unit flows of ``masks_to_flows`` and the cell mask. The cells
    (:func:`cell_labels`) are resized to the network's scale by nearest
    neighbour; those under ``min_size`` pixels there are background."""
    rescale = DIAM_MEAN / float(diameter)
    xs, ys = [], []
    for frame in frames:
        img, (ly, lx), pads = eval_input(frame, rescale, channels)
        lab = torch.from_numpy(cell_labels(frame, channels[0]))
        lab = F.interpolate(lab[None, None].to(torch.float64), size=(ly, lx),
                            mode="nearest")[0, 0].to(torch.int64).numpy()
        sizes = np.bincount(lab.ravel())
        lab[sizes[lab] < min_size] = 0
        lab = np.unique(lab, return_inverse=True)[1].reshape(lab.shape)
        mu = masks_to_flows(lab, frame.device)
        y = torch.cat([5.0 * torch.from_numpy(mu).to(torch.float32),
                       torch.from_numpy(lab > 0).to(torch.float32)[None]])
        (t, b), (lft, r) = pads
        xs.append(img)
        ys.append(F.pad(y, (lft, r, t, b)).to(frame.device))
    return torch.stack(xs), torch.stack(ys)


def train(state: Dict[str, torch.Tensor], inputs: torch.Tensor,
          targets: torch.Tensor, steps: int, batch: int = 8,
          lr: float = 2e-3, seed: int = 0, tile: int = 224
          ) -> Dict[str, torch.Tensor]:
    """``state`` trained for ``steps`` steps on random ``tile``^2 crops of
    :func:`training_set`'s frames, ``batch`` a step, with Cellpose's loss
    (half the mean squared error of the flows plus the cell mask's binary
    cross-entropy), Adam at ``lr`` after a 50-step warm-up and down a
    cosine to 0, the forward in bfloat16 on the card, cuDNN's
    deterministic algorithms. The crops are drawn on the host from
    ``seed``; BatchNorm runs in training mode and keeps its running
    statistics. Returns the float32 state."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _train(state, inputs, targets, int(steps), int(batch),
                      float(lr), int(seed), int(tile))
    finally:
        torch.backends.cudnn.deterministic = prev


def _train(state, inputs, targets, steps, batch, lr, seed, tile):
    dev = inputs.device
    with torch.device(dev):
        net = CPnet()
    net.load_state_dict(state, strict=True)
    net.train()
    opt = torch.optim.Adam([q for q in net.parameters() if q.requires_grad],
                           lr=lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: min(
        1.0, (k + 1) / 50) * 0.5 * (1.0 + math.cos(math.pi * k / steps)))
    T, _, LY, LX = inputs.shape
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        pick = zip(rng.integers(0, T, batch), rng.integers(0, LY - tile + 1,
                                                          batch),
                   rng.integers(0, LX - tile + 1, batch))
        x, y = zip(*[(inputs[f, :, r:r + tile, c:c + tile],
                      targets[f, :, r:r + tile, c:c + tile])
                     for f, r, c in pick])
        x, y = torch.stack(x), torch.stack(y)
        with torch.autocast(dev.type, dtype=torch.bfloat16,
                            enabled=dev.type == "cuda"):
            out = net(x)[0]
        out = out.float()
        loss = (F.mse_loss(out[:, :2], y[:, :2]) / 2
                + F.binary_cross_entropy_with_logits(out[:, 2], y[:, 2]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
    net.eval()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def trained_state(config: Mapping, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """The network of a ``utricle_cellpose``-like configuration: drawn from
    its ``weights_seed`` and trained as its ``training`` group says
    (``traffic``, a file of ``benchmark/traffic/``, ``frames`` of it drawn
    from ``weights_seed``, ``steps``, ``batch``, ``lr``), at its
    ``diameter``, ``channels`` and ``tile``."""
    from benchmark.movies import make_movie
    from benchmark.reference.pipeline import projections

    t = config["training"]
    seed = int(config["weights_seed"])
    traffic = json.loads((Path(__file__).resolve().parent / "traffic"
                          / f"{t['traffic']}.json").read_text())
    movie = make_movie(traffic, int(t["frames"]), seed, device)
    prj = projections(movie, int(config["reference_channel"]), device)
    inputs, targets = training_set(prj, config["diameter"],
                                   config["channels"], config["min_size"])
    del movie, prj
    return train(cellpose_state(seed, device), inputs, targets, t["steps"],
                 t["batch"], t["lr"], seed, config["tile"])
