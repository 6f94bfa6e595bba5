"""The int8 scheme's accuracy pair on the smoke run's random U-Net, from the
JAX package and from the port, on the CPU.

    python3 tests/int8_witness.py [--side 256] [--frames 2] [--threads 4]

``chip_smoke.py`` prints ``bench.py``'s accuracy pair (HC-mask agreement
and label Dice, int8 against bfloat16) for the port on the card. This
script computes the same pair with the JAX package's own int8 and bfloat16
forwards on the same network, so that the pair's value can be told apart
from a fault of the port:

- weights: ``utils/synthetic.py:random_unet`` (seed 0, the reference
  architecture's depth 3 and 128 filters), BatchNorm folded;
- frames: the projected frames of ``make_movie(T, Z=30, 1024, 1024,
  seed=0)`` (the smoke's headline movie), projected and prepared by the port
  on the CPU as the pipeline prepares them, then cut to a central ``side`` x
  ``side`` crop (a full 1024^2 forward at full width is a job for the card);
- head bias: ``head_bias_for_share`` puts half the crops' pixels past the
  0.1 HC threshold, by the port's bfloat16 forward, as ``chip_smoke.py``
  sets it on the whole first frame;
- int8 scales: each package's ``quantize_unet`` on the first crop (the
  smoke calibrates on the first frame);
- JAX: ``UNet(norm="shift", dtype=bfloat16).apply`` and ``unet_int8_apply``,
  jitted, as ``bench.py`` runs them; the port: the bfloat16 ``UNet`` and
  ``unet_int8_apply``; both post-processed by the port's
  ``unet_postprocess_batch``, which ``tests/test_torch_pipeline.py`` holds
  to the JAX package's.

It prints each package's pair, how far the two packages' forwards are
apart, and each forward's agreement at the threshold with the float32
forward of the same weights. ``test_torch_quant.py`` runs
:func:`int8_pair` at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flax_from_unet_state(state, depth: int) -> dict:
    """Flax variables of the JAX package's ``UNet(norm="shift")`` from the
    ``state_dict`` of the port's folded ``UNet`` (numpy float32 leaves): the
    inverse of ``utils/state.py:unet_state_from_flax`` for that form."""
    def a(t):
        return np.ascontiguousarray(t.detach().float().numpy())

    def hwio(t):
        return np.ascontiguousarray(np.transpose(a(t), (2, 3, 1, 0)))

    params = {}
    for k in range(2 * depth + 1):
        block = {}
        for i in range(2):
            pre = f"blocks.{k}."
            block[f"Conv_{i}"] = {"kernel": hwio(state[f"{pre}conv{i}.weight"]),
                                  "bias": a(state[f"{pre}conv{i}.bias"])}
            block[f"Shift_{i}"] = a(state[f"{pre}shift{i}"])
        params[f"DoubleConv_{k}"] = block
    for j in range(depth):
        w = np.transpose(a(state[f"ups.{j}.weight"]), (2, 3, 0, 1))
        params[f"ConvTranspose_{j}"] = {
            "kernel": np.ascontiguousarray(w[::-1, ::-1]),
            "bias": a(state[f"ups.{j}.bias"])}
    params["Conv_0"] = {"kernel": hwio(state["head.weight"]),
                        "bias": a(state["head.bias"])}
    return {"params": params}


def best_dice(got, want) -> float:
    sys.path.insert(0, ROOT)
    from chip_smoke import best_dice as dice
    return dice(got, want)


def int8_pair(model, x, depth: int, base_filters: int, share: float = 0.5):
    """The pair for the unfolded bfloat16 port ``model`` (folded here, its head bias
    moved so that ``share`` of ``x``'s pixels pass the threshold) on the
    float32 (B, X, Y, 2) model input ``x``, from both packages. Returns a
    dict of readings and the four softmax maps (numpy)."""
    import jax
    import jax.numpy as jnp
    import torch

    from tissue_image_processing_tpu.models import quant as jq
    from tissue_image_processing_tpu.models.unet import UNet as JUNet
    from tissue_image_processing_tpu_torch.models import quant as tq
    from tissue_image_processing_tpu_torch.models.predictor import (
        unet_postprocess_batch)
    from tissue_image_processing_tpu_torch.models.unet import fold_batchnorm
    from tissue_image_processing_tpu_torch.utils.synthetic import (
        head_bias_for_share)

    folded = fold_batchnorm(model.eval()).requires_grad_(False)
    assert folded.norm == "shift" and folded.dtype == torch.bfloat16
    with torch.no_grad():
        delta = head_bias_for_share(folded(x), share)
        folded.head.bias[0] += delta
    xb = x.to(torch.bfloat16).to(torch.float32)   # the smoke's model input
    state = folded.state_dict()
    probs = {}
    with torch.no_grad():
        probs["port_bf16"] = folded(xb)
        q = tq.quantize_unet(folded, x[:1], depth=depth)
        probs["port_int8"] = tq.unet_int8_apply(q, xb, depth=depth)
        f32 = tq.unet_f32_apply(folded, xb, depth=depth)

    variables = flax_from_unet_state(state, depth)
    jmodel = JUNet(depth=depth, base_filters=base_filters, dtype=jnp.bfloat16,
                   norm="shift")
    xj = jnp.asarray(xb.numpy())
    qj = jq.quantize_unet(variables, jnp.asarray(x[:1].numpy()), depth=depth)
    bf16 = jax.jit(lambda v, t: jmodel.apply(v, t.astype(jnp.bfloat16),
                                             train=False))
    probs["jax_bf16"] = np.asarray(bf16(variables, xj), np.float32)
    probs["jax_int8"] = np.asarray(jq.unet_int8_apply(qj, xj, depth=depth),
                                   np.float32)
    probs = {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in probs.items()}

    post = {k: [t.numpy() for t in unet_postprocess_batch(p)]
            for k, p in probs.items()}
    out = {"head_bias_delta": delta,
           "hc_share_bf16": float(post["port_bf16"][1].mean())}
    for pkg in ("jax", "port"):
        (lab_f, hc_f), (lab_q, hc_q) = post[f"{pkg}_bf16"], post[f"{pkg}_int8"]
        out[f"{pkg}_hc_agreement"] = float((hc_f == hc_q).mean())
        out[f"{pkg}_dice"] = float(np.mean(
            [best_dice(lab_q[i], lab_f[i]) for i in range(len(lab_f))]))
        out[f"{pkg}_mean_abs_dp"] = float(
            (probs[f"{pkg}_int8"] - probs[f"{pkg}_bf16"]).abs().mean())
        out[f"{pkg}_cells"] = [int(l.max()) for l in lab_f]
        out[f"{pkg}_cells_int8"] = [int(l.max()) for l in lab_q]
    for kind in ("bf16", "int8"):
        p, j = probs[f"port_{kind}"], probs[f"jax_{kind}"]
        out[f"port_vs_jax_{kind}_mean_abs_dp"] = float((p - j).abs().mean())
        out[f"port_vs_jax_{kind}_hc_agreement"] = float(
            (post[f"port_{kind}"][1] == post[f"jax_{kind}"][1]).mean())
        out[f"port_{kind}_vs_f32_threshold_agreement"] = float(
            ((p[..., 0] > 0.1) == (f32[..., 0] > 0.1)).float().mean())
    return out, probs


def crops(side: int, frames: int):
    """The central ``side`` x ``side`` crops of the first ``frames``
    projected, prepared frames of the smoke's headline movie."""
    import torch

    from tissue_image_processing_tpu_torch.models.predictor import prepare_batch
    from tissue_image_processing_tpu_torch.projection.surface import (
        project_timepoint_auto)
    from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

    movie = make_movie(T=frames, Z=30, H=1024, W=1024, seed=0).astype(np.uint16)
    prj = torch.stack([project_timepoint_auto(torch.from_numpy(
        np.ascontiguousarray(m)))[0] for m in movie])
    x, (px, py) = prepare_batch(prj)
    assert px == py == 0
    c = (x.shape[1] - side) // 2
    return x[:, c:c + side, c:c + side].contiguous()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, ROOT)
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    from tissue_image_processing_tpu_torch.utils.synthetic import random_unet

    t0 = time.time()
    x = crops(args.side, args.frames)
    model = random_unet(3, 128, seed=0, dtype=torch.bfloat16)
    out, _ = int8_pair(model, x, 3, 128)
    out.update(side=args.side, frames=args.frames,
               seconds=round(time.time() - t0, 1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
