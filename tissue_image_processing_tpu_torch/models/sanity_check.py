"""Standalone visual sanity check of a trained U-Net on one random crop.

Rebuild of the reference's ``Segmentation/IMAGE_LABELS_PREDICTION.py`` as a CLI:
loads a checkpoint (Keras h5), predicts one random crop of an annotated
frame and writes a side-by-side panel (image / prediction / labels) to disk instead
of opening matplotlib windows.

Usage:
  python -m tissue_image_processing_tpu_torch.models.sanity_check image.tif labels.tif \
      --weights w.h5 --out sanity.png

Port of ``tissue_image_processing_tpu/models/sanity_check.py``: the port's
``SegmentationPredictor`` in float32 (Keras h5 weights, or the predictor's
seeded weights without ``--weights``), the input read through the port's
``io/tiff.read_whole_image``. ``main(argv, device=None)`` runs on the card
unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image")
    p.add_argument("labels", nargs="?", default=None)
    p.add_argument("--weights", default=None)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="sanity_check.png")
    args = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    import torch

    from tissue_image_processing_tpu_torch.io.tiff import read_whole_image
    from tissue_image_processing_tpu_torch.models.predictor import (
        SegmentationPredictor)

    img, axes, _ = read_whole_image(args.image)
    img = np.asarray(img, np.float32)
    while img.ndim > 3:
        img = img[0]
    if img.ndim == 2:
        img = np.stack([img, img])
    rng = np.random.default_rng(args.seed)
    C, Y, X = img.shape
    r0 = rng.integers(0, max(Y - args.crop, 1))
    c0 = rng.integers(0, max(X - args.crop, 1))
    crop = img[:2, r0:r0 + args.crop, c0:c0 + args.crop]

    pred = SegmentationPredictor(args.weights, crop.shape, dtype=torch.float32,
                                 device=device)
    labels, hc = pred.predict(crop)
    labels = labels.cpu().numpy().T  # back to (Y, X)
    hc = hc.cpu().numpy().T

    ncols = 4 if args.labels else 3
    fig, ax = plt.subplots(1, ncols, figsize=(4 * ncols, 4))
    ax[0].imshow(crop[0], cmap="gray")
    ax[0].set_title("input (ch0)")
    ax[1].imshow(labels % 17, cmap="tab20")
    ax[1].set_title(f"predicted labels ({labels.max()} cells)")
    ax[2].imshow(hc, cmap="magma")
    ax[2].set_title("HC mask")
    if args.labels:
        lab, _, _ = read_whole_image(args.labels)
        lab = np.asarray(lab)
        while lab.ndim > 2:
            lab = lab[min(1, lab.shape[0] - 1)]
        ax[3].imshow(lab[r0:r0 + args.crop, c0:c0 + args.crop])
        ax[3].set_title("annotation")
    for a in ax:
        a.axis("off")
    fig.tight_layout()
    fig.savefig(args.out, dpi=130)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
