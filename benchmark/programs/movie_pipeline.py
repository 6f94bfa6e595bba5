"""The system under test for configurations with ``"program":
"movie_pipeline"``: the port's ``core/pipeline.py:movie_pipeline`` on whole
host movies, with the watershed or the U-Net segmenter, and the check of a
call's outputs against the plain reference (``reference/pipeline.py``).

Set-up builds everything a call needs: for the U-Net the benchmark's
weights (``weights.py``, from the configuration's fixed ``weights_seed``:
one network for every run, as a deployment has one, so that the movies and
not the network change with ``--seed``), the head bias set from the
reference's forward of the first movie's first frame, and the program's
``SegmentationPredictor`` built from them (it folds the BatchNorm). The
reference gets the same weights unfolded and computes in float32.

The compared call of a U-Net configuration also hands over the forward's
softmax, read through PyTorch's global module forward hook on the model
(an ``nn.Module`` named ``UNet``) while that call runs: the reference
post-processes it and compares its own float32 forward with it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from benchmark.compare import compare_movie
from benchmark.reference.pipeline import (
    projections, reference_movie, reference_unet)
from benchmark.reference.predictor import prepare_batch
from benchmark.weights import head_bias_for_share, unet_state

__all__ = ["Program", "control"]


class Program:
    """``program(movie, timings=None)`` runs one timed call; ``check``
    compares a kept call's outputs with the reference."""

    def __init__(self, config: Mapping, movies, device: torch.device,
                 quantized: bool = False):
        from tissue_image_processing_tpu_torch.core.pipeline import (
            movie_pipeline)

        self.config, self.device = config, device
        self._pipeline = movie_pipeline
        self.kwargs = dict(reference_channel=config["reference_channel"],
                           capacity=config["capacity"],
                           search_range=config["search_range"],
                           memory=config["memory"], device=device)
        self.state, self.head_delta, self.head_share = None, None, None
        if config["segmenter"] == "unet":
            self.kwargs["unet"] = self._unet(movies[0], quantized)
        else:
            self.kwargs.update(threshold=config["threshold"],
                               std=config["std"],
                               block_size=config["block_size"],
                               batch=config["batch"])

    def _unet(self, movie: np.ndarray, quantized: bool) -> dict:
        from tissue_image_processing_tpu_torch.models.predictor import (
            SegmentationPredictor)

        unet, dev = self.config["unet"], self.device
        self.state = unet_state(unet, unet["weights_seed"], dev)
        ref = int(self.config["reference_channel"])
        with _full_float32(), torch.no_grad():
            x, (px, py) = prepare_batch(projections(movie[:1], ref, dev))
            model = reference_unet(self.state, unet, dev)
            logits = model.logits(x)[:, :, px:, py:]
            self.head_delta = head_bias_for_share(logits, unet["head_share"])
            self.state["head.bias"][0] += self.head_delta
            model.head.bias[0] += self.head_delta
            probs = model(x)[0, px:, py:]
            self.head_share = float((probs[..., 0] > 0.1).float().mean())
        del model, probs, logits, x
        Y, X = movie.shape[-2:]
        pred = SegmentationPredictor(
            None, (unet["in_channels"], Y, X), depth=unet["depth"],
            base_filters=unet["base_filters"], dtype=torch.bfloat16,
            variables=self.state, quantize=quantized, device=dev)
        if quantized:
            pred.calibrate(projections(movie[:1], ref, dev)[0])
        return pred.pipeline_config(batch=unet["batch"])

    def __call__(self, movie: np.ndarray, timings=None) -> dict:
        return self._pipeline(movie, timings=timings, **self.kwargs)

    def kept_call(self, movie: np.ndarray, timings=None) -> dict:
        """The compared call: a timed call that also keeps the U-Net's
        softmax, cropped to the frame, under ``probs``."""
        if self.config["segmenter"] != "unet":
            return self(movie, timings)
        caught = []

        def hook(module, args, output):
            if type(module).__name__ == "UNet":
                caught.append(output)
        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        try:
            out = self(movie, timings)
        finally:
            handle.remove()
        return {**out, "probs": _cropped(caught, movie)}

    def overflowed(self, out: dict) -> bool:
        """Whether a frame's cells may not have fitted the tables: the last
        slot of some frame holds a cell."""
        return bool((np.asarray(out["ids"])[:, -1] != 0).any())

    def free(self) -> None:
        """Drop the program's model; the benchmark's weights stay."""
        self.kwargs.pop("unet", None)
        self._pipeline = None

    def check(self, movie: np.ndarray, out: dict) -> dict:
        """The comparison numbers of one call's outputs ``out`` on
        ``movie``. The U-Net's labels, tables and tracks are held bit for
        bit to the reference's post-process of the program's own softmax,
        and that softmax to the reference's float32 forward."""
        with _full_float32():
            ref = reference_movie(movie, self.config, self.device,
                                  state=self.state, probs=out.get("probs"))
        return compare_movie(out, ref)

    def context(self) -> list:
        if self.head_delta is None:
            return []
        return [f"U-Net head bias + {self.head_delta!r}: p0 > 0.1 on "
                f"{self.head_share!r} of the first frame (reference forward)"]


class _LowerReference(Program):
    """The plain reference in the program's place, its float32 stage
    outputs rounded through bfloat16 (``reference_movie(lower=True)``)."""

    def __call__(self, movie: np.ndarray, timings=None) -> dict:
        with _full_float32():
            out = reference_movie(movie, self.config, self.device,
                                  lower=True)
        return {**out, "neighbor_overflow": None}


class _Int8Program(Program):
    """The program with its int8 U-Net switched on; its compared call keeps
    the int8 forward's softmax (``Int8UNet`` is no ``nn.Module``, so it is
    read by wrapping the class's call for that call alone)."""

    def __init__(self, config, movies, device):
        super().__init__(config, movies, device, quantized=True)

    def kept_call(self, movie: np.ndarray, timings=None) -> dict:
        from tissue_image_processing_tpu_torch.models import quant

        caught, real = [], quant.Int8UNet.__call__

        def call(model, x):
            y = real(model, x)
            caught.append(y)
            return y
        quant.Int8UNet.__call__ = call
        try:
            out = self(movie, timings)
        finally:
            quant.Int8UNet.__call__ = real
        return {**out, "probs": _cropped(caught, movie)}


def control(config: Mapping, movies, device: torch.device) -> Program:
    """The control of a configuration, which the comparison must fail: the
    program's own int8 path where it has one (the U-Net), else the plain
    reference a step of precision below the configuration's float32."""
    if config["segmenter"] == "unet":
        return _Int8Program(config, movies, device)
    return _LowerReference(config, movies, device)


def _cropped(caught: list, movie: np.ndarray):
    """The (T, X, Y, 2) softmax of a call's forwards, their front padding
    cut (the model runs on x-major frames padded to powers of two); None if
    no forward was seen."""
    if not caught:
        return None
    probs = torch.cat(caught)
    Y, X = movie.shape[-2:]
    return probs[:, probs.shape[1] - X:, probs.shape[2] - Y:, :]


class _full_float32:
    """TF32 off for the reference's matrix products and convolutions."""

    def __enter__(self):
        self._prev = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._prev
        return False

