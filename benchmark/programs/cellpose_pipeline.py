"""The system under test for configurations with ``"program":
"cellpose_pipeline"``: the port's ``core/pipeline.py:movie_pipeline`` with
its Cellpose segmenter (``cellpose=``) on whole host movies, and the check
of a call's outputs against the plain reference
(``reference/cellpose.py``).

Set-up makes the network from the configuration's fixed ``weights_seed``
and ``training`` group (``cellpose_weights.py:trained_state``: seeded
weights trained briefly on frames of the benchmark's own tissue, which no
run draws; one network for every run, as a deployment has one) and builds
the port's ``CellposePredictor`` from it.

The compared call also hands over the network's full-resolution flows
(``flows``, (T, 3, Y, X): dY, dX, cellprob), read by PyTorch's global
module forward hook on the port's ``TileBlend`` module while that call
runs, and the labels ``get_masks`` gave each frame before the flow check
(``seeds``), read by wrapping ``ops/flows.py:get_masks`` for that call
alone. The reference post-processes those flows: labels, tables, drifts
and ids are held to it exactly, ``labels_mismatch`` being the larger of
the final labels' and ``get_masks``'s labels', and the flows to the
reference's float32 forward by ``prob_gap``: the largest |difference| of
dP / 5 and of sigmoid(cellprob).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from benchmark.cellpose_weights import trained_state
from benchmark.compare import compare_movie, labels_mismatch
from benchmark.reference.cellpose import reference_movie
from tissue_image_processing_tpu_torch.models.cellpose import (
    CellposePredictor)

__all__ = ["Program", "control", "flow_gap"]


def flow_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |difference| of dP / 5 and of sigmoid(cellprob) between two
    (T, 3, Y, X) flow stacks."""
    if got is None or got.shape != want.shape:
        return float("inf")
    want = want.to(got.device)
    dp = ((got[:, :2] - want[:, :2]) / 5.0).abs().max()
    cp = (torch.sigmoid(got[:, 2]) - torch.sigmoid(want[:, 2])).abs().max()
    return float(torch.maximum(dp, cp))


class Program:
    """``program(movie, timings=None)`` runs one timed call; ``check``
    compares a kept call's outputs with the reference."""

    def __init__(self, config: Mapping, movies, device: torch.device):
        from tissue_image_processing_tpu_torch.core.pipeline import (
            movie_pipeline)

        self.config, self.device = config, device
        self._pipeline = movie_pipeline
        self.state = trained_state(config, device)
        ref = int(config["reference_channel"])
        self.kwargs = dict(reference_channel=ref,
                           capacity=config["capacity"],
                           search_range=config["search_range"],
                           memory=config["memory"], device=device,
                           cellpose=self._model().pipeline_config())

    def _model(self) -> CellposePredictor:
        c = self.config
        return CellposePredictor(
            self.state, diameter=c["diameter"], channels=c["channels"],
            tile=c["tile"], tile_overlap=c["tile_overlap"], batch=c["batch"],
            niter=c["niter"],
            cellprob_threshold=c["cellprob_threshold"],
            flow_threshold=c["flow_threshold"], min_size=c["min_size"],
            device=self.device)

    def __call__(self, movie: np.ndarray, timings=None) -> dict:
        return self._pipeline(movie, timings=timings, **self.kwargs)

    def kept_call(self, movie: np.ndarray, timings=None) -> dict:
        """The compared call: a timed call that also keeps the flows
        (``flows``) and ``get_masks``'s labels (``seeds``)."""
        import tissue_image_processing_tpu_torch.ops.flows as port

        caught, seeds, real = [], [], port.get_masks

        def hook(module, args, output):
            if type(module).__name__ == "TileBlend":
                caught.append(output)

        def get_masks(p, m):
            labels, n = real(p, m)
            seeds.append(labels)
            return labels, n
        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        port.get_masks = get_masks
        try:
            out = self(movie, timings)
        finally:
            handle.remove()
            port.get_masks = real
        return {**out, "flows": torch.cat(caught) if caught else None,
                "seeds": torch.stack(seeds) if seeds else None}

    def overflowed(self, out: dict) -> bool:
        """Whether a frame's cells may not have fitted the tables: the last
        slot of some frame holds a cell."""
        return bool((np.asarray(out["ids"])[:, -1] != 0).any())

    def free(self) -> None:
        """Drop the program's model; the benchmark's weights stay."""
        self.kwargs.pop("cellpose", None)
        self._pipeline = None

    def check(self, movie: np.ndarray, out: dict) -> dict:
        """The comparison numbers of one call's outputs ``out`` on
        ``movie``."""
        with _full_float32():
            ref = reference_movie(movie, self.config, self.device,
                                  self.state, flows=out.get("flows"))
        numbers = compare_movie(out, ref)
        seeds = out.get("seeds")
        numbers["labels_mismatch"] = max(
            numbers["labels_mismatch"],
            1.0 if seeds is None else labels_mismatch(seeds, ref["seeds"]))
        numbers["prob_gap"] = flow_gap(out.get("flows"), ref["flows"])
        return numbers

    def context(self) -> list:
        from tissue_image_processing_tpu_torch import _device

        c = _device.COUNTS
        total = sum(float(v.double().abs().sum()) for v in self.state.values()
                    if v.is_floating_point())
        return [f"Cellpose weights: sum of |w| {total!r} (equal in every run "
                "where the training is reproducible)",
                "Cellpose counts over the window: " + ", ".join(
                    f"{k} {c.get(k, 0)}" for k in (
                        "cp_tiles", "follow_px", "cp_masks_found",
                        "cp_masks_kept", "qc_iters"))]


class _LowerReference(Program):
    """The plain reference in the program's place, every conv's input
    rounded through float8 e4m3 (``reference_flows(lower=True)``)."""

    def __call__(self, movie: np.ndarray, timings=None) -> dict:
        with _full_float32():
            out = reference_movie(movie, self.config, self.device,
                                  self.state, lower=True)
        return {**out, "neighbor_overflow": None}

    def kept_call(self, movie: np.ndarray, timings=None) -> dict:
        return self(movie, timings)


def control(config: Mapping, movies, device: torch.device) -> Program:
    """The control, which the comparison must fail by ``prob_gap``: the
    plain reference with float8 conv inputs."""
    return _LowerReference(config, movies, device)


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
