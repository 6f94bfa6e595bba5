"""Runtime helpers: profiling traces and structured stage metrics.

Port of ``tissue_image_processing_tpu/utils/runtime.py``. ``trace`` is a
``torch.profiler`` context (CPU activity, and CUDA where a card is present)
that writes a Chrome trace into its directory. ``StageMetrics`` is the
JAX package's. ``enable_compilation_cache`` points the kernel build cache
(not XLA's, which the port does not have) at a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

__all__ = ["enable_compilation_cache", "trace", "StageMetrics"]

_DEFAULT_TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "torch_trace")


def enable_compilation_cache(path: str = None) -> str:
    """Keep the built CUDA kernels in ``path`` (default
    ``build/torch_kernels/`` beside the package) and return it.

    The port compiles no XLA programs: what a process pays once and a later
    process can reuse is the ``nvcc`` build of ``csrc/*.cu``. Each library
    is named by a hash of its source (``_device.build_kernels``), so the
    directory is a persistent cache: a later process loads what an earlier
    one built, and an edited source is rebuilt. The directory is made here;
    a library already loaded in this process stays loaded. Raises when the
    directory cannot be made."""
    from tissue_image_processing_tpu_torch import _device

    cache = Path(path) if path else _device.DEFAULT_BUILD_DIR
    cache.mkdir(parents=True, exist_ok=True)
    _device.BUILD_DIR = cache
    return str(cache)


@contextlib.contextmanager
def trace(log_dir: str = _DEFAULT_TRACE_DIR):
    """``torch.profiler`` trace of the block; on exit a Chrome trace
    (``*.pt.trace.json``, for Perfetto / ``chrome://tracing`` / TensorBoard)
    is written into ``log_dir``. Yields the profiler, whose
    ``key_averages()`` sums the block's time by operator and kernel."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StageMetrics:
    """Structured per-stage metrics for pipeline drivers (SURVEY §5.5: the
    reference only has prints; here every driver stage emits one JSON line —
    ``{"event": ..., "stage": ..., "seconds": ..., **fields}`` — to a stream
    and keeps an in-memory record, so batch runs are machine-parseable).
    """

    def __init__(self, stream=None, run: str = ""):
        import sys

        self.stream = stream if stream is not None else sys.stderr
        self.run = run
        self.records = []

    def emit(self, event: str, **fields):
        import json

        rec = {"event": event, **({"run": self.run} if self.run else {}),
               **fields}
        self.records.append(rec)
        if self.stream:
            print(json.dumps(rec), file=self.stream, flush=True)

    @contextlib.contextmanager
    def stage(self, name: str, **fields):
        t0 = time.time()
        try:
            yield
        except Exception as e:
            self.emit("stage_error", stage=name,
                      seconds=round(time.time() - t0, 4),
                      error=f"{type(e).__name__}: {e}", **fields)
            raise
        self.emit("stage", stage=name, seconds=round(time.time() - t0, 4),
                  **fields)

    def summary(self) -> dict:
        out = {}
        for r in self.records:
            if r.get("event") == "stage":
                out[r["stage"]] = out.get(r["stage"], 0.0) + r["seconds"]
        return out
