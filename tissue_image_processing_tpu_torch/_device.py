"""Device resolution and the build-and-load helper for the CUDA kernels.

Kernels are plain-C-interface shared libraries compiled from ``csrc/*.cu`` by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` (git-ignored) at first
use, and loaded with ``ctypes``. Library names carry a hash of their source,
so an edited source is rebuilt and a stale library is never loaded.

Every kernel wrapper adds the number of kernels it launched to
``LAUNCHES[name]``; the blur, launched at more than one shape on a path, also
to ``BLUR_LAUNCHES[(Z, Y, X, tz, ty, tx)]`` and ``BLUR_FORMS[form]``, and
the int8 conv, which has three forms, to ``CONV_LAUNCHES[form]``. Work that
is not a kernel launch is counted in ``COUNTS[name]`` by :func:`count`
(``upload_bytes``, ``auction_rounds``, ``auction_card`` (auctions solved in
one launch), ``auction_global`` (of those, in the device-memory form),
``radii_solves``, and Cellpose's
``cp_tiles``, ``follow_px``, ``qc_iters``, ``qc_px_iters``,
``qc_masks_global``, ``cp_masks_found``, ``cp_masks_kept``), once for each
call of the counting function. ``reset_launches()`` zeroes every count so a caller
can show that a run went through the kernels.

:func:`launch` runs a kernel under its tensor's device, on that device's
current stream, so a shard on any card of a mesh launches there. A caller
may launch from several host threads: :func:`count_launch` and
:func:`count` add under a lock, and libraries are built and loaded under
another.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Union

import torch

__all__ = ["LAUNCHES", "BLUR_LAUNCHES", "BLUR_FORMS", "CONV_LAUNCHES",
           "COUNTS", "KERNEL_SOURCES", "resolve_device", "build_kernels",
           "load_library", "reset_launches", "count_launch", "count",
           "check_cuda", "launch", "ptr", "stream_ptr", "require_cuda_tensor",
           "host_to_device", "host_constant", "host_floats", "to_host"]

_CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# where built libraries are kept; utils/runtime.enable_compilation_cache moves it
BUILD_DIR = DEFAULT_BUILD_DIR
KERNEL_SOURCES = ("blur3d", "flood", "projection", "cc_scan", "conv_s8",
                  "radii", "follow_flows", "flow_diffuse", "auction")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"blur3d": 0, "diffusion_bf": 0,
                            "diffusion_cc": 0, "settle_mask": 0, "settle": 0,
                            "proj_score": 0, "proj_project": 0, "cc_scan": 0,
                            "conv3x3_s8": 0, "radii_sweep": 0,
                            "follow_flows": 0, "flow_diffuse": 0,
                            "flow_diffuse_global": 0, "auction": 0}
# blur3d launches by (Z, Y, X, tz, ty, tx)
BLUR_LAUNCHES: collections.Counter = collections.Counter()
# blur3d launches by form ("z_only", "tile25", "walk", "generic")
BLUR_FORMS: collections.Counter = collections.Counter()
# conv3x3_s8 launches by form ("tensor_core", "first_conv", "generic")
CONV_LAUNCHES: collections.Counter = collections.Counter()
# work other than launches: bytes uploaded, auction rounds and forms,
# radii solves
COUNTS: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.RLock()
# host constants' copies on the card by (key, device, stream)
_constants: Dict[tuple, torch.Tensor] = {}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for but absent — the
    port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def host_to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy a small host tensor (taps, weights) to ``device``. On the card
    the copy goes through pinned memory on the current stream, so it does
    not wait for the work queued before it."""
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def host_constant(key, make, device: torch.device) -> torch.Tensor:
    """``make()`` (a host tensor) on ``device``, made and copied once per
    ``key``, device and stream (:func:`host_to_device`: no host
    synchronisation). Keyed by the stream too, so a stream never reads a
    copy still in flight on another."""
    device = torch.device(device)
    if device.type != "cuda":
        return make().to(device)
    slot = (key, device, torch.cuda.current_stream(device).cuda_stream)
    t = _constants.get(slot)
    if t is None:
        t = _constants[slot] = host_to_device(make(), device)
    return t


def to_host(*tensors: torch.Tensor) -> list:
    """numpy copies of ``tensors`` through ONE synchronisation a device:
    each card tensor is copied without blocking into a pinned buffer on its
    device's current stream, then each of those streams is synchronised
    once (a CPU tensor is read as it is)."""
    bufs, streams = [], {}
    for t in tensors:
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            bufs.append(buf)
            streams[t.device] = torch.cuda.current_stream(t.device)
        else:
            bufs.append(t)
    for stream in streams.values():
        stream.synchronize()
    return [b.numpy() for b in bufs]


def host_floats(values: Iterable[float]) -> ctypes.Array:
    """A host float32 array for a C entry that passes small constants (the
    taps) on as kernel parameters: nothing is copied to the card for them."""
    values = [float(v) for v in values]
    return (ctypes.c_float * len(values))(*values)


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        BLUR_LAUNCHES.clear()
        BLUR_FORMS.clear()
        CONV_LAUNCHES.clear()
        COUNTS.clear()


def count_launch(name: str, n: int = 1, *by) -> None:
    """Add ``n`` launches of kernel ``name`` to ``LAUNCHES`` and to each
    ``(counter, key)`` pair of ``by`` (``BLUR_FORMS``, ...), under one lock,
    so that launches from several host threads all count."""
    with _COUNT_LOCK:
        LAUNCHES[name] += n
        for counter, key in by:
            counter[key] += n


def count(name: str, n: int) -> None:
    """Add ``n`` to ``COUNTS[name]`` under the launch counters' lock. A
    counting site tallies locally and calls this once a call, never once an
    iteration."""
    with _COUNT_LOCK:
        COUNTS[name] += n


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); cannot build kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _paths(name: str):
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names: Iterable[str] = KERNEL_SOURCES) -> None:
    """Compile every library of ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Raises with the compiler's output if
    any build fails; the compiler log (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library."""
    with _BUILD_LOCK:
        _build(names)


def _build(names: Iterable[str]) -> None:
    procs = []
    for name in names:
        src, out = _paths(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps each
    exported C function to its ctypes argument types (all return int, the
    ``cudaError_t`` of the launch)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _libs.get(name)
        if lib is None:
            _build([name])
            lib = ctypes.CDLL(str(_paths(name)[1]))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check_cuda(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """The current stream of ``device`` (a card), as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(lib: ctypes.CDLL, entry, device: torch.device, what: str,
           *args) -> None:
    """``entry(*args, stream)``: a kernel launch through a C entry of
    ``lib`` on ``device``'s current stream, with ``device`` the calling
    thread's current device throughout (the entries size grids and read
    occupancy from it). Raises if the launch fails."""
    with torch.cuda.device(device):
        rc = entry(*args, stream_ptr(device))
    check_cuda(lib, rc, what)


def require_cuda_tensor(t: torch.Tensor, dtype: torch.dtype, ndim: int,
                        what: str) -> None:
    """Validate a tensor handed to a kernel wrapper before its pointer is
    passed to native code."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
