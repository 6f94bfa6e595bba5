"""Device resolution and the build-and-load helper for the CUDA kernels.

Kernels are plain-C-interface shared libraries compiled from ``csrc/*.cu`` by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` (git-ignored) at first
use, and loaded with ``ctypes``. Library names carry a hash of their source,
so an edited source is rebuilt and a stale library is never loaded.

Every kernel wrapper adds the number of kernels it launched to
``LAUNCHES[name]``; ``reset_launches()`` zeroes the counts so a caller can
show that a run went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Union

import torch

__all__ = ["LAUNCHES", "KERNEL_SOURCES", "resolve_device", "build_kernels",
           "load_library", "reset_launches", "check_cuda", "ptr",
           "stream_ptr", "require_cuda_tensor", "host_to_device"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
KERNEL_SOURCES = ("blur3d", "flood", "projection", "cc_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"blur3d": 0, "diffusion_bf": 0,
                            "diffusion_cc": 0, "settle_mask": 0, "settle": 0,
                            "proj_score": 0, "proj_project": 0, "cc_scan": 0}
_libs: Dict[str, ctypes.CDLL] = {}


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


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    if lib is None:
        build_kernels([name])
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


def stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


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
