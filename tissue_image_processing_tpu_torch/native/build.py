"""On-demand g++ build + ctypes loading for the native host kernels.

Port of ``tissue_image_processing_tpu/native/build.py``; the library goes to
``build/native/`` (git-ignored) beside the CUDA kernels' ``build/torch_kernels/``,
not next to its source."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = Path(__file__).resolve().parent / "watershed.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (once) and load libtipws.so; returns None if no toolchain."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        # Content-hash staleness check: the .so is never committed, and mtime
        # comparison is unreliable after a fresh checkout (equal mtimes would
        # load a binary compiled with -march=native on another machine).
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        so_path = BUILD_DIR / f"libtipws-{digest}.so"
        try:
            if not so_path.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(str(so_path))
            lib.watershed.restype = ctypes.c_int32
            lib.watershed.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            lib.regional_minima.restype = ctypes.c_int32
            lib.regional_minima.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32)]
            _LIB = lib
        except (OSError, subprocess.SubprocessError):
            _LIB = None
        return _LIB
