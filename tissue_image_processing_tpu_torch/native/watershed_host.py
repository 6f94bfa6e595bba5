"""ctypes wrapper over the native Meyer watershed (port of
``tissue_image_processing_tpu/native/watershed_host.py``)."""

from __future__ import annotations

import ctypes

import numpy as np

from tissue_image_processing_tpu_torch.native.build import load_library

__all__ = ["native_available", "meyer_watershed_native"]


def native_available() -> bool:
    return load_library() is not None


def meyer_watershed_native(image: np.ndarray, watershed_line: bool = True
                           ) -> np.ndarray:
    """Exact sequential Meyer flood from regional minima (host, C++).

    Semantics match skimage.segmentation.watershed(image, watershed_line=True)
    with markers=None — the parity oracle for the card's flood (csrc/flood.cu).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native watershed unavailable (g++ missing?)")
    img = np.ascontiguousarray(image, dtype=np.float32)
    H, W = img.shape
    out = np.zeros((H, W), np.int32)
    lib.watershed(img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                  H, W, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                  1 if watershed_line else 0)
    return out
