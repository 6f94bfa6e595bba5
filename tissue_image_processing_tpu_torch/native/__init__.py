"""Native host kernels (C++ via ctypes): the exact sequential Meyer flood, the
oracle that the card's data-parallel flood is held to. Compiled on demand
with g++ into ``build/native/``; without a compiler ``load_library()``
returns None and ``meyer_watershed_native`` raises.

Port of ``tissue_image_processing_tpu/native/`` (the same C++ source)."""

from tissue_image_processing_tpu_torch.native.build import load_library  # noqa: F401
from tissue_image_processing_tpu_torch.native.watershed_host import (  # noqa: F401
    meyer_watershed_native, native_available,
)
