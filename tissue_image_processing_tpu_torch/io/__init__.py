"""Host-side image I/O (reference ``readwrite.py``, ``basic_image_manipulations.py:28-189``).

Decode/encode stays on host; everything between decode and export runs on device.
TIFF support is implemented on PIL (tifffile/aicsimageio are not available in this
environment); CZI readers are gated behind optional imports.

Copied from ``tissue_image_processing_tpu/io/__init__.py``: host code, the
same functions and file formats; its imports name the port's modules.
"""

from tissue_image_processing_tpu_torch.io.tiff import (  # noqa: F401
    read_tiff,
    save_tiff,
    read_whole_image,
    get_image_dimensions,
)
from tissue_image_processing_tpu_torch.io.movie import (  # noqa: F401
    MovieStore,
    read_image_in_chunks,
    concatenate_time_points,
    virtually_concatenate_time_points,
)
