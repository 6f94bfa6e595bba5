"""utils of the PyTorch port (see the package docstring)."""

from tissue_image_processing_tpu_torch.utils import maintenance  # noqa: F401
