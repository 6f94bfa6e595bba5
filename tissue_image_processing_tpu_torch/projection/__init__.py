"""Surface projection of the PyTorch port (see the package docstring)."""

from tissue_image_processing_tpu_torch.projection.fused import (  # noqa: F401
    fused_projection, fused_projection_supported)
from tissue_image_processing_tpu_torch.projection.surface import (  # noqa: F401
    build_continuous_manifold, movie_projection_batch, project_timepoint_auto,
    time_point_surface_projection)
