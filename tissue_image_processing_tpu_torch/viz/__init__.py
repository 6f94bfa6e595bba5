"""viz of the PyTorch port (see the package docstring)."""

from tissue_image_processing_tpu_torch.viz.overlays import (  # noqa: F401
    draw_cell_types, draw_neighbors_connections, draw_cell_tracking,
    draw_all_cell_tracking, draw_events, draw_marking_points,
)
