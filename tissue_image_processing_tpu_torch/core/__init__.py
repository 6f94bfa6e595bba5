"""core of the PyTorch port (see the package docstring)."""

from tissue_image_processing_tpu_torch.core.cell_table import (  # noqa: F401
    CellTable, frame_cellinfo, frame_cellinfo_checked,
    CELL_INFO_COLUMNS, INVALID_TYPE_INDEX,
    is_positive_for_type, change_type,
)
from tissue_image_processing_tpu_torch.core.tracking import (  # noqa: F401
    track_movie, TrackingState, link_frames,
)
