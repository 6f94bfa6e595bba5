"""ops of the PyTorch port (see the package docstring). The names below are
those the JAX package's ``ops`` exports; ``percentile`` here is the function,
so reach the module of that name with ``importlib.import_module``."""

from tissue_image_processing_tpu_torch.ops.filters import (  # noqa: F401
    gaussian_blur,
    band_pass_filter,
)
from tissue_image_processing_tpu_torch.ops.percentile import (  # noqa: F401
    percentile,
    masked_percentile,
)
from tissue_image_processing_tpu_torch.ops.brightness import (  # noqa: F401
    set_channel_brightness,
    set_brightness,
    binary_image,
    adjust_gamma,
)
from tissue_image_processing_tpu_torch.ops.morphology import (  # noqa: F401
    maximum_filter,
    minimum_filter,
    plus_maximum_filter,
    plus_minimum_filter,
    binary_dilation,
    binary_erosion,
    grey_dilation,
    grey_erosion,
)
from tissue_image_processing_tpu_torch.ops.components import (  # noqa: F401
    connected_components,
    relabel_sequential,
)
from tissue_image_processing_tpu_torch.ops.local_threshold import (  # noqa: F401
    threshold_local_max,
)
from tissue_image_processing_tpu_torch.ops.watershed import (  # noqa: F401
    regional_minima_labels,
    watershed,
    watershed_segmentation,
)
from tissue_image_processing_tpu_torch.ops.drift import (  # noqa: F401
    phase_cross_correlation,
    calculate_drift,
)
from tissue_image_processing_tpu_torch.ops.regionprops import regionprops  # noqa: F401
from tissue_image_processing_tpu_torch.ops.neighbors import (  # noqa: F401
    adjacency_matrix,
    neighbor_lists,
    contact_length_matrix,
    second_order_adjacency,
)
