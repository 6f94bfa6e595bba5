from tissue_image_processing_tpu_torch.stats.collect import DataCollector  # noqa: F401
from tissue_image_processing_tpu_torch.stats.compare import (  # noqa: F401
    TwoSampleCompare, TwoByTwoCompare, HierarchicalTwoSamplesCompare,
)
from tissue_image_processing_tpu_torch.stats.plots import compare_and_plot_samples  # noqa: F401
