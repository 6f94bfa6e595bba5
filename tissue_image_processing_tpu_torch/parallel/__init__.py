"""Scale-out over a device mesh, the port of
``tissue_image_processing_tpu/parallel``: a single-controller mesh of
``torch.device``s (``mesh``), the frame-sharded pipelines (``pipeline``) and
the space-sharded projection (``spatial``)."""

from tissue_image_processing_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, shard_batch, shard_params, unet_train_step_sharded,
)
