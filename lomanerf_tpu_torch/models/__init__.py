"""Model families: NeRF radiance fields and 2D image fields."""

from lomanerf_tpu_torch.models.image_mlp import (  # noqa: F401
    ImageFieldConfig,
    ImageFieldModel,
    image_grid_coords,
)
from lomanerf_tpu_torch.models.nerf import NeRFConfig, NeRFModel, count_params  # noqa: F401
