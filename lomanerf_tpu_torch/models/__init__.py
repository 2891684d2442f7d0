"""Model families: NeRF radiance fields."""

from lomanerf_tpu_torch.models.nerf import NeRFConfig, NeRFModel, count_params  # noqa: F401
