"""Data: camera poses, the synthetic scene and its views, and the
Blender-format dataset loader."""

from lomanerf_tpu_torch.data.blender import NeRFDataset  # noqa: F401
from lomanerf_tpu_torch.data.synthetic import (  # noqa: F401
    GaussianBlobScene,
    look_at_pose,
    sphere_poses,
    synthetic_views,
    write_blender_dataset,
)
