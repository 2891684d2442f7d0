"""Data: camera poses."""

from lomanerf_tpu_torch.data.synthetic import look_at_pose, sphere_poses  # noqa: F401
