"""Plain PyTorch semantic core: the port's oracle layer and the CPU path."""

from lomanerf_tpu_torch.core.composite import (  # noqa: F401
    EPS,
    accumulate_color,
    accumulate_depth,
    render_weights,
)
from lomanerf_tpu_torch.core.encoding import encoded_dim, positional_encoding  # noqa: F401
from lomanerf_tpu_torch.core.losses import mean_mse, psnr, sum_mse  # noqa: F401
from lomanerf_tpu_torch.core.mlp import (  # noqa: F401
    init_mlp,
    mlp_apply,
    mlp_layer_sizes,
    params_from_numpy,
)
from lomanerf_tpu_torch.core.pipeline import nerf_render, nerf_render_rays  # noqa: F401
from lomanerf_tpu_torch.core.rays import (  # noqa: F401
    get_rays,
    normalized_intrinsics,
    sample_along_rays,
    uniform_depths,
)
