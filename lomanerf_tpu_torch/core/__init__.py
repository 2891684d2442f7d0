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
from lomanerf_tpu_torch.core.pipeline import (  # noqa: F401
    image_fit_loss,
    image_fit_pred,
    nerf_loss,
    nerf_loss_rays,
    nerf_render,
    nerf_render_rays,
    seeded_value_and_grad,
)
from lomanerf_tpu_torch.core.rays import (  # noqa: F401
    generate_random_rays,
    get_rays,
    normalized_intrinsics,
    sample_along_rays,
    stratified_ray_offsets,
    uniform_depths,
)
