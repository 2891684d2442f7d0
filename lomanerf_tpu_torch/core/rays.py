"""Ray generation and depth sampling (port of ``lomanerf_tpu.core.rays``).

``get_rays`` keeps the reference's camera model: a ``linspace(0, 1, width)``
pixel grid meshgrid'ed 'xy' over BOTH axes (square images), directions
``[(i - cx)/fx, -(j - cy)/fy, -1] @ R^T`` left unnormalised, origins the pose
translation per pixel.  ``sample_along_rays`` gives uniform
``linspace(near, far, S)`` depths with an optional stratified jitter and
``dists`` = forward differences with a 1e8 far sentinel.
``stratified_ray_offsets`` shifts each ray's whole depth comb instead, so
depths stay ``(S,)``; ``generate_random_rays`` is the unit-direction
random-pixel sampler.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def normalized_intrinsics(focal: float, device: torch.device | str = "cpu") -> torch.Tensor:
    """K with normalised focal and principal point 0.5."""
    return torch.tensor(
        [[focal, 0.0, 0.5], [0.0, focal, 0.5], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def get_rays(
    height: int,
    width: int,
    K: torch.Tensor,
    c2w: torch.Tensor,
    normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world-space ``(origins, directions)``, each
    ``(width*width, 3)``, on ``K``'s device (``height`` is unused, as in the
    reference: the grid spans ``width`` on both axes)."""
    del height
    coord = torch.linspace(0.0, 1.0, width, dtype=torch.float32, device=K.device)
    i, j = torch.meshgrid(coord, coord, indexing="xy")
    i = i.reshape(-1)
    j = j.reshape(-1)
    directions = torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)],
        dim=-1,
    )
    c2w = c2w.to(device=K.device, dtype=torch.float32)
    directions = directions @ c2w[:3, :3].T
    if normalize:
        directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    origins = c2w[:3, 3].expand(directions.shape)
    return origins, directions


def uniform_depths(
    near: float, far: float, num_samples: int, device: torch.device | str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(t_vals, dists)``, each ``(S,)``: the depths every ray shares and
    their forward differences with the 1e8 far sentinel last."""
    t = torch.linspace(near, far, num_samples, dtype=torch.float32, device=device)
    return t, _dists(t)


def _dists(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t[..., 1:] - t[..., :-1], torch.full_like(t[..., :1], 1e8)], dim=-1)


def sample_along_rays(
    origins: torch.Tensor,
    directions: torch.Tensor,
    near: float,
    far: float,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(points, t_vals, dists)`` with ``points`` ``(N, S, 3)``.

    Unjittered (``generator=None``) every ray shares its depths, so
    ``t_vals`` and ``dists`` are ``(S,)`` — the per-ray-uniform contract the
    fused render kernel takes.  Stratified (``generator`` given; a uniform
    draw per bin, on the generator's device) they are per-ray ``(N, S)``.
    """
    t, dists = uniform_depths(near, far, num_samples, origins.device)
    if generator is not None:
        bin_width = (far - near) / num_samples
        jitter = torch.rand((origins.shape[0], num_samples), generator=generator,
                            dtype=torch.float32, device=generator.device)
        t = t[None, :] + jitter.to(origins.device) * bin_width
        dists = _dists(t)
    points = origins[:, None, :] + directions[:, None, :] * t[..., None]
    return points, t, dists


def stratified_ray_offsets(
    generator: torch.Generator, num_rays: int, near: float, far: float,
    num_samples: int,
) -> torch.Tensor:
    """Per-ray stratified depth offsets ``dt`` ``(N,)`` in
    ``[0, (far - near) / S)``, drawn on the generator's device.

    Shifted-lattice stratification: each ray's whole comb
    ``linspace(near, far, S)`` shifts by one uniform draw within a bin, so
    ``o + d * dt[:, None]`` with the unjittered ``(S,)`` depths gives the
    points of depths ``t + dt`` and the depths stay per-ray-uniform (the
    fused kernels' contract)."""
    bin_width = (far - near) / num_samples
    u = torch.rand((num_rays,), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u * bin_width


def generate_random_rays(
    generator: torch.Generator,
    image_size: Tuple[int, int],
    num_rays: int,
    cameras: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random-pixel rays with UNIT directions: per camera of the ``(C, 4, 4)``
    camera-to-world ``cameras``, ``num_rays`` pixels drawn from
    ``generator`` in ``image_size`` ``(W, H)``, centre-offset camera-space
    directions normalised and rotated into world space; origins are the
    camera translations.  Returns ``(origins, directions)``, each
    ``(C*num_rays, 3)``, on the cameras' device."""
    cameras = torch.as_tensor(cameras, dtype=torch.float32)
    c = cameras.shape[0]
    px = torch.randint(0, image_size[0], (c, num_rays), generator=generator,
                       device=generator.device).to(cameras.device)
    py = torch.randint(0, image_size[1], (c, num_rays), generator=generator,
                       device=generator.device).to(cameras.device)
    dirs = torch.stack(
        [(px - image_size[0] / 2.0) / image_size[0],
         (py - image_size[1] / 2.0) / image_size[1],
         -torch.ones_like(px, dtype=torch.float32)], dim=-1,
    ).to(torch.float32)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    dirs = torch.einsum("cij,cnj->cni", cameras[:, :3, :3], dirs)
    origins = cameras[:, None, :3, 3].expand(dirs.shape)
    return origins.reshape(-1, 3), dirs.reshape(-1, 3)
