"""The inputs of every cell, made on the device from ``--seed``: camera
poses, the training views' ray table and targets, and the initial weights.

The scene is laid out as a Blender synthetic scene (NeRF's ``nerf_synthetic``):
training views on the upper hemisphere and test poses on an orbit, all
looking at the origin from the traffic's radius, with the traffic's field of
view.  The camera model is the port's (``core.rays.get_rays``, restated
here): a ``linspace(0, 1, side)`` pixel grid on both axes, a normalised
focal length and principal point 0.5, directions ``[(x - 0.5) / f, -(y -
0.5) / f, -1]`` rotated by the pose and left unnormalised.  Targets are a
seeded uniform image per view: the port has no early ray termination and
no empty-space skipping, so its work does not depend on them.
"""

from __future__ import annotations

import hashlib
import math

import torch


def derive(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of the run seeded ``seed``."""
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, name))


def focal(camera_angle_x: float) -> float:
    """Normalised focal length of a horizontal field of view."""
    return 0.5 / math.tan(0.5 * camera_angle_x)


def look_at(eyes: torch.Tensor) -> torch.Tensor:
    """``(V, 4, 4)`` camera-to-world poses at ``(V, 3)`` eyes looking at the
    origin, z up, the camera's -z forward."""
    fwd = eyes / torch.linalg.norm(eyes, dim=-1, keepdim=True)
    up = torch.zeros_like(eyes)
    up[:, 2] = 1.0
    right = torch.linalg.cross(up, fwd)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    true_up = torch.linalg.cross(fwd, right)
    c2w = torch.zeros((eyes.shape[0], 4, 4), dtype=eyes.dtype, device=eyes.device)
    c2w[:, :3, 0], c2w[:, :3, 1], c2w[:, :3, 2], c2w[:, :3, 3] = right, true_up, fwd, eyes
    c2w[:, 3, 3] = 1.0
    return c2w


def _eyes(azimuth: torch.Tensor, elevation: torch.Tensor, radius: float) -> torch.Tensor:
    return radius * torch.stack([torch.cos(elevation) * torch.cos(azimuth),
                                 torch.cos(elevation) * torch.sin(azimuth),
                                 torch.sin(elevation)], dim=-1)


def train_poses(gen: torch.Generator, views: int, radius: float) -> torch.Tensor:
    """Training views at uniform azimuths and elevations in [0.1, 1.3] rad."""
    u = torch.rand((2, views), generator=gen, device=gen.device)
    return look_at(_eyes(2 * math.pi * u[0], 0.1 + 1.2 * u[1], radius))


def orbit_poses(gen: torch.Generator, n: int, radius: float,
                elevation: float) -> torch.Tensor:
    """``n`` test poses evenly around an orbit at ``elevation``, from a
    seeded starting azimuth."""
    start = 2 * math.pi * torch.rand((), generator=gen, device=gen.device)
    azimuth = start + 2 * math.pi * torch.arange(n, device=gen.device) / n
    return look_at(_eyes(azimuth, torch.full_like(azimuth, elevation), radius))


def camera_directions(side: int, f: float, device) -> torch.Tensor:
    """``(side * side, 3)`` camera-space directions, row-major pixels."""
    coord = torch.linspace(0.0, 1.0, side, dtype=torch.float32, device=device)
    y, x = torch.meshgrid(coord, coord, indexing="ij")
    x, y = x.reshape(-1), y.reshape(-1)
    return torch.stack([(x - 0.5) / f, -(y - 0.5) / f, -torch.ones_like(x)], dim=-1)


def rays(c2w: torch.Tensor, cam: torch.Tensor):
    """World ``(origins, directions)`` of camera directions ``cam`` ``(P,
    3)`` under poses ``c2w`` ``(V, 4, 4)``: each ``(V, P, 3)``."""
    rot = c2w[:, :3, :3]
    d = cam[None, :, 0:1] * rot[:, None, :, 0] + cam[None, :, 1:2] * rot[:, None, :, 1] \
        + cam[None, :, 2:3] * rot[:, None, :, 2]
    return c2w[:, None, :3, 3].expand_as(d).contiguous(), d.contiguous()


def init_params(gen: torch.Generator, sizes, device) -> dict:
    """NeRF's init (the port's ``init="nerf"``, restated): He-normal hidden
    weights, zero biases, the head's weights times 0.1 and a +0.5 density
    bias; drawn in one call, float32, on ``device``."""
    total = sum(fi * fo for fi, fo in sizes)
    flat = torch.randn((total,), generator=gen, device=gen.device).to(device)
    ws, at = [], 0
    for fi, fo in sizes:
        ws.append(flat[at:at + fi * fo].view(fi, fo) * math.sqrt(2.0 / fi))
        at += fi * fo
    ws[-1] = ws[-1] * 0.1
    bs = [torch.zeros(fo, device=device) for _, fo in sizes]
    if sizes[-1][1] >= 4:
        bs[-1][3] = 0.5
    return {"w": ws, "b": bs}
