"""Sharded full-image rendering over the data axis (port of
``lomanerf_tpu.parallel.render_step``).

A frame's rays are split into equal blocks, one per rank of the data
group, each block into chunks; every rank renders its chunks through
``models.nerf.render_chunk`` (the render kernel #1 on CUDA), and the frame
is reassembled by one ``all_gather`` over the data group, so every rank
holds the whole frame (rank 0 writes it).  Each rank computes the ray grid
from ``(K, c2w)`` itself: no input moves between ranks.  A ray's colour does
not depend on its chunk, so the frame equals ``NeRFModel.render_image``'s
bit for bit.

The chunk is capped at ``ceil(n / dp)`` (ROADMAP F5): the JAX module pads
the rays to ``chunk * n_devices``, which at a 64x64 eval (4096 rays, chunk
4096) gives every real ray to device 0.
"""

from __future__ import annotations

import torch

from lomanerf_tpu_torch.parallel.mesh import Mesh, all_gather_cat


def shard_ray_chunks(mesh: Mesh, o, d, chunk: int):
    """This rank's ``(k, chunk, 3)`` origin and direction chunks of the
    ``(n, 3)`` rays (on ``mesh.device``), and ``n``.  The chunk is capped
    at ``ceil(n / dp)``; the rays are padded with zeros to ``k * chunk *
    dp`` and rank ``i`` of the data group takes block ``i``."""
    o = torch.as_tensor(o, dtype=torch.float32, device=mesh.device)
    d = torch.as_tensor(d, dtype=torch.float32, device=mesh.device)
    n = o.shape[0]
    chunk = max(1, min(chunk, -(-n // mesh.dp)))
    per = -(-n // (chunk * mesh.dp)) * chunk  # rays per rank: whole chunks
    lo = min(mesh.data_index * per, n)
    hi = min(lo + per, n)

    def block(x):
        x = torch.cat([x[lo:hi], x.new_zeros((per - (hi - lo), 3))])
        return x.reshape(-1, chunk, 3)

    return block(o), block(d), n


def sharded_render_fn(config, mesh: Mesh):
    """The sharded render: ``(params, oc, dc) -> (dp * k * chunk, 3)``
    colours of every rank's chunks in ray order, the same on every rank.
    ``oc``/``dc`` are this rank's chunks from :func:`shard_ray_chunks`;
    params are replicated."""
    from lomanerf_tpu_torch.models.nerf import render_chunk  # lazy: no import cycle

    def render(params, oc, dc):
        cols = torch.cat([render_chunk(config, params, o, d) for o, d in zip(oc, dc)])
        # reassemble the frame: rank i of the data group rendered block i
        return all_gather_cat(cols, mesh.data_group)

    return render


def make_render_step(config, mesh: Mesh):
    """:func:`sharded_render_fn` without autograd (PyTorch has no jit: the
    step is the function itself)."""
    return torch.no_grad()(sharded_render_fn(config, mesh))


def sharded_render_image(params, K, c2w, img_size: int, mesh: Mesh, step,
                         chunk: int = 4096) -> torch.Tensor:
    """A ``(img_size, img_size, 3)`` frame with its rays sharded over the
    data group; ``step`` from :func:`make_render_step`."""
    from lomanerf_tpu_torch.core import rays

    K = torch.as_tensor(K, dtype=torch.float32).to(mesh.device)
    c2w = torch.as_tensor(c2w, dtype=torch.float32).to(mesh.device)
    o, d = rays.get_rays(img_size, img_size, K, c2w)
    oc, dc, n = shard_ray_chunks(mesh, o, d, chunk)
    return step(params, oc, dc)[:n].reshape(img_size, img_size, 3)
