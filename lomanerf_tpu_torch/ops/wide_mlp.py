"""The bf16 wide render's MLP on one persistent kernel, and the layer chain
it replaced, each alone.

The bf16 wide render (#8 ``nerf_wide_render_fwd`` and #10, its ``*_rays``
instance) computes the encoding and every hidden layer of a 128-row tile in
one launch per ray chunk (``csrc/nerf_wide_mlp.cuh``: ``wgmma`` with the
weights fed by TMA, the activations kept in shared memory), then composites.
:func:`wide_mlp` launches that kernel alone (``nerf_wide_mlp``) and returns
the last hidden layer's output; :func:`render_rays_layers` runs the whole
render on the layer chain it replaced (``nerf_wide_render_fwd_layers``: the
encoding kernel, one GEMM per hidden layer through device memory, the
``wgmma`` layer GEMM of ``csrc/nerf_wide_layer_gemm.cuh`` since it took over
from ``mma.sync`` with the same bits, compositing), so that the two can be
compared and timed in turns.  The two group each f32 sum otherwise (the
fused MLP sums a layer's whole K in the tensor core's accumulator, the chain
promotes every 32-deep k-step), so they store the same bf16 values except
at near ties: :func:`tied_rows` finds those rows.  Nothing on the main
path calls any of them.  Both take the stacks of
``fused_nerf.pack_wide_params`` and check their shapes before they look at
the device, and take rays, depths and steps as ``render_rays`` does (any
float type and layout, used as contiguous f32); on CUDA tensors each
launches its kernel or raises, on CPU tensors it runs the plain version.
"""

from __future__ import annotations

import torch

from lomanerf_tpu_torch.ops import fused_nerf

# kernel launches of the C entry points; a run resets and reads them
launches = {"nerf_wide_mlp": 0, "nerf_wide_render_fwd_layers": 0}
WIDTHS = (128, 256)  # the padded widths of every bf16 MLP the wide route takes
# of the sum of |products|: how far the two kernels' f32 sums of a layer may
# lie apart, each at most 16 k-steps (K = 256) within 2^-23 of its running
# sum, which that sum bounds (the tensor core truncates, the chain's
# promotion adds round to nearest)
TIE_RTOL = 2 * 16 * 2.0 ** -23


def _check(W, b, t_vals, dists, origins, directions, config) -> None:
    if W.dtype != torch.bfloat16 or config.compute_dtype != "bfloat16":
        raise ValueError(f"need a bf16 weight stack and config, got {W.dtype} and "
                         f"{config.compute_dtype}")
    if W.ndim != 3 or W.shape[0] < 2 or W.shape[1] != W.shape[2] or W.shape[1] not in WIDTHS:
        raise ValueError(f"need an (L >= 2, pw, pw) stack with pw in {WIDTHS}, got "
                         f"{tuple(W.shape)}")
    L, pw = W.shape[:2]
    if b.shape != (L, pw) or b.dtype != torch.float32:
        raise ValueError(f"need an ({L}, {pw}) f32 bias stack, got {tuple(b.shape)} {b.dtype}")
    n, S = origins.shape[0], config.num_samples
    if n == 0 or origins.shape != (n, 3) or directions.shape != (n, 3):
        raise ValueError(f"need (N > 0, 3) rays, got {tuple(origins.shape)} and "
                         f"{tuple(directions.shape)}")
    if t_vals.shape not in ((S,), (n, S)) or (dists is not None and dists.shape != t_vals.shape):
        raise ValueError(f"need ({S},) or ({n}, {S}) depths and steps, got "
                         f"{tuple(t_vals.shape)}")
    if fused_nerf._round_up(config.in_channels, 8) > pw:
        raise ValueError(f"{config.in_channels} encoded columns exceed pw {pw}")
    xs = [t_vals, origins, directions] + ([] if dists is None else [dists])
    if any(x.device != W.device for x in [b, *xs]) or not (W.is_contiguous() and
                                                          b.is_contiguous()):
        raise ValueError("every input must be on one device, the stacks contiguous")
    if W.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no wide MLP for device {W.device}")


def _plain(W, b, t_vals, dists, origins, directions, config, keep: bool):
    """The wide kernels' plain forward (``fused_nerf._wide_plain_forward``)
    on the stacks, layer 0 cut to the encoding's rows (the padded columns
    are zero, so they stay inert)."""
    ws = [W[0, : config.in_channels].float()] + [W[l].float() for l in range(1, W.shape[0])]
    return fused_nerf._wide_plain_forward(ws, list(b), origins, directions, t_vals, dists,
                                          config, keep=keep)


def hidden_reference(W, b, t_vals, origins, directions, config) -> torch.Tensor:
    """Plain version of :func:`wide_mlp`: the ``(N * S, pw)`` bf16 H_{L-1}
    that the plain forward stores for the head (row = ray * S + s)."""
    saved = _plain(W, b, t_vals, torch.zeros_like(t_vals), origins, directions, config,
                   keep=True)[1]
    return saved[W.shape[0] - 1]


def render_reference(W, b, t_vals, dists, origins, directions, config) -> torch.Tensor:
    """Plain version of :func:`render_rays_layers`: the plain forward's colours."""
    return _plain(W, b, t_vals, dists, origins, directions, config, keep=False)[0]


def wide_mlp(W, b, t_vals, origins, directions, config) -> torch.Tensor:
    """The last hidden layer's output ``(N * S, pw)`` bf16 of the bf16 wide
    MLP on ``(N, 3)`` rays at ``(S,)`` or per-ray ``(N, S)`` depths: one
    launch of the fused kernel for all rays on CUDA tensors, the plain
    version on CPU ones."""
    _check(W, b, t_vals, None, origins, directions, config)
    t_vals, origins, directions = (fused_nerf._f32(x) for x in (t_vals, origins, directions))
    if W.device.type == "cpu":
        return hidden_reference(W, b, t_vals, origins, directions, config)
    from lomanerf_tpu_torch.ops import build

    L, pw = W.shape[:2]
    n, S = origins.shape[0], config.num_samples
    if n * S > (1 << 31) - 128:
        raise ValueError(f"{n} x {S} rows exceed one launch's 32-bit row index")
    out = torch.empty((n * S, pw), dtype=torch.bfloat16, device=W.device)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    kc, nf = fused_nerf._wide_args(config, pw, L)[3:5]
    err = build.load().nerf_wide_mlp(
        W.data_ptr(), b.data_ptr(), t_vals.data_ptr(), origins.data_ptr(),
        directions.data_ptr(), out.data_ptr(), n, S, L, pw, kc, nf,
        int(t_vals.ndim == 2), stream)
    if err != 0:
        raise RuntimeError(f"nerf_wide_mlp launch failed: cudaError {err}")
    launches["nerf_wide_mlp"] += 1
    return out


def render_rays_layers(W, b, t_vals, dists, origins, directions, config, hidden: bool = False):
    """``(N, 3)`` colours of the bf16 wide render on the layer chain the
    fused MLP replaced, in ray chunks of ``fused_nerf.wide_chunk_rays``
    with two activation slots; the plain version on CPU tensors.  With
    ``hidden``, all rays in one chunk, and ``(colours, H_{L-1})``: the
    chain's ``(N * S, pw)`` bf16 last hidden output too."""
    _check(W, b, t_vals, dists, origins, directions, config)
    t_vals, dists, origins, directions = (
        fused_nerf._f32(x) for x in (t_vals, dists, origins, directions))
    if W.device.type == "cpu":
        col = render_reference(W, b, t_vals, dists, origins, directions, config)
        return (col, hidden_reference(W, b, t_vals, origins, directions, config)) if hidden \
            else col
    from lomanerf_tpu_torch.ops import build

    L, pw = W.shape[:2]
    n, S = origins.shape[0], config.num_samples
    chunk = n if hidden else max(1, min(n, fused_nerf.wide_chunk_rays(config, pw)))
    acts = torch.empty(2 * chunk * S * pw, dtype=torch.bfloat16, device=W.device)
    out = torch.empty((n, 3), dtype=torch.float32, device=W.device)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = build.load().nerf_wide_render_fwd_layers(
        W.data_ptr(), b.data_ptr(), t_vals.data_ptr(), dists.data_ptr(),
        origins.data_ptr(), directions.data_ptr(), out.data_ptr(), acts.data_ptr(), n,
        chunk, *fused_nerf._wide_args(config, pw, L)[:-1], int(t_vals.ndim == 2), stream)
    if err != 0:
        raise RuntimeError(f"nerf_wide_render_fwd_layers launch failed: cudaError {err}")
    launches["nerf_wide_render_fwd_layers"] += 1
    if hidden:  # the chain's two slots alternate: H_{L-1} is in slot (L - 1) % 2
        return out, acts.view(2, n * S, pw)[(L - 1) % 2]
    return out


def tied_rows(W, b, t_vals, dists, origins, directions, config):
    """Where the fused MLP and the layer chain may part: ``(tied, far,
    fused, chain)``.  For each hidden layer m, from the same stored input,
    the fused kernel's output (:func:`wide_mlp` on the stack cut after
    layer m) against the chain's (m = 0: :func:`render_rays_layers` on the
    same cut, from the same encoding; after it the chain's layer GEMM alone,
    ``wide_gemm.wide_layer_gemm``, on the fused kernel's H_m).  ``tied``
    ``(N * S,)`` marks the rows where some layer's two outputs differ;
    ``far`` counts the differing values that are no near tie: a near tie
    stores two adjacent bf16 values, or a ReLU zero beside a value within
    :data:`TIE_RTOL` of the sum of |products| (at m = 0 from the plain
    encoding, which only scales the bound).  ``fused`` and ``chain`` are
    the two H_{L-1} of the whole stack; off the tied rows they are equal
    when the sums' grouping alone differs.  On CPU tensors both sides run
    their plain versions."""
    from lomanerf_tpu_torch.core import positional_encoding
    from lomanerf_tpu_torch.ops import wide_gemm

    _check(W, b, t_vals, dists, origins, directions, config)
    L, pw = W.shape[:2]
    n, S = origins.shape[0], config.num_samples
    t32, o32, d32 = (fused_nerf._f32(x) for x in (t_vals, origins, directions))
    pts = o32[:, None, :] + d32[:, None, :] * t32.expand(n, S)[..., None]
    tied = torch.zeros(n * S, dtype=torch.bool, device=W.device)
    far, prev = 0, None
    for m in range(L - 1):
        cut_W, cut_b = W[:m + 2], b[:m + 2]
        fused = wide_mlp(cut_W, cut_b, t_vals, origins, directions, config)
        if m == 0:
            chain = render_rays_layers(cut_W, cut_b, t_vals, dists, origins, directions, config,
                                       hidden=True)[1]
            mags = positional_encoding(pts, config.num_encoding_functions).reshape(n * S, -1)
            scale = mags.abs() @ W[0, :mags.shape[1]].float().abs()
        else:
            chain = wide_gemm.wide_layer_gemm(prev, W[m], b[m], pw)
            scale = prev.float().abs() @ W[m].float().abs()
        f, c = fused.float(), chain.float()
        apart = f != c
        top = torch.maximum(f.abs(), c.abs())
        ulp = torch.exp2(torch.floor(torch.log2(torch.where(top > 0, top, 1.0))) - 7)
        near = (f - c).abs() <= torch.maximum(ulp, TIE_RTOL * scale)
        far += int((apart & ~near).sum())
        tied |= apart.any(1)
        prev = fused
    chain = render_rays_layers(W, b, t_vals, dists, origins, directions, config, hidden=True)[1]
    return tied, far, prev, chain
