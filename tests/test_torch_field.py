"""The port's 2D image field against the JAX package, on the CPU.

Same numpy-seeded params and coords through both packages.  On CPU tensors
the port's ``field_forward`` runs its plain version; it is held to the JAX
package's fused field (``fused_mlp._fwd_kernel`` / ``_bwd_kernel`` in
interpret mode, ``highest_precision=True``, ``rows_tile=32``) and to
``core.image_fit_pred`` / ``jax.grad`` of ``core.image_fit_loss``, at the
JAX test's bounds (``test_fused_field_forward_and_grads``): forward rtol
2e-4 / atol 1e-5, grads rtol 3e-4 / atol 3e-5.  The JAX kernel takes cos
as sin(x + pi/2); at n=8 the octave reaches 128 x and its cos lanes sit
~1e-5 from ``cos``; the port computes ``cos`` as core does, and the
forward's rtol (2e-4 of outputs near 0.5) absorbs that difference.  The
CUDA kernels' algorithm (``csrc/field_common.cuh``: tiles of 32 pixels,
the weights streamed through two slots, per-block partials) is
restated in f64 numpy over the staged buffer, and their split-TF32
products are emulated in numpy against f64; ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` compare the kernels themselves on the card.  Also:
the grid coords, the packing, the image-fit step, the model's render and
the ``fit_image`` driver.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lomanerf_tpu import core as jcore
from lomanerf_tpu.models import ImageFieldConfig as JConfig
from lomanerf_tpu.models import ImageFieldModel as JModel
from lomanerf_tpu.models.image_mlp import image_grid_coords as j_grid
from lomanerf_tpu.ops import fused_mlp as j_fused
from lomanerf_tpu.train import loma_adam as j_loma_adam
from lomanerf_tpu.train import loma_sgd as j_loma_sgd
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch.models import ImageFieldConfig, ImageFieldModel, image_grid_coords
from lomanerf_tpu_torch.ops import fused_mlp, fused_nerf
from lomanerf_tpu_torch.train import optim
from lomanerf_tpu_torch.train.steps import make_image_fit_step

FWD_RTOL, FWD_ATOL, GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5, 3e-4, 3e-5
# (layers, width, octaves): the small preset, and the hires preset narrowed
# to 32 so that interpret mode stays quick
SHAPES = {"small": (3, 16, 5), "hires_narrow": (4, 32, 8)}


def np_params(rng, sizes):
    ws = [(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi)).astype(np.float32)
          for fi, fo in sizes]
    bs = [(rng.standard_normal(fo) * 0.5).astype(np.float32) for _, fo in sizes]
    return ws, bs


def field_params(rng, layers, width, nf, out=3):
    return np_params(rng, tcore.mlp_layer_sizes(2 * (1 + 2 * nf), out, layers, width))


def leaves(params):
    return [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [50, 1037])  # neither a multiple of the 32-pixel tile
@pytest.mark.parametrize("shape", list(SHAPES))
def test_field_forward_matches_jax_kernel_and_core(rng, shape, n):
    """Port field_forward (CPU) vs the JAX fused field (interpret mode) and
    the JAX core: values, and the grads of the sum-MSE; None coords grad."""
    layers, width, nf = SHAPES[shape]
    ws, bs = field_params(rng, layers, width, nf)
    coords = rng.random((n, 2)).astype(np.float32)
    target = rng.random((n, 3)).astype(np.float32)
    jp, jc, jt = jcore.params_from_numpy(ws, bs), jnp.asarray(coords), jnp.asarray(target)
    enc = jcore.positional_encoding(jc, nf)

    def j_kernel(p):
        return j_fused.field_forward(p, jc, num_functions=nf, rows_tile=32,
                                     highest_precision=True)

    k_out = j_kernel(jp)
    k_grads = jax.grad(lambda p: jcore.sum_mse(j_kernel(p), jt))(jp)
    c_out = jcore.image_fit_pred(jp, enc)
    c_grads = jax.grad(lambda p: jcore.image_fit_loss(p, enc, jt))(jp)

    params = tcore.params_from_numpy(ws, bs, "cpu")
    lv = leaves(params)
    t_coords = torch.from_numpy(coords).requires_grad_(True)
    out = fused_mlp.field_forward(params, t_coords, nf)
    assert out.shape == (n, 3)
    loss = tcore.sum_mse(out, torch.from_numpy(target))
    got = torch.autograd.grad(loss, lv, retain_graph=True)
    for want_out, want in ((k_out, k_grads), (c_out, c_grads)):
        close(out.detach(), want_out, FWD_RTOL, FWD_ATOL)
        for g, w in zip(got, [*want["w"], *want["b"]]):
            close(g, w, GRAD_RTOL, GRAD_ATOL)
    assert torch.autograd.grad(loss, [t_coords], allow_unused=True) == (None,)


def staged_layers(ws_staged, L, K0, H):
    """The (krows, kcols) weights and kcols biases of each layer, read from
    the staged buffer through the kernels' swizzle (field_common.cuh)."""
    krows, kcols, stage, _ = fused_mlp.field_layout(L, K0, H)
    offs = np.cumsum([0] + stage)
    out = []
    for l in range(L):
        r, c = np.meshgrid(np.arange(krows[l]), np.arange(kcols[l]), indexing="ij")
        blk = ws_staged[offs[l]:offs[l + 1]]
        out.append((blk[fused_mlp.swizzle(r, c, kcols[l])],
                    blk[krows[l] * kcols[l]:krows[l] * kcols[l] + kcols[l]]))
    return out


def copy_schedule(L, bwd, my_tiles):
    """The layer of each weight use of one block, in order (the forward's,
    then d_h's, the head's d_h reading the forward's copy), as the kernel's
    copies deliver them (field_common.cuh: ``issue``, ``acquire``,
    ``release``), simulated on two slots: copy j goes into slot j & 1 only
    after copy j - 2's last use, so a use that reads a stale slot shows up
    as the wrong layer."""
    per_tile = L + (max(L - 2, 0) if bwd else 0)
    loads = per_tile * my_tiles

    def layer_of(j):
        u = j % per_tile
        return u if u < L else 2 * L - 2 - u

    slots, issued, want, done, got = [None, None], 0, 0, 0, []
    for j in range(min(2, loads)):
        slots[j & 1], issued = layer_of(j), j + 1
    for _ in range(my_tiles):
        held = None
        for l in range(L):  # the forward
            got.append(slots[want & 1])
            want += 1
            head = l == L - 1 and bwd and L > 1
            if head:
                held = slots[(want - 1) & 1]
            else:
                if done + 2 < loads:
                    assert issued == done + 2
                    slots[(done + 2) & 1], issued = layer_of(done + 2), done + 3
                done += 1
        if not bwd:
            continue
        for l in range(L - 1, 0, -1):  # d_h
            if l == L - 1:
                got.append(held)
            else:
                got.append(slots[want & 1])
                want += 1
            if done + 2 < loads:
                assert issued == done + 2
                slots[(done + 2) & 1], issued = layer_of(done + 2), done + 3
            done += 1
    assert want == done == loads and issued == loads
    return got


def field_walk(ws_staged, coords, dout, L, K0, H, nf, out_ch, n_blocks, tile=fused_mlp.TILE):
    """numpy (f64) restatement of field_common.cuh over the staged buffer:
    blocks stride over tiles of ``tile`` pixels (pad pixels at coords 0 with
    a zero cotangent); each block takes its weights through two slots
    (``copy_schedule``); per tile the encoding, the forward keeping every
    layer's input, the head's d_z (4 columns, those past ``out_ch`` zero),
    then per layer from the top dW += h^T d_z (rows < rows_l, columns <
    cols_l) and db += the column sums of d_z into the block's partial, and
    d_z written over the layer's input; the partials summed in block order.
    Returns ``(out (n, out_ch), G gradient floats)``."""
    layers = staged_layers(ws_staged.astype(np.float64), L, K0, H)
    rows, cols = [K0] + [H] * (L - 1), [H] * (L - 1) + [4]
    offs = np.cumsum([0] + [r * c + c for r, c in zip(rows, cols)])
    n = coords.shape[0]
    n_tiles = -(-n // tile)
    out, parts = np.zeros((n, out_ch)), np.zeros((n_blocks, int(offs[-1])))
    for blk in range(n_blocks):
        tiles = list(range(blk, n_tiles, n_blocks))
        sched = iter(copy_schedule(L, True, len(tiles)))
        part = parts[blk]
        for t in tiles:
            px = np.arange(t * tile, (t + 1) * tile)
            real = px < n
            xy = np.zeros((tile, 2))
            xy[real] = coords[px[real]]
            enc = [xy]
            for i in range(nf):
                enc += [np.sin(2.0**i * xy), np.cos(2.0**i * xy)]
            acts = [np.concatenate(enc, axis=1)]
            acts[0] = np.pad(acts[0], ((0, 0), (0, layers[0][0].shape[0] - K0)))
            for l in range(L):
                li = next(sched)
                assert li == l, "a use read another layer's slot"
                w, b = layers[li]
                z = acts[l] @ w + b
                acts.append(np.maximum(z, 0.0) if l < L - 1 else 1.0 / (1.0 + np.exp(-z)))
            y = acts[L]
            out[px[real]] = y[real, :out_ch]
            dz = np.zeros((tile, 4))
            dz[real, :out_ch] = dout[px[real]] * y[real, :out_ch] * (1.0 - y[real, :out_ch])
            acts[L] = dz
            for l in reversed(range(L)):
                R, C = rows[l], cols[l]
                dw = acts[l].T @ acts[l + 1]
                part[offs[l]:offs[l] + R * C] += dw[:R, :C].ravel()
                part[offs[l] + R * C:offs[l + 1]] += acts[l + 1][:, :C].sum(0)
                if l > 0:
                    li = next(sched)
                    assert li == l, "a use read another layer's slot"
                    acts[l] = (acts[l + 1] @ layers[li][0].T) * (acts[l] > 0)
    return out, parts.sum(0)


@pytest.mark.parametrize("L,bwd,tiles", [(1, True, 3), (2, True, 3), (4, True, 5),
                                         (5, True, 4), (6, True, 2), (4, False, 5),
                                         (1, False, 2)])
def test_streamed_copies_deliver_each_use_its_layer(L, bwd, tiles):
    """The weights' two-slot schedule (copy j + 2 issued after copy
    j's last use) gives every use of a block, over several tiles, the layer
    it reads: the forward's 0..L-1, then d_h's L-1 (the forward's copy of
    the head), L-2..1."""
    want = (list(range(L)) + (list(range(L - 1, 0, -1)) if bwd else [])) * tiles
    assert copy_schedule(L, bwd, tiles) == want


@pytest.mark.parametrize("n", [50, 1037])
@pytest.mark.parametrize("layers,width,nf,out", [
    (3, 16, 5, 3),   # small: W = 16
    (4, 32, 8, 3),   # hires shape, narrowed: W = 32
    (2, 20, 5, 2),   # padded hidden columns (20 -> 32), two channels read of a 2-wide head
    (1, 16, 5, 3),   # one layer: layer 0 is the head
    (5, 128, 8, 3),  # five layers at width 128
])
def test_field_kernel_algorithm_matches_autograd(rng, layers, width, nf, out, n):
    """The field kernels' walk, restated in numpy over the staged buffer
    (their tile plan and weight schedule) and unpacked by the wrapper's
    unpack_grads, equals the plain version and
    autograd of (field * dout).sum(); pad pixels and pad columns add
    nothing.  Both sides in f64 on f32-exact inputs, so that a ReLU mask
    cannot flip between them: rtol 1e-9."""
    ws, bs = field_params(rng, layers, width, nf, out)
    params = tcore.params_from_numpy(ws, bs, "cpu", dtype=torch.float64)
    coords = rng.random((n, 2)).astype(np.float32).astype(np.float64)
    dout = rng.standard_normal((n, out))
    W = fused_mlp.kernel_width(params, 2, nf, out)
    ws = fused_mlp.pack_field_params(params, W)
    G = fused_nerf.grad_floats(params, W)
    got_out, flat = field_walk(ws.numpy(), coords, dout, layers, 2 * (1 + 2 * nf), W, nf,
                               out, n_blocks=3)
    assert flat.shape == (G,)
    lv = leaves(params)
    want_out = fused_mlp.field_forward(params, torch.from_numpy(coords), nf, out)
    close(got_out, want_out.detach(), 1e-9, 1e-12)
    want = torch.autograd.grad((want_out * torch.from_numpy(dout)).sum(), lv)
    got = fused_nerf.unpack_grads(torch.from_numpy(flat), params, W)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, 1e-9, 1e-12)


def tf32_rna(x):
    """cvt.rna.tf32.f32: f32 to its nearest 10-bit-mantissa value, ties away
    from zero (finite inputs)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_read(x):
    """An f32 operand as the tensor core reads it in TF32: its top 19 bits
    (the 13 below cleared)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def mma_products(a, b, passes=3):
    """``a @ b`` over the last two axes (f32 in, f32 out) as the kernels take
    it on the tensor cores (field_common.cuh: split, warp_gemm): x = hi +
    lo, hi = tf32_rna(x), lo = x - hi read as TF32; per 8-deep k-step
    mma.m16n8k8 adds a_hi b_hi into one f32 accumulator and a_lo b_hi, a_hi
    b_lo into a second, each mma's exact products summed with its
    accumulator and rounded to f32 once; out = the first + the second.
    ``passes=1``: one TF32 pass, a_hi b_hi."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    shape = a.shape[:-1] + b.shape[-1:]
    big, small = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)

        def mma(acc, x, y):
            return (acc.astype(np.float64) + x[..., ks].astype(np.float64)
                    @ y[..., ks, :].astype(np.float64)).astype(np.float32)
        big = mma(big, ah, bh)
        if passes == 3:
            small = mma(mma(small, al, bh), ah, bl)
    return (big + small).astype(np.float32)


def field_3xtf32(ws, bs, coords, dout, nf, passes=3, tile=fused_mlp.TILE):
    """The field kernels' arithmetic in f32 with the hidden layers' products
    in 3xTF32 (``mma_products``; the head's in f32): the forward of every
    pixel, then per tile of ``tile`` pixels dW += h^T d_z (the 32-pixel sum
    as 4 k-steps), db += the column sums of d_z, d_z <- (d_z W^T) masked,
    the tiles added in order in f32.  Returns ``(out (n, out_ch), [dW_0..,
    db_0..])``."""
    f32 = np.float32
    n, out_ch, L = coords.shape[0], dout.shape[1], len(ws)
    T = -(-n // tile)
    xy = np.zeros((T * tile, 2), f32)
    xy[:n] = coords
    enc = [xy]
    for i in range(nf):
        x = (f32(2.0**i) * xy).astype(np.float64)
        enc += [np.sin(x).astype(f32), np.cos(x).astype(f32)]
    K0 = 2 * (1 + 2 * nf)
    pad = -K0 % 8
    acts = [np.pad(np.concatenate(enc, 1), ((0, 0), (0, pad)))]
    def products(x, w, head):
        return (x @ w).astype(f32) if head else mma_products(x, w, passes)

    for l in range(L):
        w = np.pad(ws[l], ((0, pad if l == 0 else 0), (0, 0)))
        z = (products(acts[l], w, l == L - 1) + bs[l]).astype(f32)
        acts.append(np.maximum(z, f32(0)) if l < L - 1 else
                    (f32(1) / (f32(1) + np.exp(-z))).astype(f32))
    y = acts[L]
    g = np.zeros((T * tile, out_ch), f32)
    g[:n] = dout
    acts[L] = (g * y * (f32(1) - y)).astype(f32)
    dws, dbs = [None] * L, [None] * L
    for l in reversed(range(L)):
        h = acts[l][:, :ws[l].shape[0]].reshape(T, tile, -1)
        dz = acts[l + 1].reshape(T, tile, -1)
        per_tile = products(h.transpose(0, 2, 1), dz, l == L - 1)
        cols = dz.sum(1, dtype=f32)
        dw, db = np.zeros_like(per_tile[0]), np.zeros_like(cols[0])
        for t in range(T):
            dw, db = (dw + per_tile[t]).astype(f32), (db + cols[t]).astype(f32)
        dws[l], dbs[l] = dw, db
        if l > 0:
            dh = products(acts[l + 1], np.ascontiguousarray(ws[l].T), l == L - 1)
            acts[l] = np.where(acts[l] > 0, dh, f32(0)).astype(f32)
    return y[:n], dws + dbs


def test_3xtf32_products_meet_the_card_bounds_at_hires_shape(rng):
    """The kernels' split-TF32 scheme, emulated in numpy on a hires-shaped
    field (4 x 128, n = 8, N = 1037), against the f64 field at chip_smoke
    phase 10's bounds: outputs 1e-4 abs + 1e-4 rel, dW/db rtol 3e-4 and atol
    3e-5 of max(1, the leaf's largest entry).  One TF32 pass (a_hi b_hi)
    lands at least 10x farther from f64 than three."""
    n, nf = 1037, 8
    ws, bs = field_params(rng, 4, 128, nf)
    coords = rng.random((n, 2)).astype(np.float32)
    dout = rng.standard_normal((n, 3)).astype(np.float32)
    params = tcore.params_from_numpy(ws, bs, "cpu", dtype=torch.float64)
    lv = leaves(params)
    want_out = fused_mlp.field_forward_reference(params, torch.from_numpy(coords).double(), nf)
    want = torch.autograd.grad((want_out * torch.from_numpy(dout).double()).sum(), lv)
    got_out, got = field_3xtf32(ws, bs, coords, dout, nf)
    np.testing.assert_allclose(got_out, want_out.detach().numpy(), rtol=1e-4, atol=1e-4)
    for g, w in zip(got, want):
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=3e-4, atol=3e-5 * max(1.0, np.abs(w).max()))
    one_out, _ = field_3xtf32(ws, bs, coords, dout, nf, passes=1)
    err3 = np.abs(got_out - want_out.detach().numpy()).max()
    err1 = np.abs(one_out - want_out.detach().numpy()).max()
    assert err1 > 10 * err3, (err1, err3)


def parent_smem_bytes(L, in_dim, width):
    """The shared memory of a block before the tensor-core redesign (64-pixel
    tiles, one layer's weights at a time, rows padded by one float): every
    shape it fitted in 227 KB must still be taken."""
    rows, cols = [in_dim] + [width] * (L - 1), [width] * (L - 1) + [4]
    wbuf = max(r * (c + 1) + c for r, c in zip(rows, cols))
    return 4 * (wbuf + 64 * (in_dim + 1 + sum(c + 1 for c in cols)))


def test_kernel_width_and_shared_memory():
    """The padded width of each preset, the shared memory the kernels' own
    formula gives (16 B of barriers, two weight slots of the largest layer,
    then the activations, the second d_z buffer and the coords; hires: two
    16,512-float slots + 32 x (452 + 128 + 2); 5 x 128: the same slots + 32
    x (580 + 128 + 2)), every shape the kernels took before their redesign
    still taken, and a raise naming D2 for each case no kernel takes."""
    rng = np.random.default_rng(0)

    def params(layers, width, nf=5, out=3):
        return tcore.params_from_numpy(*field_params(rng, layers, width, nf, out), "cpu")

    assert fused_mlp.kernel_width(params(3, 16), 2, 5, 3) == 16
    assert fused_mlp.kernel_width(params(3, 30), 2, 5, 3) == 32
    assert fused_mlp.kernel_width(params(4, 128, 8), 2, 8, 3) == 128
    assert fused_mlp.kernel_width(params(5, 128, 8), 2, 8, 3) == 128
    assert fused_mlp.field_smem_bytes(4, 34, 128) == 16 + 4 * (2 * 16512 + 32 * 582)
    assert fused_mlp.field_smem_bytes(5, 34, 128) == 16 + 4 * (2 * 16512 + 32 * 710)
    assert fused_mlp.field_smem_bytes(3, 22, 16) == 16 + 4 * (
        2 * (24 * 16 + 16) + 32 * (32 + 16 + 16 + 4 + 16 + 2))
    limit = 227 * 1024
    for width in fused_mlp.WIDTHS:
        for nf in (0, 5, 8, 12):
            for L in range(1, 13):
                if parent_smem_bytes(L, 2 * (1 + 2 * nf), width) <= limit:
                    assert fused_mlp.field_smem_bytes(L, 2 * (1 + 2 * nf), width) <= limit
    for p, nf, out, match in ((params(3, 200), 5, 3, "width 200"),
                              (params(3, 16, out=5), 5, 5, "5-channel head"),
                              (params(8, 128, 8), 8, 3, "shared memory")):
        with pytest.raises(NotImplementedError, match="D2"):
            fused_mlp.kernel_width(p, 2, nf, out)
        with pytest.raises(NotImplementedError, match=match):
            fused_mlp.kernel_width(p, 2, nf, out)
    p3 = tcore.params_from_numpy(*np_params(rng, tcore.mlp_layer_sizes(33, 3, 2, 16)), "cpu")
    with pytest.raises(NotImplementedError, match="3-d coords.*D2"):
        fused_mlp.kernel_width(p3, 3, 5, 3)
    with pytest.raises(ValueError, match="first layer"):
        fused_mlp.kernel_width(params(3, 16), 2, 4, 3)
    with pytest.raises(ValueError, match="out_channels"):
        fused_mlp.kernel_width(params(3, 16), 2, 5, 4)


def test_packing_round_trip_and_cpu_route(rng):
    """The staged buffer, read back through the kernels' swizzle, gives the
    params back exactly with zeros in every pad row and column; the
    gradient layout's unpack_grads of pack_params does too; the CPU path
    launches nothing."""
    for layers, width, nf in [*SHAPES.values(), (5, 128, 8)]:
        params = tcore.params_from_numpy(*field_params(rng, layers, width, nf), "cpu")
        W = fused_mlp.kernel_width(params, 2, nf, 3)
        ws = fused_mlp.pack_field_params(params, W)
        assert ws.dtype == torch.float32 and ws.numel() == sum(fused_mlp.field_layout(
            layers, 2 * (1 + 2 * nf), W)[2])
        staged = staged_layers(ws.numpy(), layers, 2 * (1 + 2 * nf), W)
        for (sw, sb), w, b in zip(staged, params["w"], params["b"]):
            fi, fo = w.shape
            assert np.array_equal(sw[:fi, :fo], w.numpy()) and np.array_equal(sb[:fo], b.numpy())
            assert not sw[fi:].any() and not sw[:, fo:].any() and not sb[fo:].any()
        pk = fused_nerf.pack_params(params, torch.zeros(0), torch.zeros(0), W)
        G = fused_nerf.grad_floats(params, W)
        back = fused_nerf.unpack_grads(pk[:G], params, W)
        for a, b in zip(back, [*params["w"], *params["b"]]):
            assert torch.equal(a, b)
    before = dict(fused_mlp.launches)
    fused_mlp.field_forward(params, torch.rand(10, 2), nf).sum()
    assert fused_mlp.launches == before


@pytest.mark.parametrize("size", [1, 5, 64])
def test_image_grid_coords_match_jax(size):
    got = image_grid_coords(size)
    assert got.shape == (size * size, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_grid(size)))
    if size > 1:  # x varies fastest: "xy" indexing, not torch's "ij" default
        assert float(got[1, 0]) > 0.0 and float(got[1, 1]) == 0.0


@pytest.mark.parametrize("which", ["sgd", "adam", "loma_adam"])
def test_image_fit_step_trajectory_matches_jax(rng, which):
    """3 steps of make_image_fit_step with seeded adjoints (1, 0.5, then the
    previous loss) vs the JAX step (backend="jnp").  SGD: params rtol 1e-5 /
    atol 1e-6.  Adam divides by sqrt(v), so a gradient entry near 0 turns a
    tiny difference into a larger relative one: rtol 1e-4 / atol 1e-5."""
    from lomanerf_tpu.train.steps import make_image_fit_step as j_make_step

    cfg, jcfg = ImageFieldConfig(img_size=8), JConfig(img_size=8)
    ws, bs = field_params(rng, 3, 16, 5)
    batches = [(rng.random((64, 2)).astype(np.float32),
                rng.random((64, 3)).astype(np.float32)) for _ in range(3)]
    lr = 1e-3
    j_opt = {"sgd": j_loma_sgd(lr), "adam": optax.adam(lr), "loma_adam": j_loma_adam(lr)}[which]
    jp = jcore.params_from_numpy(ws, bs)
    js = j_opt.init(jp)
    j_step = j_make_step(jcfg, j_opt, backend="jnp", donate=False)
    model = ImageFieldModel.from_numpy(cfg, ws, bs, device="cpu")
    params = list(model.parameters())
    t_opt = {"sgd": lambda: optim.loma_sgd(params, lr),
             "adam": lambda: torch.optim.Adam(params, lr=lr),
             "loma_adam": lambda: optim.loma_adam(params, lr)}[which]()
    step = make_image_fit_step(cfg, t_opt)
    rtol, atol = (1e-5, 1e-6) if which == "sgd" else (1e-4, 1e-5)
    seed = None
    for i, (c, t) in enumerate(batches):
        jp, js, j_loss = j_step(jp, js, jnp.asarray(c), jnp.asarray(t), seed)
        loss = step(model, torch.from_numpy(c), torch.from_numpy(t),
                    None if seed is None else torch.tensor(seed))
        assert loss.shape == () and not loss.requires_grad
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
        for a, w in zip([*model.w, *model.b], [*jp["w"], *jp["b"]]):
            close(a.detach(), w, rtol, atol)
        seed = 0.5 if i == 0 else float(loss)


def test_model_render_and_loss_match_jax(rng):
    """ImageFieldModel.render and .loss (CPU: the plain version) vs the JAX
    model's (jnp backend); the plain backend gives the same."""
    cfg, jcfg = ImageFieldConfig(img_size=12), JConfig(img_size=12)
    ws, bs = field_params(rng, 3, 16, 5)
    jp = jcore.params_from_numpy(ws, bs)
    jm = JModel(jcfg)
    coords = rng.random((30, 2)).astype(np.float32)
    target = rng.random((30, 3)).astype(np.float32)
    for backend in ("auto", "plain"):
        model = ImageFieldModel.from_numpy(cfg, ws, bs, device="cpu", backend=backend)
        with torch.no_grad():
            img = model.render()
        assert img.shape == (12, 12, 3)
        close(img, jm.render(jp), FWD_RTOL, FWD_ATOL)
        close(model.render(5).detach(), jm.render(jp, 5), FWD_RTOL, FWD_ATOL)
        loss = model.loss(torch.from_numpy(coords), torch.from_numpy(target))
        np.testing.assert_allclose(loss.item(), float(jm.loss(jp, jnp.asarray(coords),
                                                             jnp.asarray(target))), rtol=1e-5)
        close(model.predict(model.encode(torch.from_numpy(coords))).detach(),
              jm.predict(jp, jm.encode(jnp.asarray(coords))), FWD_RTOL, FWD_ATOL)
    with pytest.raises(ValueError):
        ImageFieldModel(cfg, backend="pallas")
    assert ImageFieldConfig.hires().in_channels == JConfig.hires().in_channels == 34
    assert ImageFieldConfig.small().in_channels == 22


def test_init_shapes_and_synthetic_target_match_jax():
    from lomanerf_tpu.train.fit_image import synthetic_target as j_target
    from lomanerf_tpu_torch.train.fit_image import synthetic_target

    np.testing.assert_array_equal(synthetic_target(33), j_target(33))
    model = ImageFieldModel(ImageFieldConfig.hires(), device="cpu")
    params = model.init(torch.Generator().manual_seed(215))
    jparams = JModel(JConfig.hires()).init(jax.random.PRNGKey(215))
    assert [tuple(w.shape) for w in params["w"]] == [w.shape for w in jparams["w"]]
    assert [tuple(b.shape) for b in params["b"]] == [b.shape for b in jparams["b"]]


def _rows(path):
    return [json.loads(line) for line in open(path)]


def test_fit_image_driver_smoke_resume_and_parity_seed(tmp_path):
    from PIL import Image

    from lomanerf_tpu_torch.train import fit_image
    from lomanerf_tpu_torch.train.checkpoint import CheckpointManager

    flags = ["--device", "cpu", "--img", "synthetic", "--img-size", "16",
             "--optimizer", "adam", "--lr", "3e-3", "--log-every", "10",
             "--log-dir", str(tmp_path / "logs_2d"), "--ckpt-dir", str(tmp_path / "ck"),
             "--ckpt-every", "0"]
    out = fit_image.main([*flags, "--steps", "12"])
    assert len(out["losses"]) == 12 and sorted(out["psnr"]) == [0, 10]
    for step in (0, 10, 12):  # target | prediction
        assert np.asarray(Image.open(tmp_path / "logs_2d" / f"iter_{step}.png")).shape == (16, 32, 3)
    rows = _rows(tmp_path / "logs_2d" / "metrics.jsonl")
    assert [r["step"] for r in rows] == list(range(12))  # the loss curve
    assert all("loss" in r for r in rows) and [r["step"] for r in rows if "psnr" in r] == [0, 10]
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 12
    # resume with the loss-seeded adjoint, in chunks of 100 pixels
    more = fit_image.main([*flags, "--steps", "14", "--resume", "--parity-seed",
                           "--chunk", "100"])
    assert len(more["losses"]) == 2 and np.all(np.isfinite(more["losses"]))
    assert np.isfinite(more["final_psnr"])
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 14


def test_fit_image_converges_and_refuses_missing_card(tmp_path):
    """150 Adam steps on a 48x48 synthetic target lift the PSNR well above
    its start; without a card, --device cuda exits."""
    from lomanerf_tpu_torch.train import fit_image

    out = fit_image.main(["--device", "cpu", "--img-size", "48", "--steps", "151",
                          "--optimizer", "adam", "--lr", "3e-3", "--log-every", "50",
                          "--log-dir", str(tmp_path / "logs"), "--ckpt-dir",
                          str(tmp_path / "ck"), "--ckpt-every", "0"])
    psnrs = out["psnr"]
    assert psnrs[150] > psnrs[0] + 8.0, psnrs
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            fit_image.main(["--steps", "1"])
    assert os.path.exists(tmp_path / "logs" / "iter_151.png")


def test_field_variants_edit_the_current_source():
    """Every variant of ``scripts/field_variants`` applies to
    ``field_common.cuh`` as it stands (each edit matches as often as it
    names), the first is the header unchanged, and each changes what it
    names; its card_probe companion parses ``--what field``; both refuse to
    run without a card."""
    from lomanerf_tpu_torch.ops import build
    from lomanerf_tpu_torch.scripts import card_probe, field_variants

    srcs = field_variants.patched(field_variants.VARIANTS)
    now = (build.CSRC / field_variants.HEADER).read_text()
    assert srcs.pop("as is") == {field_variants.HEADER: now}
    texts = [v[field_variants.HEADER] for v in srcs.values()]
    assert len(set(texts)) == len(texts) and now not in texts
    assert set(field_variants.WHOLE) <= set(field_variants.VARIANTS)
    with pytest.raises(SystemExit):
        field_variants.patched({"x": [("no such line", "", 1)]})
    assert card_probe.field_family("void field::(anonymous namespace)::field_kernel<true>(float "
                                   "const*)", "kernel") == "field_bwd"
    assert card_probe.field_family("field::(anonymous namespace)::field_kernel<false>",
                                   "kernel") == "field_fwd"
    if not torch.cuda.is_available():
        for main in (field_variants.main, lambda a: card_probe.main(["--what", "field", *a])):
            with pytest.raises(SystemExit):
                main([])


@pytest.mark.parametrize("tier,exact", [("highest", 1), ("high", 0), ("default", 0)])
def test_model_precision_reaches_the_field_wrapper(rng, monkeypatch, tier, exact):
    """``ImageFieldModel.predict_coords`` (and so ``loss`` and ``render``)
    passes the config's precision to ``fused_mlp.field_forward``, which maps
    the JAX package's tiers to the kernels' product route: "highest" exact
    f32 FMAs, "high" and "default" 3xTF32."""
    seen = []
    real = fused_mlp.field_forward

    def spy(params, coords, nf, out_channels=3, precision="high"):
        seen.append(precision)
        return real(params, coords, nf, out_channels, precision=precision)
    monkeypatch.setattr(fused_mlp, "field_forward", spy)
    cfg = ImageFieldConfig(precision=tier, img_size=4)
    ws, bs = field_params(rng, cfg.num_layers, cfg.filter_size, cfg.num_encoding_functions)
    model = ImageFieldModel.from_numpy(cfg, ws, bs, device="cpu")
    coords = image_grid_coords(4)
    model.loss(coords, torch.zeros(16, 3)).backward()
    model.render()
    assert seen == [tier, tier]
    assert fused_mlp.exact_tier(tier) == exact


@pytest.mark.parametrize("tier", ["HIGHEST", "bf16x3", "", None, True, 1])
def test_unknown_precision_tier_is_refused(rng, tier):
    """A tier the JAX package does not name is refused on any device, before
    the plain version or a kernel runs."""
    ws, bs = field_params(rng, 3, 16, 5)
    params = tcore.params_from_numpy(ws, bs, "cpu")
    with pytest.raises(ValueError, match="precision tier"):
        fused_mlp.field_forward(params, torch.zeros(4, 2), 5, precision=tier)
    with pytest.raises(ValueError, match="precision tier"):
        ImageFieldModel.from_numpy(ImageFieldConfig(precision=tier), ws, bs,
                                   device="cpu").predict_coords(torch.zeros(4, 2))


@pytest.mark.parametrize("exact", [0, 1])
def test_field_function_passes_the_route_to_both_launches(rng, monkeypatch, exact):
    """``_FieldFwd`` hands its route to the forward and the gradient launch
    (the launchers stubbed with the plain version on CPU tensors)."""
    calls = []
    ws, bs = field_params(rng, 3, 16, 5)
    params = tcore.params_from_numpy(ws, bs, "cpu")
    coords = torch.from_numpy(rng.random((37, 2)).astype(np.float32))
    width = fused_mlp.kernel_width(params, 2, 5, 3)

    def fwd(pk, c, *dims):
        calls.append(("fwd", dims))
        return fused_mlp.field_forward_reference(params, c, 5).detach()

    def bwd(pk, G, c, dout, *dims):
        calls.append(("bwd", dims))
        return torch.zeros(G)
    monkeypatch.setattr(fused_mlp, "_launch_fwd", fwd)
    monkeypatch.setattr(fused_mlp, "_launch_bwd", bwd)
    lv = [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]
    out = fused_mlp._FieldFwd.apply(coords, 5, 3, width, exact, *lv)
    out.sum().backward()
    dims = (3, 22, width, 5, 3, exact)
    assert calls == [("fwd", dims), ("bwd", dims)]
