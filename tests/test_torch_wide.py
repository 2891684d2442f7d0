"""The port's wide path (padded width above 64: the 8x256 flagship's
kernels) against the JAX package, on the CPU.

Same numpy-seeded params and rays through both packages.  On CPU tensors the
port's ``render_rays``, ``nerf_train_loss`` and ``nerf_loss`` run the plain
version of the wide kernels (``fused_nerf._WidePlain``: the kernels'
rounding plan in plain PyTorch); they are held to the JAX package's W
kernels (``_nerf_forward_kernel_W``, ``_nerf_train_kernel_W``,
``_nerf_backward_kernel_W`` in interpret mode, as its own tests run them).
The CUDA kernels' sequence over the packed buffers (encoding, layer GEMMs,
per-ray compositing, split-K dW partials and their fixed-order sums, ray
chunks) is restated in numpy and held to the plain version;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` compare the kernels
themselves on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lomanerf_tpu import core as jcore
from lomanerf_tpu.models import NeRFConfig as JConfig
from lomanerf_tpu.models import NeRFModel as JModel
from lomanerf_tpu.ops import fused_nerf as j_fused
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
from lomanerf_tpu_torch.ops import fused_nerf
from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

# f32: the JAX test's bounds for its own W kernels
# (test_fused_wide_smajor_train_and_render)
COL_RTOL, COL_ATOL, LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 3e-4, 1e-5, 1e-5, 3e-4, 3e-5


def he_params(rng, sizes):
    ws = [(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi)).astype(np.float32)
          for fi, fo in sizes]
    bs = [(rng.standard_normal(fo) * 0.5).astype(np.float32) for _, fo in sizes]
    return ws, bs


def nerf_init_params(rng, sizes):
    """``init="nerf"`` from numpy: He hidden weights, zero biases, the head
    x0.1 with a +0.5 density bias."""
    ws, _ = he_params(rng, sizes)
    bs = [np.zeros(fo, np.float32) for _, fo in sizes]
    ws[-1] = ws[-1] * np.float32(0.1)
    bs[-1][3] = 0.5
    return ws, bs


def batch(rng, n, S, near=2.0, far=6.0):
    o = rng.standard_normal((n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    t = np.linspace(near, far, S, dtype=np.float32)
    dists = np.concatenate([t[1:] - t[:-1], [1e8]]).astype(np.float32)
    tgt = rng.random((n, 3)).astype(np.float32)
    return o, d, t, dists, tgt


def leaves(params):
    return [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]


def three_ways(ws, bs, b, cfg, jcfg):
    """(colours, loss, train-loss grads, render-loss grads) of the port's
    plain version and of the JAX fused kernels."""
    o, d, t, dists, tgt = b
    jp = jcore.params_from_numpy(ws, bs)
    ja = [jnp.asarray(x) for x in (o, d, t, dists, tgt)]
    j_col = j_fused.render_rays(jp, *ja[:4], jcfg)
    j_loss, j_g = jax.value_and_grad(lambda p: j_fused.nerf_train_loss(p, *ja, jcfg))(jp)
    j_r = jax.grad(lambda p: j_fused.nerf_loss(p, *ja, jcfg))(jp)
    params = tcore.params_from_numpy(ws, bs, "cpu")
    lv = leaves(params)
    ta = [torch.from_numpy(x) for x in (o, d, t, dists, tgt)]
    col = fused_nerf.render_rays(params, *ta[:4], cfg)
    loss = fused_nerf.nerf_train_loss(params, *ta, cfg)
    g = torch.autograd.grad(loss, lv)
    r = torch.autograd.grad(fused_nerf.nerf_loss(params, *ta, cfg), lv)
    jl = lambda tree: [np.asarray(x) for x in [*tree["w"], *tree["b"]]]  # noqa: E731
    return ((col.detach().numpy(), loss.item(), [x.numpy() for x in g],
             [x.numpy() for x in r]),
            (np.asarray(j_col), float(j_loss), jl(j_g), jl(j_r)))


@pytest.mark.parametrize("mode", ["loma", "standard"])
def test_wide_f32_matches_jax_kernels(rng, mode):
    """3x160, S=6, n=20 (not a tile multiple), f32: the port's plain render,
    train loss and grads and render-loss grads vs the JAX W kernels."""
    cfg = NeRFConfig(num_layers=3, filter_size=160, num_samples=6, mode=mode)
    jcfg = JConfig(num_layers=3, filter_size=160, num_samples=6, mode=mode)
    ws, bs = he_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 160))
    assert fused_nerf._padded_width(cfg, tcore.params_from_numpy(ws, bs, "cpu")) > 64
    got, want = three_ways(ws, bs, batch(rng, 20, 6), cfg, jcfg)
    np.testing.assert_allclose(got[0], want[0], rtol=COL_RTOL, atol=COL_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=LOSS_RTOL)
    for a, b in zip(got[2] + got[3], want[2] + want[3]):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


# bf16: both sides round the same values to bf16 at the same places, but a
# sum taken in another order can move a value across a bf16 rounding
# boundary (one bf16 ulp is 2^-8 relative), and that flip propagates.
# Started from atol 2e-3 on colours and 1e-2 of each leaf's largest entry on
# grads; the worst cases measured over numpy seeds 215 and 0-4 of both
# cases were colours 5.5e-4 abs, loss 1.75e-5 rel and grads 1.1e-2 of the
# leaf's largest entry (all at 4x256/S=16; at 3x128/S=8 the worst were
# 1.2e-7, 1.3e-7 and 8.3e-5), and the bounds are about 4x those.
BF16_COL_ATOL, BF16_LOSS_RTOL, BF16_GRAD_REL = 2.2e-3, 7e-5, 4.4e-2
# the numpy restatement in f64 against the plain version in f32, bf16
# rounding on both: worst measured 4.0e-5 of the leaf's largest entry over
# seeds 215, 1, 2, 3; about 4x that
SEQ_BF16_GRAD_REL = 1.6e-4


@pytest.mark.parametrize("layers,width,S", [(3, 128, 8), (4, 256, 16)])
def test_wide_bf16_matches_jax_kernels(rng, layers, width, S):
    """bf16 compute, standard mode, init="nerf"-style params."""
    kw = dict(num_layers=layers, filter_size=width, num_samples=S, mode="standard",
              compute_dtype="bfloat16", precision="default", init="nerf")
    cfg, jcfg = NeRFConfig(**kw), JConfig(**kw)
    ws, bs = nerf_init_params(rng, tcore.mlp_layer_sizes(33, 4, layers, width))
    got, want = three_ways(ws, bs, batch(rng, 20, S), cfg, jcfg)
    col_err = np.abs(got[0] - want[0]).max()
    loss_err = abs(got[1] - want[1]) / abs(want[1])
    grad_err = max(np.abs(a - b).max() / np.abs(b).max()
                   for a, b in zip(got[2] + got[3], want[2] + want[3]))
    assert col_err <= BF16_COL_ATOL, col_err
    assert loss_err <= BF16_LOSS_RTOL, loss_err
    assert grad_err <= BF16_GRAD_REL, grad_err


def dw_stage(A, Zb, row_chunk, k_step):
    """The bf16 dW stage's partials (nerf_wide_dw.cuh): per partial of
    ``row_chunk`` rows, ``k_step``-row k-steps (the last of a partial
    ragged), each k-step's sum rounded to f32 and promoted into the
    partial's f32 running sum in order.  ``Zb`` is the bf16 copy of d_z."""
    parts = []
    for r0 in range(0, A.shape[0], row_chunk):
        r1 = min(r0 + row_chunk, A.shape[0])
        part = np.zeros((A.shape[1], Zb.shape[1]), np.float32)
        for k0 in range(r0, r1, k_step):
            k1 = min(k0 + k_step, r1)
            part = part + (A[k0:k1].T @ Zb[k0:k1]).astype(np.float32)
        parts.append(part)
    return parts


def forward_sequence(W, b, p, kc, nf, rnd):
    """The wide kernels' forward in f64 on the (rows, 3) points ``p``: the
    encoding into the first kc columns of a (rows, pw) buffer whose other
    columns are NaN (never read), then each hidden layer ``rnd(ReLU(H W_l +
    b_l))``.  Returns ``[H_0, ..., H_{L-1}]``."""
    pw = W.shape[1]
    enc = np.full((p.shape[0], pw), np.nan)
    feats = [p] + [f(2.0**i * p) for i in range(nf) for f in (np.sin, np.cos)]
    enc[:, :kc] = 0.0
    enc[:, :3 * (1 + 2 * nf)] = np.concatenate(feats, 1)
    H = [rnd(enc)]
    for l in range(W.shape[0] - 1):
        K = kc if l == 0 else pw
        H.append(rnd(np.maximum(H[l][:, :K] @ W[l, :K] + b[l], 0.0)))
    return H


def kernel_sequence(W, b, t, dists, o, d, cot, S, kc, nf, loma, rnd, train,
                    chunk_rays, row_chunk, k_step=None):
    """numpy (f64) re-statement of the CUDA gradient sequence
    (nerf_wide_chain.cuh) over the packed stacks, with ``t``/``dists``
    shared (S,) or per-ray (N, S) (the ``*_rays`` entry points: each chunk
    reads its own rows): per ray chunk, the forward (:func:`forward_sequence`:
    the encoding and the layer GEMMs), the per-ray compositing walk and its
    adjoint, then in reverse the split-K dW partials of row_chunk rows and
    the db column-sum partials, each added in a fixed order.  The head
    reads the first ``hc`` columns of its input: pw after a hidden layer,
    the encoded width kc for a one-layer MLP, whose sequence ends with the
    head's dW.  ``rnd`` rounds
    to the compute dtype.  With ``k_step`` (bf16), the producers of each
    hidden d_z (compositing, the d_h product) also write its rounded copy,
    which the hidden layers' dW stage reads in f32 k-steps
    (:func:`dw_stage`), its partials added in f32 in order; the head's dW
    keeps the f64 partials.  Returns (dW, db, loss)."""
    L, pw = W.shape[0], W.shape[1]
    hc = kc if L == 1 else pw
    dW, db, loss = np.zeros((L, pw, pw)), np.zeros((L, pw)), 0.0

    def add_partials(A, Z, dst):  # dst += sum_z A[z]^T rnd(Z[z]), z in order
        for r0 in range(0, A.shape[0], row_chunk):
            dst += A[r0:r0 + row_chunk].T @ rnd(Z[r0:r0 + row_chunk])

    def add_stage(A, Zb, dst):  # dst += the f32 sum of the stage's partials
        total = np.zeros(dst.shape, np.float32)
        for part in dw_stage(A, Zb, row_chunk, k_step):
            total = total + part
        dst += total

    def add_colsums(Z, dst):
        for r0 in range(0, Z.shape[0], row_chunk):
            dst += Z[r0:r0 + row_chunk].sum(0)

    t = np.broadcast_to(t, (o.shape[0], S))
    dists = np.broadcast_to(dists, (o.shape[0], S))
    for c0 in range(0, o.shape[0], chunk_rays):
        oc, dc, yc = o[c0:c0 + chunk_rays], d[c0:c0 + chunk_rays], cot[c0:c0 + chunk_rays]
        tc, distc = t[c0:c0 + chunk_rays], dists[c0:c0 + chunk_rays]
        n = oc.shape[0]
        # the points in f32, as the encoding kernel rounds them (o + d*t, no
        # contraction); the rest in f64
        f32 = np.float32
        p = (oc[:, None, :].astype(f32) + dc[:, None, :].astype(f32) * tc[:, :, None].astype(f32))
        p = p.reshape(n * S, 3).astype(np.float64)
        H = forward_sequence(W, b, p, kc, nf, rnd)
        z = H[-1][:, :hc] @ W[L - 1][:hc, :4] + b[L - 1][:4]
        rgb, sig = rnd(1.0 / (1.0 + np.exp(-z[:, :3]))), rnd(np.maximum(z[:, 3], 0.0))
        dz_head = np.zeros((n * S, 4))
        for r in range(n):
            rows = slice(r * S, (r + 1) * S)
            e = np.exp(-sig[rows] * distc[r])
            alpha, c = 1.0 - e, e + 1e-10
            P, Ps, Ts, col = 1.0, [], [], np.zeros(3)
            for s in range(S):
                if loma:
                    P *= c[s]
                    T = 1.0 if s == 0 else P
                else:
                    T, P = P, P * c[s]
                Ps.append(P)
                Ts.append(T)
                col += alpha[s] * T * rgb[rows][s]
            if train:
                loss += float(np.sum((col - yc[r]) ** 2))
                dcol = 2.0 * (col - yc[r])
            else:
                dcol = yc[r]
            suf = carry = 0.0
            for s in reversed(range(S)):
                d_w = float(dcol @ rgb[rows][s])
                if loma:
                    d_P = d_w * alpha[s] if s >= 1 else 0.0
                else:
                    d_P, carry = (carry if s < S - 1 else 0.0), d_w * alpha[s]
                suf += d_P * Ps[s]
                d_sigma = (d_w * Ts[s] - suf / c[s]) * distc[r, s] * (1.0 - alpha[s])
                g = rgb[rows][s]
                dz_head[r * S + s, :3] = dcol * alpha[s] * Ts[s] * g * (1.0 - g)
                dz_head[r * S + s, 3] = d_sigma if sig[r * S + s] > 0 else 0.0
        add_partials(H[L - 1][:, :hc], dz_head, dW[L - 1][:hc, :4])
        add_colsums(dz_head, db[L - 1][:4])
        if L == 1:
            continue
        dz = (rnd(dz_head) @ W[L - 1][:, :4].T) * (H[L - 1] > 0)
        dzb = rnd(dz)  # the copy compositing writes beside d_z
        for l in range(L - 2, -1, -1):
            K = kc if l == 0 else pw
            if k_step:
                add_stage(H[l][:, :K], dzb, dW[l][:K])
            else:
                add_partials(H[l][:, :K], dz, dW[l][:K])
            add_colsums(dz, db[l])
            if l >= 1:
                dz = (dzb @ W[l].T) * (H[l] > 0)
                dzb = rnd(dz)  # the d_h epilogue's copy
    return dW, db, loss


def bf16_round(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("depths", ["shared", "perray"])
@pytest.mark.parametrize("compute_dtype,layers,width,mode,train", [
    ("float32", 3, 100, "loma", True),       # pw 128, ragged hidden width
    ("float32", 2, 130, "standard", False),  # pw 256, no hidden-to-hidden layer
    ("bfloat16", 4, 96, "standard", True),   # the flagship's rounding plan
    ("bfloat16", 3, 72, "loma", False),
])
def test_kernel_sequence_matches_plain(rng, compute_dtype, layers, width, mode, train,
                                       depths):
    """The wide kernels' sequence, restated in numpy over pack_wide_params'
    stacks and unpacked by unpack_wide_grads, equals autograd of the plain
    version: the train loss (#7, or #12 on per-ray depths) or
    (render * cot).sum() (#9, or #11), at shared (S,) depths or jittered
    per-ray (N, S) ones from the stratified sampler.  Ray chunks of 4 and
    split-K chunks of 7 rows make every sum cross a chunk edge; for bf16,
    the dW stage's k-steps of 3 rows (ragged in every partial) read the
    rounded d_z copy."""
    S, n = 5, 9
    cfg = NeRFConfig(num_layers=layers, filter_size=width, num_samples=S, mode=mode,
                     compute_dtype=compute_dtype)
    ws, bs = nerf_init_params(rng, tcore.mlp_layer_sizes(33, 4, layers, width))
    params = tcore.params_from_numpy(ws, bs, "cpu")
    kind, pw = fused_nerf._route(cfg, params)
    assert kind == "wide" and pw == (128 if width <= 128 else 256)
    o, d, t, dists, tgt = batch(rng, n, S)
    if depths == "perray":
        _, t_rays, d_rays = tcore.sample_along_rays(
            torch.zeros(n, 3), torch.zeros(n, 3), 2.0, 6.0, S,
            generator=torch.Generator().manual_seed(layers))
        t, dists = t_rays.numpy(), d_rays.numpy()
    cot = tgt if train else rng.standard_normal((n, 3)).astype(np.float32)
    W, b = fused_nerf.pack_wide_params(params, pw, compute_dtype)
    assert W.shape == (layers, pw, pw) and W.dtype == fused_nerf._DTYPES[compute_dtype]
    assert b.shape == (layers, pw) and b.dtype == torch.float32
    rnd = bf16_round if compute_dtype == "bfloat16" else (lambda x: x)
    dW, db, loss = kernel_sequence(
        W.double().numpy(), b.double().numpy(), t.astype(np.float64),
        dists.astype(np.float64), o.astype(np.float64), d.astype(np.float64),
        cot.astype(np.float64), S, 40, 5, mode == "loma", rnd, train, 4, 7,
        3 if compute_dtype == "bfloat16" else None)
    got = fused_nerf.unpack_wide_grads(torch.from_numpy(dW), torch.from_numpy(db), params)
    args = [torch.from_numpy(x) for x in (o, d, t, dists)]
    lv = leaves(params)
    if train:
        out = fused_nerf.nerf_train_loss_reference(params, *args, torch.from_numpy(tgt), cfg)
        np.testing.assert_allclose(loss, out.item(), rtol=LOSS_RTOL)
    else:
        out = (fused_nerf.render_rays_reference(params, *args, cfg)
               * torch.from_numpy(cot)).sum()
    want = torch.autograd.grad(out, lv)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if compute_dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
        else:  # f64 against f32 sums: bf16 roundings can flip, as above
            assert np.abs(g.numpy() - w.numpy()).max() <= SEQ_BF16_GRAD_REL * np.abs(
                w.numpy()).max()


def test_flagship_batch_is_one_gradient_chunk():
    """With the bf16 d_z copies in the gradient scratch (4 bytes per sample
    and column more), the flagship's 16,384-ray batch is still one chunk of
    a wide gradient call; f32 MLPs keep their chunk (no copy)."""
    full = NeRFConfig.full()
    assert fused_nerf.wide_grad_chunk_rays(full, 256, 8) >= 16384
    f32 = NeRFConfig(num_layers=4, filter_size=128, num_samples=32)
    assert fused_nerf.wide_grad_chunk_rays(f32, 128, 4) == \
        fused_nerf.WIDE_GRAD_BYTES // (32 * (128 * (4 * 4 + 8) + 16))


@pytest.mark.parametrize("rows,in_cols,pw", [(8192 + 1037, 40, 128), (300, 128, 128),
                                             (8192, 256, 256)])
def test_dw_stage_plain_matches_its_order(rng, rows, in_cols, pw):
    """``wide_dw.wide_dw_gemm``'s plain version (what the CPU runs) against
    the numpy restatement of the kernel's order (32-row k-steps promoted
    into f32 sums, 8192-row partials) within 1e-6 of the f64 sum of
    |products|, at a ragged last partial, one short partial and one whole."""
    from lomanerf_tpu_torch.ops import wide_dw

    h = torch.from_numpy(np.maximum(rng.standard_normal((rows, pw)), 0).astype(np.float32))
    d32 = torch.from_numpy((rng.standard_normal((rows, pw)) * 1e-3).astype(np.float32))
    hb, db = h.to(torch.bfloat16), d32.to(torch.bfloat16)
    got = wide_dw.wide_dw_gemm(hb, db, in_cols)
    n = -(-rows // 8192)
    assert got.shape == (n, in_cols, pw) and got.dtype == torch.float32
    A, Z = hb[:, :in_cols].double().numpy(), db.double().numpy()
    want = dw_stage(A, Z, 8192, 32)
    for z in range(n):
        sl = slice(8192 * z, 8192 * (z + 1))
        scale = np.abs(A[sl]).T @ np.abs(Z[sl])
        exact = A[sl].T @ Z[sl]
        assert np.all(np.abs(got[z].double().numpy() - exact) <= 1e-6 * scale + 1e-30)
        assert np.all(np.abs(want[z] - exact) <= 1e-6 * scale + 1e-30)


@pytest.mark.parametrize("rows,M,N,ld", [(8192 + 1037, 40, 128, 128), (300, 296, 264, 320)])
def test_dw_f64_gap_reads_the_partials_gap(rows, M, N, ld):
    """``wide_dw.f64_gap`` (the card checks' yardstick) reads the plain
    partials of ``wide_dw.operands`` as within f32 rounding of f64 and one
    entry moved by a hundredth of its sum of |products| as that far off;
    the operands repeat from their seed."""
    from lomanerf_tpu_torch.ops import wide_dw

    h, db = wide_dw.operands(rows, ld, device="cpu")
    assert h.shape == db.shape == (rows, ld) and h.dtype == db.dtype == torch.bfloat16
    assert torch.equal(h, wide_dw.operands(rows, ld, device="cpu")[0])
    part = wide_dw.wide_dw_reference(h, db, M)[:, :, :N].contiguous()
    assert wide_dw.f64_gap(h, db, M, N, part) < 1e-6
    scale = (h[:8192, :1].double().abs().T @ db[:8192, :1].double().abs()).item()
    part[0, 0, 0] += 1e-2 * scale
    assert wide_dw.f64_gap(h, db, M, N, part) == pytest.approx(1e-2, rel=1e-3)


def test_dw_stage_refuses_what_it_does_not_take():
    from lomanerf_tpu_torch.ops import wide_dw

    h = torch.zeros(64, 128, dtype=torch.bfloat16)
    for args in ((h, h.float(), 128), (h.float(), h, 128), (h, h, 36), (h, h, 136),
                 (h, h[:32], 128), (h.t().contiguous().t(), h, 128)):
        with pytest.raises(ValueError):
            wide_dw.wide_dw_gemm(*args)


@pytest.mark.parametrize("mode", ["loma", "standard"])
@pytest.mark.parametrize("layers", [5, 8])
def test_narrow_mlps_past_shared_memory_take_the_wide_route(rng, layers, mode):
    """A 64-wide MLP whose 64-ray block of the narrow gradient kernels
    exceeds a block's shared memory at S = 64 (5x64, 8x64) routes to the
    wide kernels at pw = 128 in f32, as the JAX package sends it to its
    packed wide kernel; single64 (4x64) fits and stays narrow.  On CPU
    tensors the port's train loss and dW/db (the wide kernels' plain
    version) match the JAX core (``nerf_loss_rays`` under ``jax.grad``, f32
    HIGHEST), and the wide kernels' sequence restated in numpy at pw = 128
    equals autograd of the plain version."""
    S, n = 64, 5
    cfg = NeRFConfig(num_layers=layers, filter_size=64, num_samples=S, mode=mode)
    ws, bs = he_params(rng, tcore.mlp_layer_sizes(33, 4, layers, 64))
    params = tcore.params_from_numpy(ws, bs, "cpu")
    assert fused_nerf._route(cfg, params) == ("wide", 128)
    single = NeRFConfig.single_view_64()
    sp = tcore.params_from_numpy(*he_params(rng, tcore.mlp_layer_sizes(33, 4, 4, 64)), "cpu")
    assert fused_nerf._route(single, sp) == ("narrow", 64)
    o, d, t, dists, tgt = batch(rng, n, S)
    jp = jcore.params_from_numpy(ws, bs)
    j_loss, j_g = jax.value_and_grad(lambda p: jcore.nerf_loss_rays(
        p, *(jnp.asarray(x) for x in (o, d, t, dists, tgt)), 5, mode))(jp)
    lv = leaves(params)
    args = [torch.from_numpy(x) for x in (o, d, t, dists)]
    loss = fused_nerf.nerf_train_loss(params, *args, torch.from_numpy(tgt), cfg)
    got = torch.autograd.grad(loss, lv)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    for a, b in zip(got, [*j_g["w"], *j_g["b"]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    W, b = fused_nerf.pack_wide_params(params, 128)
    dW, db, seq_loss = kernel_sequence(
        W.double().numpy(), b.double().numpy(), t.astype(np.float64),
        dists.astype(np.float64), o.astype(np.float64), d.astype(np.float64),
        tgt.astype(np.float64), S, 40, 5, mode == "loma", lambda x: x, True, 3, 100)
    np.testing.assert_allclose(seq_loss, loss.item(), rtol=LOSS_RTOL)
    seq = fused_nerf.unpack_wide_grads(torch.from_numpy(dW), torch.from_numpy(db), params)
    for a, b in zip(seq, got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_full_params_cross_and_pack_round_trip(rng):
    """The JAX package's 8x256 full() parameters load into
    NeRFModel(NeRFConfig.full()) unchanged, route to the wide kernels at
    pw = 256, and pack_wide_params / unpack_wide_grads round-trip them."""
    jp = jcore.init_mlp(jax.random.PRNGKey(0), 33, 4, 8, 256, init="nerf")
    ws = [np.asarray(w) for w in jp["w"]]
    bs = [np.asarray(b) for b in jp["b"]]
    model = NeRFModel.from_numpy(NeRFConfig.full(), ws, bs, device="cpu")
    assert [tuple(w.shape) for w in model.w] == [w.shape for w in ws]
    for a, w in zip([*model.w, *model.b], ws + bs):
        np.testing.assert_array_equal(a.detach().numpy(), w)
    assert fused_nerf._route(NeRFConfig.full(), model.params) == ("wide", 256)
    for cdt in ("float32", "bfloat16"):
        W, b = fused_nerf.pack_wide_params(model.params, 256, cdt)
        back = fused_nerf.unpack_wide_grads(W.float(), b, model.params)
        want = [*model.params["w"], *model.params["b"]]
        for x, y in zip(back, want):
            assert x.shape == y.shape
            if cdt == "float32" or x.dim() == 1:  # biases stay f32
                assert torch.equal(x, y.detach())
            else:
                assert torch.equal(x, y.detach().to(torch.bfloat16).float())
        assert W[0, 33:].abs().max() == 0 and W[-1, :, 4:].abs().max() == 0


def test_render_image_matches_jax_model(rng):
    """NeRFModel.render_image at 8x8, 4x128/S=16 bf16 standard, against the
    JAX NeRFModel(backend="pallas").render_image; pixels do not depend on
    the chunking."""
    kw = dict(num_layers=4, filter_size=128, num_samples=16, mode="standard",
              compute_dtype="bfloat16", precision="default", init="nerf")
    ws, bs = nerf_init_params(rng, tcore.mlp_layer_sizes(33, 4, 4, 128))
    K = np.array([[1.1106, 0, 0.5], [0, 1.1106, 0.5], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    want = JModel(JConfig(**kw), backend="pallas").render_image(
        jcore.params_from_numpy(ws, bs), jnp.asarray(K), jnp.asarray(pose), 8, chunk=64)
    model = NeRFModel.from_numpy(NeRFConfig(**kw), ws, bs, device="cpu")
    with torch.no_grad():
        got = model.render_image(K, pose, 8)
        chunked = model.render_image(K, pose, 8, chunk=13)
    assert got.shape == (8, 8, 3) and torch.equal(got, chunked)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= BF16_COL_ATOL, err


def test_train_steps_match_jax(rng):
    """3 Adam steps of make_single_chip_train_step (3x128/S=8 bf16 standard,
    the fused loss) vs the JAX step through its W train kernel, from the same
    params on the same batches."""
    from lomanerf_tpu.train.steps import make_single_chip_train_step as j_make_step

    kw = dict(num_layers=3, filter_size=128, num_samples=8, mode="standard",
              compute_dtype="bfloat16", precision="default", init="nerf")
    ws, bs = nerf_init_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 128))
    batches = [batch(rng, 24, 8) for _ in range(3)]
    j_opt = optax.adam(1e-3)
    jp = jcore.params_from_numpy(ws, bs)
    js = j_opt.init(jp)
    j_step = j_make_step(JConfig(**kw), j_opt, backend="pallas", donate=False)
    model = NeRFModel.from_numpy(NeRFConfig(**kw), ws, bs, device="cpu")
    step = make_single_chip_train_step(NeRFConfig(**kw),
                                       torch.optim.Adam(model.parameters(), lr=1e-3))
    for bt in batches:
        jp, js, j_loss = j_step(jp, js, *(jnp.asarray(x) for x in bt))
        loss = step(model, *(torch.from_numpy(x) for x in bt))
        assert abs(float(loss) - float(j_loss)) <= BF16_LOSS_RTOL * abs(float(j_loss))
        # Adam moves every entry by about lr whatever its gradient, so the
        # params agree to a small multiple of lr where a gradient sign or a
        # bf16 rounding differs
        for a, w in zip([*model.w, *model.b], [*jp["w"], *jp["b"]]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=0,
                                       atol=2e-3)


def test_train_nerf_full_preset_smoke(tmp_path, monkeypatch):
    """train_nerf --preset full on the CPU (the plain version of the wide
    kernels) runs to its end with finite losses."""
    from lomanerf_tpu_torch.train import train_nerf

    monkeypatch.chdir(tmp_path)
    out = train_nerf.main([
        "--preset", "full", "--device", "cpu", "--img-size", "8",
        "--rays-per-batch", "32", "--steps", "3", "--eval-every", "2",
        "--log-dir", str(tmp_path / "logs"), "--ckpt-dir", str(tmp_path / "ck"),
        "--ckpt-every", "0"])
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    assert sorted(out["psnr"]) == [0, 2]


def test_flagship_init_density_alive():
    """The counterpart of test_train.py's flagship guard: NeRFConfig.full()
    with its init="nerf" from a torch.Generator gives every leaf a non-zero
    gradient (plain He init leaves the density head dead about half the
    time)."""
    cfg = NeRFConfig.full()
    assert cfg.init == "nerf"
    model = NeRFModel(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    o, d, t, dists, tgt = (torch.from_numpy(x) for x in batch(np.random.default_rng(0), 8,
                                                              cfg.num_samples))
    model.loss(o, d, t, dists, tgt).backward()
    for p in model.parameters():
        assert p.grad is not None and p.grad.abs().max() > 0
