"""The wide chain's exact f32 GEMM (``ops/f32_gemm``: the forms of
``csrc/nerf_wide_f32_gemm.cuh`` alone) against the JAX package and numpy,
on the CPU, and the host mirror of the kernel's staging.

On CPU tensors the wrappers run their plain versions.  Those are held to the
JAX package's own f32 layer math on the same operands: ``_mlp_forward``
(``lomanerf_tpu/ops/fused_nerf.py:79``) at ``cdt=float32`` and HIGHEST, its
``_dot_t`` (``d_h``) and ``_dot_tt`` (dW) as ``_bwd_from_dcol`` (``:168``)
takes them, and ``fused_mlp._forward_acts`` (``lomanerf_tpu/ops/
fused_mlp.py:35``, the field's layers and sigmoid head) at "highest" with
an identity encoding; and to an f64 numpy restatement.

Tolerances.  Both sides are f32 sums of the same exact products in another
order: 1e-5 of the largest entry against the JAX package (sums of up to 1024
terms), 1e-6 of the largest against f64.  The card tests
(``tests/test_torch_cuda.py``) hold the kernel to f64 and to repeat
launches bit for bit; ``chip_smoke.py``'s ``F32_DIGESTS`` pin its bits.

The staging restatement checks :func:`f32_gemm.stage_copies` (the copies of
one k-tile, ``stage_tile``) over ragged shapes: every element of a tile is
written exactly once, holds the operand's value inside its extents and zero
past them, and every 16-B copy starts 16-B aligned; that a warp's fragment
reads hit distinct banks; and that each output sums as many terms
(:func:`f32_gemm.k_terms`) as the kernel's sum order fixes (its k range
rounded up to 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lomanerf_tpu.ops import fused_mlp as j_mlp
from lomanerf_tpu.ops import fused_nerf as j_fused
from lomanerf_tpu.ops import pallas_utils as j_pu
from lomanerf_tpu_torch.ops import build, f32_gemm

HIGHEST = jax.lax.Precision.HIGHEST
JAX_ATOL = 1e-5  # of the largest entry: f32 sums of exact products, another order
F64_ATOL = 1e-6
# (rows, K, N): ragged rows, layer 0's 34 (the field) and 40 (the NeRF)
# columns, hidden layers, a 3-channel head
SHAPES = [(37, 34, 256), (200, 40, 128), (129, 256, 256), (64, 384, 384), (33, 1024, 64),
          (50, 256, 3)]


def f32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def operands(rows, K, N, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((rows, K))
    W = rng.standard_normal((K, N)) / np.sqrt(K)
    b = rng.standard_normal(N) * 0.1
    dz = rng.standard_normal((rows, N))
    mask = rng.standard_normal((rows, K))
    mask[rng.random((rows, K)) < 0.1] = 0.0
    return h, W, b, dz, mask


def assert_close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= atol * scale, f"{what}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("rows,K,N", SHAPES)
def test_layer_forms_match_the_jax_layers_and_f64(rows, K, N):
    h, W, b, _, _ = operands(rows, K, N, rows + K + N)
    got = f32_gemm.f32_layer_gemm(f32(h), f32(W), f32(b), K)
    assert got.shape == (rows, N) and got.dtype == torch.float32
    acts = j_fused._mlp_forward(jnp.asarray(h, jnp.float32),
                                [jnp.asarray(W, jnp.float32), jnp.eye(N, dtype=jnp.float32)],
                                jnp.asarray(np.stack([b, np.zeros(N)]), jnp.float32), 2,
                                HIGHEST, jnp.float32)
    assert acts[1].dtype == jnp.float32
    assert_close(got, acts[1], JAX_ATOL, "forward vs _mlp_forward")
    hf, Wf, bf = (np.asarray(f32(x), np.float64) for x in (h, W, b))
    z = hf @ Wf + bf
    assert_close(got, np.maximum(z, 0.0), F64_ATOL, "forward vs f64")
    # the field's layers: _forward_acts at "highest" on an identity encoding
    eye = jnp.eye(K, dtype=jnp.float32)
    m = jnp.asarray(np.stack([np.ones(K), np.zeros(K), np.zeros(K)]), jnp.float32)
    field = j_mlp._forward_acts(jnp.asarray(h, jnp.float32), eye, m,
                                jnp.asarray(W[None], jnp.float32),
                                jnp.asarray(b[None], jnp.float32), 1, HIGHEST)
    head = f32_gemm.f32_head_gemm(f32(h), f32(W), f32(b), K)
    assert_close(head, field[1], JAX_ATOL, "head vs _forward_acts")
    assert_close(head, 1.0 / (1.0 + np.exp(-z)), F64_ATOL, "head vs f64")
    dout = np.random.default_rng(rows).standard_normal((rows, N))
    grad = f32_gemm.f32_head_gemm(f32(h), f32(W), f32(b), K, dout=f32(dout))
    y = np.asarray(field[1], np.float64)
    assert_close(grad, np.asarray(f32(dout), np.float64) * y * (1.0 - y), JAX_ATOL,
                 "head d_z vs _bwd_kernel's")
    # K below the operands' columns reads their first K
    wide_h = torch.cat([f32(h), torch.ones((rows, 5))], 1)
    wide_W = torch.cat([f32(W), torch.ones((5, N))], 0)
    assert torch.equal(f32_gemm.f32_layer_gemm(wide_h, wide_W, f32(b), K), got)


@pytest.mark.parametrize("rows,K,N", SHAPES)
def test_dh_form_matches_the_jax_dot_t_and_f64(rows, K, N):
    _, W, _, dz, mask = operands(rows, K, N, 7 * rows + K)
    Wt = np.ascontiguousarray(W)  # (K, N): d_h = dz (rows, N) W^T, W as [in][out]
    got = f32_gemm.f32_dh_gemm(f32(dz), f32(Wt), f32(mask), N)
    assert got.shape == (rows, K)
    keep = np.asarray(f32(mask)) > 0
    jd = np.asarray(j_pu.mm_t(jnp.asarray(dz, jnp.float32), jnp.asarray(Wt, jnp.float32),
                              HIGHEST)) * keep
    assert_close(got, jd, JAX_ATOL, "d_h vs _dot_t")
    exact = np.where(keep, np.asarray(f32(dz), np.float64) @ np.asarray(f32(Wt), np.float64).T,
                     0.0)
    assert_close(got, exact, F64_ATOL, "d_h vs f64")
    assert not got.numpy()[~keep].any(), "d_h where the mask is not positive"


@pytest.mark.parametrize("rows,K,N", SHAPES)
@pytest.mark.parametrize("k_chunk", [64, 8192])
def test_dw_form_matches_the_jax_dot_tt_and_f64(rows, K, N, k_chunk):
    h, _, _, dz, _ = operands(rows, K, N, 3 * rows + N)
    got = f32_gemm.f32_dw_gemm(f32(h), f32(dz), K, k_chunk)
    assert got.shape == (-(-rows // k_chunk), K, N)
    jw = np.asarray(j_pu.mm_tt(jnp.asarray(h, jnp.float32), jnp.asarray(dz, jnp.float32),
                               HIGHEST))
    assert_close(got.sum(0), jw, JAX_ATOL, "dW vs _dot_tt")
    hf, df = np.asarray(f32(h), np.float64), np.asarray(f32(dz), np.float64)
    for z, part in enumerate(got):
        r = slice(z * k_chunk, (z + 1) * k_chunk)
        assert_close(part, hf[r].T @ df[r], F64_ATOL, f"dW partial {z} vs f64")


# ragged extents: (bx, x-major, xmax, kend) of one tile at (x0, k0)
STAGE_CASES = [(bx, xm, x0, xmax, k0, kend)
               for bx in (16, 64, 128, 256) for xm in (False, True)
               for x0, xmax in ((0, 1), (0, 37), (bx, bx + 3), (0, 10 ** 6))
               for k0, kend in ((0, 3), (0, 34), (32, 40), (8160, 8192), (64, 1000))]


@pytest.mark.parametrize("vec", [True, False])
def test_staging_fills_every_element_once_and_zero_past_the_edges(vec):
    for bx, xm, x0, xmax, k0, kend in STAGE_CASES:
        # the operand's values by (x, k), any that a copy may read
        X = lambda x, k: 1.0 + x * 4096 + k  # noqa: E731
        S = np.full(bx * f32_gemm.K_TILE, np.nan)
        writes = np.zeros(bx * f32_gemm.K_TILE, int)
        copies = f32_gemm.stage_copies(bx, xm, x0, xmax, k0, kend, vec)
        assert len(copies) * (4 if vec else 1) == bx * f32_gemm.K_TILE
        for at, x, k, nread, width in copies:
            assert width == (4 if vec else 1) and 0 <= nread <= width
            if vec:
                assert at % 4 == 0 and (k if xm else x) % 4 == 0  # 16-B aligned at both ends
            for e in range(width):
                xe, ke = (x, k + e) if xm else (x + e, k)
                S[at + e] = X(x0 + xe, k0 + ke) if e < nread else 0.0
                writes[at + e] += 1
        assert (writes == 1).all(), "an element staged twice or never"
        for x in range(bx):
            for k in range(f32_gemm.K_TILE):
                inside = x0 + x < xmax and k0 + k < kend
                want = X(x0 + x, k0 + k) if inside else 0.0
                assert S[f32_gemm.tile_index(x, k, bx, xm)] == want, (bx, xm, x, k)


@pytest.mark.parametrize("bm,bn,tm,tn", [(128, 128, 8, 8), (64, 64, 4, 4), (256, 16, 4, 4),
                                         (64, 16, 4, 4)])
def test_fragment_reads_of_a_warp_hit_distinct_banks(bm, bn, tm, tn):
    """The kernel's thread mapping: for each warp and each LDS.128 of the
    inner loop, its distinct 16-B addresses lie in distinct 16-B bank
    groups of a 128-B wavefront as far as their count allows (at most 8
    distinct addresses a read: one wavefront)."""
    ty_n, tx_n = bm // tm, bn // tn
    wx = min(tx_n, 8)
    wy = 32 // wx

    def own(t, i, T):
        return (i >> 2) * 4 * T + t * 4 + (i & 3)

    # every [x][k] row of a thread shares its swizzle, t & 7 (four_k's ua, ub)
    for t_n, t_per in ((ty_n, tm), (tx_n, tn)):
        for t in range(t_n):
            assert {own(t, i, t_n) >> 2 & 7 for i in range(t_per)} == {t & 7}
    for warp in range(ty_n * tx_n // 32):
        lanes = [(warp // (tx_n // wx) * wy + lane // wx, warp % (tx_n // wx) * wx + lane % wx)
                 for lane in range(32)]
        reads = []
        for q in range(8):
            for i in range(0, tm, 4):  # [k][m]: 4 m a read
                reads.append({4 * q * bm + own(ty, i, ty_n) for ty, _ in lanes})
            for i in range(tm):  # [m][k]: 4 k of one row a read
                reads.append({f32_gemm.tile_index(own(ty, i, ty_n), 4 * q, bm, True)
                              for ty, _ in lanes})
            for j in range(0, tn, 4):
                reads.append({4 * q * bn + own(tx, j, tx_n) for _, tx in lanes})
            for j in range(tn):
                reads.append({f32_gemm.tile_index(own(tx, j, tx_n), 4 * q, bn, True)
                              for _, tx in lanes})
        for addrs in reads:
            assert all(a % 4 == 0 for a in addrs)
            assert len(addrs) <= 8
            assert len({a // 4 % 8 for a in addrs}) == len(addrs), sorted(addrs)


def test_each_output_sums_the_terms_the_fma_kernel_gave_it():
    for K in (1, 3, 8, 31, 32, 33, 34, 40, 64, 255, 256, 1000, 1024, 8193, 65536):
        for k_chunk in {K, 8, 32, 40, 8192}:
            for kbeg in range(0, K, k_chunk):
                kend = min(K, kbeg + k_chunk)
                assert f32_gemm.k_terms(kbeg, kend) == (kend - kbeg + 7) // 8 * 8, (K, k_chunk)


def test_tile_shapes_by_form():
    assert f32_gemm.tile_shape("forward", 262144, 256, 256, 256) == (128, 128, 8, 8)
    assert f32_gemm.tile_shape("head", 262144, 3, 256, 256) == (256, 16, 4, 4)
    assert f32_gemm.tile_shape("dW", 256, 3, 262144, 8192) == (64, 16, 4, 4)
    # the field's dW at pw 256: 2 x 2 x 32 = 128 blocks of 128 x 128 keep
    # 128 of 132 SMs busy; its encoding's (34 rows) 1 x 2 x 32 = 64 would
    # not, 1 x 4 x 32 = 128 of 64 x 64 (four an SM) take it
    assert f32_gemm.tile_shape("dW", 256, 256, 262144, 8192) == (128, 128, 8, 8)
    assert f32_gemm.tile_shape("dW", 34, 256, 262144, 8192) == (64, 64, 4, 4)
    assert f32_gemm.tile_shape("dW", 1024, 1024, 419200, 8192) == (128, 128, 8, 8)


def refusals():
    h, W, b, dz, mask = (f32(x) for x in operands(16, 40, 128, 0))
    return {
        "1-D operand": (f32_gemm.f32_layer_gemm, (h[0], W, b, 40)),
        "K past the columns": (f32_gemm.f32_layer_gemm, (h, W, b, 41)),
        "K zero": (f32_gemm.f32_layer_gemm, (h, W, b, 0)),
        "bias not (n,)": (f32_gemm.f32_layer_gemm, (h, W, b[:64], 40)),
        "bf16 operand": (f32_gemm.f32_layer_gemm, (h.to(torch.bfloat16), W, b, 40)),
        "strided operand": (f32_gemm.f32_layer_gemm, (torch.cat([h, h], 1)[:, ::2], W, b, 40)),
        "no rows": (f32_gemm.f32_layer_gemm, (h[:0], W, b, 40)),
        "cotangent not (rows, n)": (f32_gemm.f32_head_gemm, (h, W, b, 40, dz[:8])),
        "mask not (rows, n)": (f32_gemm.f32_dh_gemm, (dz, W, mask[:8], 128)),
        "d_h K past W": (f32_gemm.f32_dh_gemm, (dz, W, mask, 129)),
        "f64 W": (f32_gemm.f32_dh_gemm, (dz, W.double(), mask, 128)),
        "dW rows apart": (f32_gemm.f32_dw_gemm, (h, dz[:8], 40, 8192)),
        "dW M past h": (f32_gemm.f32_dw_gemm, (h, dz, 41, 8192)),
        "dW no k_chunk": (f32_gemm.f32_dw_gemm, (h, dz, 40, 0)),
    }


@pytest.mark.parametrize("case", list(refusals()))
def test_wrappers_refuse_what_the_kernel_does_not_take(case):
    fn, args = refusals()[case]
    with pytest.raises(ValueError):
        fn(*args)


def test_cpu_calls_launch_nothing_and_the_entry_points_are_bound():
    h, W, b, dz, mask = (f32(x) for x in operands(37, 40, 128, 1))
    before = dict(f32_gemm.launches)
    a = f32_gemm.f32_layer_gemm(h, W, b, 40)
    assert torch.equal(a, f32_gemm.layer_reference(h, W, b, 40))
    f32_gemm.f32_head_gemm(h, W, b, 40, dout=dz)
    f32_gemm.f32_dh_gemm(dz, W, mask, 128)
    f32_gemm.f32_dw_gemm(h, dz, 40, 16)
    assert f32_gemm.launches == before
    assert set(f32_gemm.launches) == {f"f32_{n}_gemm" for n in ("layer", "dh", "dw", "head")}
    assert len(build.SIGNATURES["wide_f32_gemm"]) == 14
    assert (build.CSRC / "wide_f32_gemm.cu").exists()
    assert (build.CSRC / "nerf_wide_f32_gemm.cuh").exists()


def test_fit_step_runs_the_configs_precision_tier(monkeypatch):
    """``make_image_fit_step``'s fused loss passes the config's tier to
    ``field_forward`` (as the JAX step passes ``cfg.precision``,
    ``lomanerf_tpu/train/steps.py:93``), so that a "highest" field fits on
    the f32 GEMM."""
    from lomanerf_tpu_torch.models import ImageFieldConfig
    from lomanerf_tpu_torch.ops import fused_mlp
    from lomanerf_tpu_torch.train import steps

    seen = []

    def spy(params, coords, nf, out=3, precision="high"):
        seen.append(precision)
        return fused_mlp.field_forward_reference(params, coords, nf, out)

    monkeypatch.setattr(fused_mlp, "field_forward", spy)
    rng = np.random.default_rng(0)
    params = {"w": [f32(rng.standard_normal((22, 16))), f32(rng.standard_normal((16, 3)))],
              "b": [f32(np.zeros(16)), f32(np.zeros(3))]}
    coords, target = f32(rng.random((8, 2))), f32(rng.random((8, 3)))
    for tier in ("high", "highest", "default"):
        cfg = ImageFieldConfig(num_layers=2, precision=tier)
        steps.image_fit_loss_fn(params, coords, target, cfg, "fused")
    assert seen == ["high", "highest", "default"]


def test_card_probe_names_the_f32_gemm_forms():
    """``card_probe`` reads the epilogue of ``gemm_f32_kernel`` (its last
    template argument) in the NeRF step's families and the wide field's
    labels."""
    from lomanerf_tpu_torch.scripts import card_probe

    def name(tile, epi):
        return f"void wide::(anonymous namespace)::gemm_f32_kernel<{tile}, {epi}>(float const*)"
    assert card_probe.family(name("128, 128, 8, 8, false, false", 0), "kernel") == "forward"
    assert card_probe.family(name("128, 128, 8, 8, false, true", 1), "kernel") == "d_h"
    assert card_probe.family(name("64, 64, 4, 4, true, false", 2), "kernel") == "dW"
    assert card_probe.kernel_key(name("64, 64, 4, 4, true, false", 2)) == \
        "gemm_f32_kernel kEpiPartial"
    state = {}
    labels = [card_probe.wide_field_label(n, "kernel", state) for n in (
        "encode_kernel", name("128, 128, 8, 8, false, false", 0),
        name("256, 16, 4, 4, false, false", 3), name("256, 16, 4, 4, false, false", 4),
        name("256, 16, 4, 4, true, false", 2))]
    assert labels == ["fwd: encode", "fwd: layer 0", "fwd: head", "bwd: head d_z",
                      "bwd: dW layer 1"]
    assert card_probe.nerf_config("c4f32").compute_dtype == "float32"
    assert card_probe.CONFIG_RAYS["c4f32"] == 4096
