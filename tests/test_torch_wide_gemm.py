"""The wide chain's bf16 layer GEMM (``ops/wide_gemm``: the forward layer
and ``d_h`` of ``csrc/nerf_wide_layer_gemm.cuh`` alone) against the JAX
package and against numpy, on the CPU.

On CPU tensors the wrappers run their plain versions
(``wide_gemm.layer_reference``, ``wide_gemm.dh_reference``).  Those are
held to the JAX package's own layer products on the same bf16 operands:
``_mlp_forward`` (``lomanerf_tpu/ops/fused_nerf.py:79``, two layers at
``cdt=bfloat16``; its ``acts[1]`` is the forward layer) and the masked
``_dot_t`` of ``_bwd_from_dcol`` (``:218``), and to a numpy restatement of
the kernel's order: each 64-deep stage summed in f64 and rounded to f32,
the stages added in ascending order in f32, then the epilogue.  The
restatement rounds each stage's sum to nearest where the card's tensor
core, inside a stage, truncates; the one-step tolerance below covers that.

Tolerances.  The products of two bf16 values are exact in f32; only the
order of the f32 sums differs, so a bf16 output may round to the
neighbouring value: one bf16 rounding step of the entry (2^(e-8) for an
entry in [2^(e-1), 2^e)), plus 1e-5 of the largest entry where a
pre-activation within f32 rounding of 0 lands on the other side of the
ReLU.  The f32 ``d_h`` within 1e-5 of its largest entry; its 128-row
column partials within one f32 rounding of the f64 sums.  The card tests
(``tests/test_torch_cuda.py``) hold the kernel to f64 and to repeat
launches bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lomanerf_tpu.ops import fused_nerf as j_fused
from lomanerf_tpu_torch.ops import build, wide_gemm

K_STEP = 64  # the kernel's promotion depth: a stage
FLIP_ATOL = 1e-5  # of the largest entry: a ReLU or mask decision at f32 rounding of 0
DH_ATOL = 1e-5  # of the largest |d_h|: f32 sums of exact products in another order
# (rows, K, pw): ragged rows, layer 0's 40 columns, hidden layers at pw 128-384
SHAPES = [(37, 40, 128), (200, 128, 128), (130, 40, 256), (64, 256, 256), (37, 384, 384),
          (129, 96, 384)]


def bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def operands(rows, pw, seed):
    """bf16 h (an encoding's signs), dz, a mask with exact zeros, W scaled
    as an init would, and an f32 bias, from numpy."""
    rng = np.random.default_rng(seed)
    h = bf16(rng.standard_normal((rows, pw)))
    dz = bf16(rng.standard_normal((rows, pw)))
    m = rng.standard_normal((rows, pw))
    m[rng.random((rows, pw)) < 0.1] = 0.0
    W = bf16(rng.standard_normal((pw, pw)) / np.sqrt(pw))
    b = torch.from_numpy((rng.standard_normal(pw) * 0.1).astype(np.float32))
    return h, dz, bf16(m), W, b


def bf16_step(x):
    """The spacing of bf16 values at each |x| (its rounding step)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def assert_bf16_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = bf16_step(np.maximum(np.abs(got), np.abs(want))) + FLIP_ATOL * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{what}: {bad.sum()} entries past one bf16 step, worst " \
                          f"{np.abs(got - want).max():.3e}"


def kernel_order(a, B, K):
    """a[:, :K] B[:K] in the kernel's order: each 64-deep stage's exact
    products summed in f64, rounded to f32, the stages added in ascending
    order in f32 (the first onto 0)."""
    a, B = np.asarray(a.float(), np.float64), np.asarray(B.float(), np.float64)
    acc = np.zeros((a.shape[0], B.shape[1]), np.float32)
    for k0 in range(0, K, K_STEP):
        k1 = min(K, k0 + K_STEP)
        acc = acc + (a[:, k0:k1] @ B[k0:k1]).astype(np.float32)
    return acc


@pytest.mark.parametrize("rows,K,pw", SHAPES)
def test_forward_form_matches_the_jax_layer_and_numpy(rows, K, pw):
    h, _, _, W, b = operands(rows, pw, rows + K + pw)
    got = wide_gemm.wide_layer_gemm(h, W, b, K)
    assert got.shape == (rows, pw) and got.dtype == torch.bfloat16
    jw = [jnp.asarray(W[:K].float().numpy()), jnp.asarray(W.float().numpy())]
    jb = jnp.asarray(np.stack([b.numpy(), b.numpy()]))
    acts = j_fused._mlp_forward(jnp.asarray(h[:, :K].float().numpy()), jw, jb, 2,
                                jax.lax.Precision.HIGHEST, jnp.bfloat16)
    assert acts[1].dtype == jnp.bfloat16
    assert_bf16_close(got.float(), np.asarray(acts[1], np.float32), "plain vs _mlp_forward")
    order = kernel_order(h, W, K) + b.numpy()
    want = bf16(np.maximum(order, np.float32(0.0))).float()
    assert_bf16_close(got.float(), want, "plain vs the kernel's order")
    exact = np.maximum(np.asarray(h[:, :K].double()) @ np.asarray(W[:K].double())
                       + b.double().numpy(), 0.0)
    assert_bf16_close(want, exact, "the kernel's order vs f64")


@pytest.mark.parametrize("rows,K,pw", SHAPES)
def test_dh_form_matches_the_jax_layer_and_numpy(rows, K, pw):
    _, dz, mask, W, _ = operands(rows, pw, rows * K + pw)
    d, db, _ = wide_gemm.wide_dh_gemm(dz, W, mask, K)
    assert d.shape == db.shape == (rows, pw)
    assert d.dtype == torch.float32 and db.dtype == torch.bfloat16
    assert torch.equal(db, d.to(torch.bfloat16))
    keep = mask.float().numpy() > 0
    jd = j_fused._dot_t(jnp.asarray(dz[:, :K].float().numpy(), jnp.bfloat16),
                        jnp.asarray(W[:, :K].float().numpy(), jnp.bfloat16),
                        jax.lax.Precision.HIGHEST)
    jd = np.asarray(jd * jnp.asarray(keep, jnp.float32))
    order = np.where(keep, kernel_order(dz, W.T.contiguous(), K), 0.0)
    exact = np.where(keep, np.asarray(dz[:, :K].double()) @ np.asarray(W[:, :K].double()).T,
                     0.0)
    scale = np.abs(exact).max()
    for what, want in (("_bwd_from_dcol's d_h", jd), ("the kernel's order", order),
                       ("f64", exact)):
        err = np.abs(d.double().numpy() - want).max()
        assert err <= DH_ATOL * scale, f"d_h vs {what}: {err:.3e} of {scale:.3e}"
    assert not (d.numpy()[~keep]).any(), "d_h where the mask is not positive"
    assert_bf16_close(db.float(), bf16(order).float(), "the bf16 copy vs the kernel's order")


@pytest.mark.parametrize("pw", [128, 256])
@pytest.mark.parametrize("rows", [300, 8192 + 1037, 128, 1])
def test_dh_form_column_partials_sum_each_128_row_tile(rows, pw):
    """The d_h form's column partials (db's, in place of an f32 d_z): one
    row per 128-row tile of d_h, ragged rows counting as 0; each tile's row
    the f64 column sum of its rows of the masked f32 d_h within f32
    rounding, and their total the whole column sum."""
    _, dz, mask, W, _ = operands(rows, pw, rows + pw)
    d, _, part = wide_gemm.wide_dh_gemm(dz, W, mask, pw)
    tiles = -(-rows // wide_gemm.TILE_ROWS)
    assert part.shape == (tiles, pw) and part.dtype == torch.float32
    d64 = d.double().numpy()
    for i in range(tiles):
        rows_i = d64[wide_gemm.TILE_ROWS * i:wide_gemm.TILE_ROWS * (i + 1)]
        want, scale = rows_i.sum(0), np.abs(rows_i).sum(0)
        gap = np.abs(part[i].double().numpy() - want)
        assert (gap <= 2.0 ** -24 * (np.abs(want) + 1e-30)).all(), f"tile {i}: {gap.max():.3e}"
        assert (gap <= 1e-7 * scale + 1e-30).all()
    total, scale = d64.sum(0), np.abs(d64).sum(0)
    assert (np.abs(part.double().numpy().sum(0) - total) <= 1e-6 * scale + 1e-30).all()


def refusals():
    h, dz, mask, W, b = operands(16, 128, 0)
    fwd, dh = wide_gemm.wide_layer_gemm, wide_gemm.wide_dh_gemm
    return {
        "1-D operand": (fwd, (h[0], W, b, 40)),
        "no rows": (fwd, (h[:0], W, b, 40)),
        "K past pw": (fwd, (h, W, b, 136)),
        "K not a multiple of 8": (fwd, (h, W, b, 36)),
        "W not (pw, pw)": (fwd, (h, W[:64], b, 40)),
        "bias not (pw,)": (fwd, (h, W, b[:64], 40)),
        "f32 operand": (fwd, (h.float(), W, b, 40)),
        "bf16 bias": (fwd, (h, W, b.to(torch.bfloat16), 40)),
        "strided operand": (fwd, (torch.cat([h, h], 1)[:, ::2], W, b, 40)),
        "mask not (rows, pw)": (dh, (dz, W, mask[:8], 128)),
        "f32 mask": (dh, (dz, W, mask.float(), 128)),
        "f32 W": (dh, (dz, W.float(), mask, 128)),
    }


@pytest.mark.parametrize("case", list(refusals()))
def test_wrappers_refuse_what_the_kernel_does_not_take(case):
    fn, args = refusals()[case]
    with pytest.raises(ValueError):
        fn(*args)


def test_cpu_calls_launch_nothing_and_the_entry_points_are_bound():
    h, dz, mask, W, b = operands(37, 128, 1)
    before = dict(wide_gemm.launches)
    wide_gemm.wide_layer_gemm(h, W, b, 40)
    wide_gemm.wide_layer_gemm(h, W, b, 128)
    wide_gemm.wide_dh_gemm(dz, W, mask, 128)
    assert wide_gemm.launches == before
    assert set(wide_gemm.launches) == {"wide_layer_gemm", "wide_dh_gemm"}
    assert len(build.SIGNATURES["wide_layer_gemm"]) == 12


def test_gemm_variants_edit_the_current_source():
    """Every variant of ``scripts/gemm_variants`` applies to the layer GEMM's
    source as it stands (each edit matches as often as it names), the first
    is the source unchanged, and each changes what it names; the script
    refuses to run without a card."""
    from lomanerf_tpu_torch.scripts import gemm_variants

    sources = {name: gemm_variants.patched(edits)
               for name, (edits, _) in gemm_variants.VARIANTS.items()}
    assert sources.pop("as is") == gemm_variants.HEADER.read_text()
    assert len(set(sources.values())) == len(sources)
    assert all(src != gemm_variants.HEADER.read_text() for src in sources.values())
    with pytest.raises(SystemExit):
        gemm_variants.patched([("no such line", "", 1)])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            gemm_variants.main([])


def test_dw_variants_edit_the_current_source():
    """Every variant of ``scripts/dw_variants`` applies to the dW stage's
    source as it stands (each edit matches as often as it names), the first
    is the source unchanged, and each changes what it names; the script
    refuses to run without a card."""
    from lomanerf_tpu_torch.scripts import dw_variants

    sources = {name: dw_variants.patched(edits)
               for name, (edits, _) in dw_variants.VARIANTS.items()}
    assert sources.pop("as is") == dw_variants.HEADER.read_text()
    assert len(set(sources.values())) == len(sources)
    assert all(src != dw_variants.HEADER.read_text() for src in sources.values())
    with pytest.raises(SystemExit):
        dw_variants.patched([("no such line", "", 1)])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            dw_variants.main([])


def test_smoke_seeds_refuses_without_a_card():
    """``scripts/smoke_seeds`` (chip_smoke phase 24's first check at other
    seeds) parses its seeds and refuses to run without a card."""
    from lomanerf_tpu_torch.scripts import smoke_seeds

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            smoke_seeds.main(["--seeds", "31,32"])
