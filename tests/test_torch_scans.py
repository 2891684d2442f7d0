"""The port's segmented scans against the JAX package's, on the CPU.

The same numpy column goes through ``lomanerf_tpu.ops.pallas_utils``'s
``seg_inclusive_cumprod``, ``seg_suffix_sum`` and ``seg_shift_down`` inside
an interpret-mode ``pallas_call``, as ``tests/test_pallas_kernels.py``
runs them, and through ``lomanerf_tpu_torch.ops.scans`` on CPU tensors
(the plain versions of the ``seg_scans`` kernel).  The JAX scans run in
Hillis-Steele order and the port's one value after another, so they agree
to rounding, not bit for bit: rtol 1e-5 (the JAX test's) with atol 1.2e-38
(the smallest normal f32), so that a product that underflows counts as
equal; the shift moves values and is exact.  ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` run the kernel itself on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lomanerf_tpu.ops import pallas_utils as pu
from lomanerf_tpu_torch.ops import scans

TINY = float(np.finfo(np.float32).tiny)


def jax_scan(fn, x, *args):
    """``fn(x, *args)`` inside a trivial interpret-mode kernel, so that
    ``pltpu.roll`` is legal (test_pallas_kernels.py:41-53)."""
    x = jnp.asarray(x)

    def k(x_ref, o_ref):
        o_ref[...] = fn(x_ref[...], *args)

    return np.asarray(pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), interpret=True)(x))


def column(rng, R, S, kind):
    """(R * S, 1) f32: uniform [0.5, 1.5) (the JAX test's), or in
    [1e-10, 1], mostly near 1 (``10^(-10 u^6)``, as c = exp(-sigma dist) +
    1e-10 runs)."""
    u = rng.random((R * S, 1))
    return (u + 0.5 if kind == "unit" else 10.0 ** (-10.0 * u ** 6)).astype(np.float32)


CASES = {"R4_S6_unit": (4, 6, "unit"), "R8_S128_tiny": (8, 128, "tiny")}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("op", ["cumprod", "suffix", "shift_fill0", "shift_fill1"])
def test_scans_match_jax(rng, case, op):
    R, S, kind = CASES[case]
    x = column(rng, R, S, kind)
    t = torch.from_numpy(x)
    if op == "cumprod":
        got, want = scans.seg_inclusive_cumprod(t, S), jax_scan(pu.seg_inclusive_cumprod, x, S)
    elif op == "suffix":
        got, want = scans.seg_suffix_sum(t, S), jax_scan(pu.seg_suffix_sum, x, S)
    else:
        fill = float(op[-1])
        got, want = scans.seg_shift_down(t, S, fill), jax_scan(pu.seg_shift_down, x, S, fill)
    assert got.shape == t.shape and got.dtype == torch.float32
    if op.startswith("shift"):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=TINY)
    if kind == "tiny" and op == "cumprod":
        assert (want < TINY).any() and (want >= TINY).any()  # both regimes present


def test_scans_take_flat_columns_and_refuse_ragged_ones(rng):
    """``(R * S,)`` columns give the ``(R * S, 1)`` results flattened; a
    column that is not whole segments, or not a column, raises."""
    x = torch.from_numpy(column(rng, 3, 5, "unit"))
    for fn, args in ((scans.seg_inclusive_cumprod, ()), (scans.seg_suffix_sum, ()),
                     (scans.seg_shift_down, (1.0,))):
        flat = fn(x.reshape(-1), 5, *args)
        assert flat.shape == (15,)
        assert torch.equal(flat, fn(x, 5, *args).reshape(-1))
        with pytest.raises(ValueError):
            fn(x, 4, *args)
        with pytest.raises(ValueError):
            fn(x.reshape(3, 5), 5, *args)


def staged_map(n_rows, S):
    """The staged kernel's copies, restated from ``seg_scans.cu`` with the
    launch of ``scans.scan_plan``: ``[(run's first value, tile positions,
    values of the run)]`` a warp, each lane stepping g by 32 and carrying
    its (segment, sample) along as the kernel does."""
    plan = scans.scan_plan(n_rows, S)
    n_seg, P = n_rows // S, plan.stride
    q, rem = divmod(32, S)
    warps = []
    for w in range(plan.blocks * plan.threads // 32):
        seg0 = w * 32
        if seg0 >= n_seg:
            continue
        E = min(32, n_seg - seg0) * S
        lane = np.arange(32)
        r, s = lane // S, lane % S
        pos, vals = [], []
        for g0 in range(0, E, 32):
            g = g0 + lane
            live = g < E
            pos.append((g + r * (P - S))[live])
            vals.append(g[live])
            r, s = r + q, s + rem
            r, s = np.where(s >= S, r + 1, r), np.where(s >= S, s - S, s)
        warps.append((seg0 * S, np.concatenate(pos), np.concatenate(vals)))
    return plan, warps


PLAN_CASES = [(1, 1), (3, 5), (33, 30), (1037, 30), (64, 64), (37, 64), (5, 128),
              (100, 6), (2, 1815), (3, 1816)]


@pytest.mark.parametrize("R,S", PLAN_CASES)
def test_scan_plan_covers_every_value_once(R, S):
    """Every value of the column is copied into the tiles once and out once,
    to the place ``r * P + s`` of its segment and sample, within the
    block's shared memory; the grid covers every segment, with no block
    beyond it.  Past one run's fit, the direct walk: a thread a segment."""
    plan, warps = staged_map(R * S, S)
    assert (plan.blocks - 1) * plan.threads < R <= plan.blocks * plan.threads
    if plan.route == "direct":
        assert S > 1815 and 32 * (S | 1) * 4 > scans.SCAN_SMEM_MAX and plan.smem_bytes == 0
        return
    assert plan.stride == S | 1 and plan.stride % 2 == 1
    assert plan.smem_bytes == plan.threads * plan.stride * 4 <= scans.SCAN_SMEM_MAX
    seen = np.zeros(R * S, dtype=int)
    for base, pos, vals in warps:
        seen[base + vals] += 1
        r, s = np.divmod(vals, S)
        np.testing.assert_array_equal(pos, r * plan.stride + s)
        assert len(set(pos.tolist())) == len(pos) and pos.max() < 32 * plan.stride
    assert (seen == 1).all()


def staged_walk(flat, offset, R, S, op, fill=1.0):
    """The staged kernel on the column ``flat[offset:offset + R * S]``,
    restated in numpy f32: each run copied into a tile by
    :func:`staged_map`, the 32 lanes walking their segments there side by
    side in seg_scan.cuh's order, the run copied back."""
    plan, warps = staged_map(R * S, S)
    out = np.full(R * S, np.nan, dtype=np.float32)
    for base, pos, vals in warps:
        tile = np.full(32 * plan.stride, np.nan, dtype=np.float32)
        tile[pos] = flat[offset + base + vals]
        seg = tile.reshape(32, plan.stride)
        if op == "cumprod":
            acc = np.ones(32, dtype=np.float32)
            for s in range(S):
                acc = acc * seg[:, s]
                seg[:, s] = acc
        elif op == "suffix":
            acc = np.zeros(32, dtype=np.float32)
            for s in range(S - 1, -1, -1):
                acc = acc + seg[:, s]
                seg[:, s] = acc
        else:
            seg[:, 1:S] = seg[:, :S - 1].copy()
            seg[:, 0] = fill
        out[base + vals] = tile[pos]
    return out


@pytest.mark.parametrize("R,S,offset,kind", [(4, 6, 0, "unit"), (1037, 30, 1, "tiny"),
                                             (37, 64, 0, "tiny"), (1024, 128, 3, "tiny"),
                                             (33, 1815, 0, "unit")])
@pytest.mark.parametrize("op", ["cumprod", "suffix", "shift"])
def test_staged_walk_gives_accumulate_bits(rng, R, S, offset, kind, op):
    """The staged tiles walked in seg_scan.cuh's order give numpy's f32
    sequential accumulate bit for bit (subnormal products included): the
    product along a segment, the sum along the reversed one; the shift
    moves values.  A column at a storage offset reads the same values."""
    x = column(rng, R, S, kind).reshape(R, S)
    flat = np.concatenate([np.full(offset, np.nan, np.float32), x.ravel()])
    got = staged_walk(flat, offset, R, S, op).reshape(R, S)
    if op == "cumprod":
        want = np.multiply.accumulate(x, axis=1)
    elif op == "suffix":
        want = np.add.accumulate(x[:, ::-1], axis=1)[:, ::-1]
    else:
        want = np.concatenate([np.ones((R, 1), np.float32), x[:, :-1]], axis=1)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if kind == "tiny" and op == "cumprod" and S >= 64:
        assert ((want > 0) & (want < TINY)).any()  # subnormal products walked too


def test_scan_probe_stride_edit_matches_the_source():
    """``card_probe --what scans`` times the staged kernel at tile stride S
    by one textual edit of ``seg_scans.cu``; the edit must still apply."""
    from lomanerf_tpu_torch.ops import build
    from lomanerf_tpu_torch.scripts import card_probe, variants

    src = variants.patch(build.CSRC / "seg_scans.cu", [card_probe.SCAN_STRIDE_EDIT], "test")
    assert "const int P = S;" in src and "const int P = S | 1;" not in src
