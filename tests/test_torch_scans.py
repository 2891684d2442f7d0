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
