"""The grid-overhead probe (the port of ``scripts/tpu_grid_overhead.py``'s
kernel) on the CPU.

``probe.grid_sum`` on CPU tensors runs its plain version, the per-tile sums
of the first ``(cols // block) * block`` columns (like the JAX script's
``n_tiles = rows // block``); it is held to numpy's f64 sum within 1e-6 of
the sum of |x|.  The sweep's CLI runs with ``--device cpu`` and prints a
line per sweep entry.  ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
run the kernel on the card.
"""

import numpy as np
import pytest
import torch

from lomanerf_tpu_torch.ops import probe
from lomanerf_tpu_torch.scripts import grid_overhead


@pytest.mark.parametrize("rows", [15360, 16000])
@pytest.mark.parametrize("block", [3840, 15360])
def test_grid_sum_reference_matches_f64(rows, block):
    x = np.random.default_rng(rows + block).standard_normal((8, rows)).astype(np.float32)
    cols = rows // block * block  # 16000 rows leave a remainder out
    want = np.sum(x[:, :cols], dtype=np.float64)
    scale = np.sum(np.abs(x[:, :cols]), dtype=np.float64)
    got = probe.grid_sum(torch.from_numpy(x), block)
    assert got.ndim == 0 and got.dtype == torch.float32
    assert abs(got.item() - want) <= 1e-6 * scale
    assert torch.equal(got, probe.grid_sum_reference(torch.from_numpy(x), block))
    if cols < rows:  # the remainder is not summed
        assert abs(got.item() - np.sum(x, dtype=np.float64)) > 1e-6 * scale


THREADS = 256  # grid_sum.cu: kThreads


def block_total(v):
    """grid_sum.cu's block_total in f32: a shuffle tree in each warp (lane l
    adds lane l + 16, then + 8, ...), then the same tree over the warps'
    sums, zero-padded to 32."""
    def tree(a):
        while a.shape[-1] > 1:
            half = a.shape[-1] // 2
            a = a[..., :half] + a[..., half:]
        return a[..., 0]

    warps = tree(v.reshape(-1, 32))
    return tree(np.concatenate([warps, np.zeros(32 - warps.size, np.float32)]))


def kernel_order_sum(x, block, vec=True):
    """numpy (f32) restatement of grid_sum.cu's fixed order: in each tile,
    thread t adds columns t, t + 256, ... in order (float4 columns with
    ``vec``, their 8 rows in order, each float4's 4 values in order), then
    the block's tree; the last block adds the partials p = t, t + 256, ...
    per thread, then the tree."""
    n_tiles = x.shape[1] // block
    parts = np.zeros(n_tiles, np.float32)
    width = 4 if vec else 1
    n_cols = block // width
    for tile in range(n_tiles):
        cols = x[:, tile * block:(tile + 1) * block].reshape(8, n_cols, width)
        acc = np.zeros(THREADS, np.float32)
        for i0 in range(0, n_cols, THREADS):
            idx = np.arange(i0, min(i0 + THREADS, n_cols))
            for r in range(8):
                for q in range(width):
                    acc[idx - i0] += cols[r, idx, q]
        parts[tile] = block_total(acc)
    acc = np.zeros(THREADS, np.float32)
    for p0 in range(0, n_tiles, THREADS):
        idx = np.arange(p0, min(p0 + THREADS, n_tiles))
        acc[idx - p0] += parts[idx]
    return block_total(acc)


@pytest.mark.parametrize("n_tiles,block,vec", [(1, 3840, True), (7, 3840, True),
                                               (13, 1024, True), (300, 64, True),
                                               (5, 1003, False)])
def test_grid_sum_kernel_order_matches_plain(n_tiles, block, vec):
    """The kernel's fixed-order reduction restated in numpy (tile sums, then
    the last block's sum of the partials) against ``grid_sum_reference``
    within 1e-6 of the sum of |x|, at ragged tile counts (one tile, fewer
    and more than a block's threads), with a ragged remainder column."""
    x = np.random.default_rng(n_tiles).standard_normal((8, n_tiles * block + 3)).astype(
        np.float32)
    got = kernel_order_sum(x, block, vec)
    assert got.dtype == np.float32
    want = probe.grid_sum_reference(torch.from_numpy(x), block).item()
    scale = np.sum(np.abs(x[:, :n_tiles * block]), dtype=np.float64)
    assert abs(float(got) - want) <= 1e-6 * scale
    assert abs(float(got) - np.sum(x[:, :n_tiles * block], dtype=np.float64)) <= 1e-6 * scale


def test_grid_sum_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):
        probe.grid_sum(torch.zeros(7, 64), 8)
    with pytest.raises(ValueError):
        probe.grid_sum(torch.zeros(8, 64), 0)
    with pytest.raises(ValueError):
        probe.grid_sum(torch.zeros(8, 64), 8, n_dummy=-1)


def test_grid_overhead_cli_on_cpu(capsys):
    """Every sweep entry prints a line (the two blocks wider than 15,360
    rows as skipped), sweep B its slope; the sums pass the script's own
    f64 and repeat checks."""
    res = grid_overhead.main(["--device", "cpu", "--rows", "15360", "--reps", "1"])
    lines = capsys.readouterr().out.splitlines()
    a = [line for line in lines if line.startswith("A ")]
    b = [line for line in lines if line.startswith("B launches")]
    assert len(a) == len(grid_overhead.SWEEP_A) and len(b) == len(grid_overhead.SWEEP_B)
    assert sum("skipped" in line for line in a) == 2
    assert any(line.startswith("B slope") for line in lines)
    assert [r["blocks"] for r in res["A"]] == [4, 4, 1]
    assert [r["launches"] for r in res["B"]] == list(grid_overhead.SWEEP_B)
    assert all(r["err"] <= 1e-6 for r in res["A"] + res["B"])
    assert "ms" not in res["A"][0]  # no device time on the CPU


def test_card_probe_sorts_kernels_into_families():
    """``scripts/card_probe.py`` puts each kernel of a trace in a family by
    its demangled name (the GEMMs by their epilogue, the fused MLP apart
    from the forward GEMMs it replaced in the render) and names it per
    frame, and refuses to run without a card."""
    from lomanerf_tpu_torch.scripts import card_probe

    gemm = "void wide::(anonymous namespace)::gemm{}<__nv_bfloat16, float, true, false, {}>(int)"
    assert card_probe.family(gemm.format("_mma_kernel", 2), "kernel") == "dW"
    assert card_probe.family(gemm.format("_mma_kernel", 1), "kernel") == "d_h"
    assert card_probe.family(gemm.format("_f32_kernel", 0), "kernel") == "forward"
    assert card_probe.family("void wide::(anonymous namespace)::dw_wgmma_kernel<8>"
                             "(CUtensorMap_st, CUtensorMap_st, int)", "kernel") == "dW"
    for name, fam in (("composite_kernel<__nv_bfloat16, 1, false>", "compositing"),
                      ("colsum_kernel(float const*)", "partial and column sums"),
                      ("sum_partials_kernel(float const*)", "partial and column sums"),
                      ("encode_kernel<float, true>", "encoding"),
                      ("multi_tensor_apply_kernel<Adam>", "other")):
        assert card_probe.family(name, "kernel") == fam
    mlp = ("void wide::(anonymous namespace)::mlp_wgmma_kernel<256, false>(CUtensorMap_st, "
           "CUtensorMap_st, float const*, int)")
    assert card_probe.family(mlp, "kernel") == "fused MLP"
    assert card_probe.kernel_key(mlp) == "mlp_wgmma_kernel"
    assert card_probe.kernel_key(gemm.format("_mma_kernel", 0)) == "gemm_mma_kernel kEpiBiasRelu"
    layer = ("void wide::(anonymous namespace)::layer_wgmma_kernel<{}, 4>(CUtensorMap_st, "
             "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
             "int, int, int)")
    for epi, fam, key in ((0, "forward", "kEpiBiasRelu"), (1, "d_h", "kEpiMask")):
        assert card_probe.family(layer.format(epi), "kernel") == fam
        assert card_probe.kernel_key(layer.format(epi)) == f"layer_wgmma_kernel {key}"
    c4 = card_probe.nerf_config("c4")
    assert (c4.num_layers, c4.filter_size, c4.compute_dtype) == (8, 1024, "bfloat16")
    assert card_probe.family("Memset (Device)", "gpu_memset") == "memset and copy"
    walk = ("void nerf::(anonymous namespace)::nerf_grad_kernel<32, true, false>(float const*, "
            "int, int)")
    assert card_probe.small_family(walk, "kernel") == "nerf_grad_kernel"
    assert card_probe.kernel_key(walk) == "nerf_grad_kernel"
    blocks = "(anonymous namespace)::sum_block_partials(float const*, int, int, float*)"
    assert card_probe.small_family(blocks, "kernel") == "sum_block_partials"
    assert card_probe.kernel_key(blocks) == "sum_block_partials"
    adam = "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>(...)"
    assert card_probe.small_family(adam, "kernel") == "Adam"
    assert card_probe.small_family("Memset (Device)", "gpu_memset") == "other"
    for args in (["grid_sum"], ["frame"], ["small"], ["flagship", "--config", "c4"],
                 ["frame", "--config", "c4"]):
        with pytest.raises(SystemExit):
            card_probe.main(["--what", *args])


def test_card_probe_splits_a_trace_at_its_marker():
    """``card_probe.card_work`` keeps the card's work (kernels, memsets,
    copies) of a Chrome trace in the order of the card's clock and splits it
    at the one marker kernel, which it leaves out; the host's events (here a
    range that the card's clock would place after the last kernel launched
    before it) play no part.  A trace without the marker, or with two, is
    refused."""
    from lomanerf_tpu_torch.scripts import card_probe

    def work(ts, name="grid_sum_kernel", cat="kernel"):
        return {"cat": cat, "name": name, "ts": ts, "dur": 80, "args": {"correlation": 1}}

    marker = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [work(12.0), {"cat": "user_annotation", "name": "range", "ts": 100.0, "dur": 50},
              {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 101.0, "dur": 2},
              work(200.0, "Memset (Device)", "gpu_memset"), work(190.0, "reduce_kernel"),
              work(180.0, marker), work(110.0)]
    assert card_probe.card_work(events) == [
        ("grid_sum_kernel", "kernel", 80.0, 12.0), ("grid_sum_kernel", "kernel", 80.0, 110.0),
        (marker, "kernel", 80.0, 180.0), ("reduce_kernel", "kernel", 80.0, 190.0),
        ("Memset (Device)", "gpu_memset", 80.0, 200.0)]
    before, after = card_probe.card_work(events, card_probe.MARKER)
    assert [w[0] for w in before] == ["grid_sum_kernel", "grid_sum_kernel"]
    assert [w[0] for w in after] == ["reduce_kernel", "Memset (Device)"]
    for trace in (events[:-2], events + [work(300.0, marker)]):
        with pytest.raises(RuntimeError, match="spin_kernel kernels in the trace"):
            card_probe.card_work(trace, card_probe.MARKER)
