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
