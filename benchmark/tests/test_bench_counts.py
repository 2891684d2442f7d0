"""The frozen operation counts (``benchmark/counts.py``) against the card
bounds on record and against what the reference's products really count."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, spec
from benchmark.reference import nerf as ref

BENCH = Path(__file__).resolve().parents[1]
PEAK_BF16 = 989e12


def model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]


@pytest.mark.parametrize("config, traffic, bound_ms", [
    ("nerf_8x256", {"kind": "train", "rays_per_step": 16384}, 5.088),
    ("nerf_8x1024", {"kind": "train", "rays_per_step": 16384}, 80.384),
    ("nerf_8x256", {"kind": "render", "side": 800}, 66.710),
])
def test_bounds_on_record(config, traffic, bound_ms):
    kind = spec.load_kind(traffic["kind"])
    work = counts.of_work(kind.work(model(config), traffic), PEAK_BF16)
    assert work["bound_by"] == "operations"
    assert work["bound_ms"] == pytest.approx(bound_ms, abs=5e-4)


def test_render_chunk_bound_on_record():
    # the 8x1024 render at 16,384 rays (one chunk of the 400x400 frame)
    work = counts.frame(model("nerf_8x1024"), 16384)
    assert counts.bound(work["macs"], PEAK_BF16, work["bytes"])[0] == \
        pytest.approx(26.842, abs=5e-4)


def tiny(width=16, layers=3, samples=4, n=2):
    return {"num_layers": layers, "filter_size": width, "out_channels": 4,
            "num_encoding_functions": n, "num_samples": samples, "near": 2.0, "far": 6.0,
            "mode": "standard"}


def params_of(m, gen):
    sizes = counts.layer_sizes(m)
    return {"w": [torch.randn(fi, fo, generator=gen) / fi ** 0.5 for fi, fo in sizes],
            "b": [torch.randn(fo, generator=gen) * 0.1 for _, fo in sizes]}


@pytest.mark.parametrize("width, layers", [(16, 3), (32, 1), (24, 5)])
def test_counts_equal_the_products_run(width, layers):
    """The counts are the reference's own matmul FLOPs: a frame's forward,
    and a step's forward, dW and d_h (autograd computes no d_h for the
    first layer, whose input needs no gradient), so no share of a peak or
    roofline can pass 100% by a miscount."""
    m = tiny(width, layers)
    gen = torch.Generator().manual_seed(0)
    p = params_of(m, gen)
    rays = 7
    o, d, tg = (torch.randn(rays, 3, generator=gen) for _ in range(3))
    with FlopCounterMode(display=False) as fc:
        ref.render(p, o, d, m)
    assert fc.get_total_flops() == 2 * counts.frame(m, rays)["macs"]
    leaves = [x.requires_grad_(True) for x in [*p["w"], *p["b"]]]
    with FlopCounterMode(display=False) as fc:
        out = ref.render(p, o, d, m)
        torch.sum((out - tg) ** 2).backward()
    assert all(x.grad is not None for x in leaves)
    assert fc.get_total_flops() == 2 * counts.train_step(m, rays)["macs"]
