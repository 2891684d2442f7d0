"""The plain reference (``benchmark/reference/``) against autograd of its
own float64 form, its blocked form against its unblocked one, and the
benchmark's imports."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import counts
from benchmark.reference import nerf as ref

ROOT = Path(__file__).resolve().parents[2]
MODES = ("standard", "loma")


def tiny(mode="standard", width=16, layers=3, samples=6):
    return {"num_layers": layers, "filter_size": width, "out_channels": 4,
            "num_encoding_functions": 2, "num_samples": samples, "near": 2.0, "far": 6.0,
            "mode": mode}


def inputs(m, rays=9, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    sizes = counts.layer_sizes(m)
    p = {"w": [torch.randn(fi, fo, generator=gen, dtype=dtype) * (2 / fi) ** 0.5
               for fi, fo in sizes],
         "b": [torch.randn(fo, generator=gen, dtype=dtype) * 0.1 for _, fo in sizes]}
    p["b"][-1][3] = 0.5
    o = torch.randn(rays, 3, generator=gen, dtype=dtype) * 0.3 + torch.tensor([0.0, 0.0, 4.0],
                                                                             dtype=dtype)
    d = torch.randn(rays, 3, generator=gen, dtype=dtype) * 0.2 + torch.tensor([0.0, 0.0, -1.0],
                                                                             dtype=dtype)
    tg = torch.rand(rays, 3, generator=gen, dtype=dtype)
    return p, o, d, tg


def as64(p):
    return {k: [x.double() for x in v] for k, v in p.items()}


@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_match_float64_autograd(mode):
    m = tiny(mode)
    p, o, d, tg = inputs(m)
    loss, grads = ref.loss_and_grads(p, o, d, tg, m)
    p64 = as64(p)
    leaves = [x.requires_grad_(True) for x in [*p64["w"], *p64["b"]]]
    out = ref.render(p64, o.double(), d.double(), m)
    want = torch.sum((out - tg.double()) ** 2)
    want.backward()
    assert loss == pytest.approx(float(want.detach()), rel=1e-5)
    for g, x in zip(grads, leaves):
        scale = float(x.grad.abs().max()) + 1e-12
        assert float((g.double() - x.grad).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("block", [1, 2, 4])
def test_blocked_equals_unblocked(block):
    m = tiny()
    p, o, d, tg = inputs(m, rays=8, dtype=torch.float64)
    whole_loss, whole = ref.loss_and_grads(p, o, d, tg, m, block=8)
    loss, grads = ref.loss_and_grads(p, o, d, tg, m, block=block)
    assert loss == pytest.approx(whole_loss, rel=1e-12)
    for g, w in zip(grads, whole):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(ref.render_blocked(p, o, d, m, block=block),
                               ref.render_blocked(p, o, d, m, block=8), rtol=0, atol=0)


def test_adam_equals_torch_adam():
    m = tiny()
    p, o, d, tg = inputs(m, dtype=torch.float64)
    opt = {"lr": 5e-4, "betas": [0.9, 0.999], "eps": 1e-8}
    batches = [inputs(m, seed=s, dtype=torch.float64)[1:] for s in range(3)]
    got = ref.train(p, batches, m, opt)
    leaves = [x.clone().requires_grad_(True) for x in [*p["w"], *p["b"]]]
    adam = torch.optim.Adam(leaves, lr=opt["lr"], betas=tuple(opt["betas"]), eps=opt["eps"])
    n_w = len(p["w"])
    losses = []
    for o_, d_, tg_ in batches:
        adam.zero_grad()
        out = ref.render({"w": leaves[:n_w], "b": leaves[n_w:]}, o_, d_, m)
        loss = torch.sum((out - tg_) ** 2)
        loss.backward()
        losses.append(float(loss))
        adam.step()
    assert got["losses"] == pytest.approx(losses, rel=1e-12)
    for change, x, x0 in zip(got["changes"], leaves, [*p["w"], *p["b"]]):
        torch.testing.assert_close(change, x.detach() - x0, rtol=1e-9, atol=1e-12)


def test_comb_offsets_lie_in_a_bin():
    gen = torch.Generator().manual_seed(3)
    dt = ref.comb_offsets(gen, 1000, 2.0, 6.0, 128)
    assert float(dt.min()) >= 0.0 and float(dt.max()) < 4.0 / 128


def test_fp8_plan_rounds_products_and_head():
    m = tiny()
    p, o, d, _ = inputs(m)
    exact = ref.render(p, o, d, m, ref.EXACT)
    low = ref.render(p, o, d, m, ref.FP8)
    gap = float((exact - low).abs().max())
    assert 1e-4 < gap < 0.2
    x = torch.linspace(-3, 3, 101)
    assert float((ref._fp8(x) - x).abs().max()) <= 3 / 8  # e4m3: 3 mantissa bits


def test_no_module_loads_jax_or_the_jax_package():
    """Every module of the benchmark, imported in a fresh process, leaves no
    module whose top-level name is jax, jaxlib, flax or lomanerf_tpu (the
    port's name begins with the latter: names are compared whole)."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in (ROOT / "benchmark").rglob("*.py")
                  if not {"tests", "metrics", "loops"} & set(p.parts))
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from benchmark import spec\n"
            "for p in (spec.BENCH_DIR / 'metrics').glob('*.py'): spec.load_reader(p)\n"
            "for p in (spec.BENCH_DIR / 'loops').glob('*.py'): spec.load_kind(p.stem)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert "lomanerf_tpu_torch" in top and "benchmark" in top
    assert not top & {"jax", "jaxlib", "flax", "lomanerf_tpu"}


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys\n"
            "import benchmark.reference.nerf\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert not top & {"lomanerf_tpu_torch", "lomanerf_tpu", "jax", "jaxlib", "flax"}
