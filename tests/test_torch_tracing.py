"""The port's spans (``utils.profiling.span``): ``record_function`` ranges
named ``lomanerf.<module>.<what>`` that a profiler records on the clock of
the device's operations, and nothing while no profiler records.

Imports neither jax nor the JAX package, so the card test also runs where
only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m cuda

On the CPU the spans are read from the Chrome trace that
``utils.profiling.trace`` writes, the operator's way to see them.
"""

import json
from pathlib import Path

import pytest
import torch

from lomanerf_tpu_torch.core import uniform_depths
from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
from lomanerf_tpu_torch.ops import fused_nerf
from lomanerf_tpu_torch.train.steps import make_single_chip_train_step
from lomanerf_tpu_torch.utils import profiling

# a wide MLP (padded width 72 > 64: pw 128) at a CPU size
WIDE = NeRFConfig(num_layers=3, filter_size=72, num_samples=8, mode="standard",
                  compute_dtype="bfloat16", init="nerf")


def model_of(cfg, device):
    model = NeRFModel(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(21))
    return model


def rays_of(n, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    o = torch.rand((n, 3), generator=g, device=device) * 0.2
    d = torch.nn.functional.normalize(torch.rand((n, 3), generator=g, device=device) - 0.5,
                                      dim=-1)
    return o, d, torch.rand((n, 3), generator=g, device=device)


def one_step(model, n=16):
    """One ``make_single_chip_train_step`` step with Adam on ``n`` rays."""
    cfg = model.config
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_single_chip_train_step(cfg, opt)
    o, d, target = rays_of(n, model.device)
    t_vals, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, model.device)
    return step(model, o, d, t_vals, dists, target)


def render(model, side=6, chunk=16):
    f = 1.2
    K = torch.tensor([[f, 0.0, 0.5], [0.0, f, 0.5], [0.0, 0.0, 1.0]])
    c2w = torch.eye(4)
    c2w[2, 3] = 4.0
    return model.render_image(K, c2w, side, chunk=chunk)


def traced(tmp_path, fn):
    """``fn()`` under ``utils.profiling.trace``; the trace's events."""
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        fn()
    return json.loads((Path(log_dir) / profiling.TRACE_FILE).read_text())["traceEvents"]


def spans(events, name):
    """The host ranges named ``name`` (a card's trace also mirrors each range
    on the device's timeline, as ``gpu_user_annotation``)."""
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]


def inside(inner, outer):
    """Whether ``inner``'s interval lies in ``outer``'s (µs, to the ns the
    trace prints)."""
    return (outer["ts"] - 1e-3 <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3)


def test_span_is_a_shared_no_op_while_no_profiler_records(tmp_path, monkeypatch):
    """No profiler: ``span`` hands back one shared no-op, and a train step
    and a frame enter no ``lomanerf.*`` ``record_function``; under a
    profiler the same calls do."""
    assert not torch._C._autograd._profiler_enabled()
    a, b = profiling.span("lomanerf.a"), profiling.span("lomanerf.b")
    assert a is b and not isinstance(a, torch.profiler.record_function)
    made = []
    init = torch.profiler.record_function.__init__

    def spy(self, name, args=None):
        made.append(name)
        init(self, name, args)

    monkeypatch.setattr(torch.profiler.record_function, "__init__", spy)
    model = model_of(WIDE, "cpu")
    one_step(model)
    with torch.no_grad():
        render(model)
    assert not [n for n in made if n.startswith("lomanerf.")]
    traced(tmp_path, lambda: one_step(model))
    assert {"lomanerf.steps.train_step", "lomanerf.fused_nerf.train_loss",
            "lomanerf.fused_nerf.backward"} <= set(made)


def test_train_step_nests_the_loss_in_the_step(tmp_path):
    """One step of a wide config on the CPU (the plain route): the loss's
    span and its backward's lie inside the step's."""
    model = model_of(WIDE, "cpu")
    events = traced(tmp_path, lambda: one_step(model))
    (step,) = spans(events, "lomanerf.steps.train_step")
    (loss,) = spans(events, "lomanerf.fused_nerf.train_loss")
    (back,) = spans(events, "lomanerf.fused_nerf.backward")
    assert inside(loss, step) and inside(back, step)
    assert back["ts"] >= loss["ts"] + loss["dur"] - 1e-3  # the backward after the loss


def test_render_image_gives_one_render_rays_span_a_chunk(tmp_path):
    """A 6x6 frame in chunks of 16 rays: three ``render_rays`` spans, each
    inside the frame's."""
    model = model_of(WIDE, "cpu")
    with torch.no_grad():
        events = traced(tmp_path, lambda: render(model, side=6, chunk=16))
    (frame,) = spans(events, "lomanerf.nerf.render_image")
    chunks = spans(events, "lomanerf.fused_nerf.render_rays")
    assert len(chunks) == 3 and all(inside(c, frame) for c in chunks)


@pytest.mark.parametrize("pack", ["wide", "narrow"])
def test_packing_shows_the_pack_span(tmp_path, pack):
    """``pack_wide_params`` and ``pack_params`` called directly, then their
    gradients' layouts back: one ``pack`` and one ``unpack`` span each."""
    cfg = WIDE if pack == "wide" else NeRFConfig.small()
    params = model_of(cfg, "cpu").params
    t_vals, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cpu")

    def both():
        if pack == "wide":
            W, b = fused_nerf.pack_wide_params(params, 128, cfg.compute_dtype)
            fused_nerf.unpack_wide_grads(W.float(), b, params)
        else:
            fused_nerf.pack_params(params, t_vals, dists, 32)
            G = fused_nerf.grad_floats(params, 32)
            fused_nerf.unpack_grads(torch.zeros(G), params, 32)

    events = traced(tmp_path, both)
    assert len(spans(events, "lomanerf.fused_nerf.pack")) == 1
    assert len(spans(events, "lomanerf.fused_nerf.unpack")) == 1


@pytest.mark.cuda
def test_wide_bf16_step_spans_on_the_card(tmp_path):
    """One flagship (8x256 bf16) step on the card: the wrapper's ``pack``,
    ``launch.nerf_wide_train``, ``unpack`` and ``backward`` spans, and the
    wide chain's kernels among the operations launched inside the launch
    span (by the runtime call that carries each one's correlation id)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = model_of(NeRFConfig.full(), "cuda")
    one_step(model, n=1037)  # builds the kernels, outside the trace
    events = traced(tmp_path, lambda: one_step(model, n=1037))
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"lomanerf.steps.train_step", "lomanerf.fused_nerf.train_loss",
            "lomanerf.fused_nerf.pack", "lomanerf.fused_nerf.launch.nerf_wide_train",
            "lomanerf.fused_nerf.unpack", "lomanerf.fused_nerf.backward"} <= names
    (launch,) = spans(events, "lomanerf.fused_nerf.launch.nerf_wide_train")
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    launched = [(k["name"], calls.get(k["args"].get("correlation"))) for k in events
                if k.get("cat") == "kernel"]
    within = {name for name, call in launched if call and inside(call, launch)}
    for part in ("encode_kernel", "layer_wgmma_kernel", "composite_kernel",
                 "dw_wgmma_kernel", "colsum_kernel"):
        assert any(part in k for k in within), (part, sorted(within))
    outside = {name for name, call in launched if not (call and inside(call, launch))}
    assert not any("wgmma" in k for k in outside), sorted(outside)
