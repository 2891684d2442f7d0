"""Where a bf16 wide render's colours move off the plain version's: the
case of the card test ``test_fused_mlp_render_equals_the_mma_chain``
(``tests/test_torch_cuda.py``: the same seeded weights, rays and depths)
that goes past phase 7's bound, ``full`` at S = 64 on 1037 rays at per-ray
depths, in either mode, bisected to the ray, the hidden layer and the
stored bf16 values.

* The colour furthest from the plain version's (``wide_mlp._plain``, the
  wide kernels' plain forward) names the ray.
* For each hidden layer m, the fused MLP's stored bf16 output from the stack
  cut after layer m (``wide_mlp.wide_mlp`` on ``W[:m + 2]``: the same kernel
  and the same operations up to that layer) is held against the plain
  version's, on the ray's rows and on all rows: how many values differ.
* Where a row of the ray first differs, its input is the plain version's
  bit for bit (at layer 0 the plain encoding: the kernel's own is not
  stored), so the difference is the sum's order alone.  Each differing
  value is placed against the bf16 rounding: the f64 pre-activation from
  that input, the values the kernel and the plain version stored, and the
  distance of the f64 sum from the rounding boundary between them (their
  midpoint, or 0 where one is a ReLU zero), beside the f32 rounding scale
  of the sum (its absolute terms summed, times 2^-24).
* The plain version continued from the kernel's output of layer m (the
  later layers, the head and the compositing in plain PyTorch, the plain
  version's operations): the colour error left at the ray, so that the
  layer whose flips move the colour shows as the step.

Needs a card.  Run:

    python -m lomanerf_tpu_torch.scripts.bf16_flips [--mode loma]

The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

EPS_F32 = 2.0 ** -24
S, N_RAYS = 64, 1037  # the case's samples and rays, at per-ray depths


def case(mode: str):
    """The card test's inputs: weights, rays (its ``np_params`` and
    ``cuda_rays`` from ``default_rng(N_RAYS + S)``) and per-ray depths."""
    from lomanerf_tpu_torch.core import mlp_layer_sizes, params_from_numpy
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.ops import fused_nerf

    rng = np.random.default_rng(N_RAYS + S)
    cfg = dataclasses.replace(NeRFConfig.full(), mode=mode, num_samples=S)
    sizes = mlp_layer_sizes(cfg.in_channels, cfg.out_channels, cfg.num_layers,
                            cfg.filter_size)
    ws = [(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi)).astype(np.float32)
          for fi, fo in sizes]
    bs = [(rng.standard_normal(fo) * 0.5).astype(np.float32) for _, fo in sizes]
    params = params_from_numpy(ws, bs, "cuda")
    W, b = fused_nerf.pack_wide_params(params, cfg.filter_size, cfg.compute_dtype)
    o, d = (torch.from_numpy(rng.standard_normal((N_RAYS, 3)).astype(np.float32)).cuda()
            for _ in range(2))
    _, t, dists = NeRFModel(cfg).sample(o, d, generator=torch.Generator("cuda").manual_seed(S))
    return cfg, W, b, o, d, t, dists


def continued(h, l0, W, b, dists, mode):
    """The ray's colour from ``h``, its stored output of hidden layer l0 - 1
    ((S, pw) bf16), through the plain version's later layers, head and
    compositing (``fused_nerf._wide_plain_forward``'s operations)."""
    from lomanerf_tpu_torch.ops import fused_nerf

    bf = torch.bfloat16
    h = h.float()
    for l in range(l0, W.shape[0] - 1):
        h = torch.relu(h @ W[l].float() + b[l]).to(bf).float()
    z = h @ W[-1][:, :4].float() + b[-1][:4]
    rgba = torch.cat([torch.sigmoid(z[:, :3]), torch.relu(z[:, 3:])], 1).to(bf).float()
    e = torch.exp(-rgba[:, 3] * dists)
    alpha, c = 1.0 - e, e + fused_nerf.EPS
    P = torch.cumprod(c, 0)
    T = torch.cat([torch.ones_like(P[:1]), P[1:] if mode == "loma" else P[:-1]])
    return ((alpha * T)[:, None] * rgba[:, :3]).sum(0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("loma", "standard"), default="standard")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bf16_flips: needs a CUDA card")
    from lomanerf_tpu_torch.ops import fused_nerf, wide_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, W, b, o, d, t, dists = case(args.mode)
    L = W.shape[0]
    with torch.no_grad():
        got = fused_nerf._launch_wide_render(W, b, t, dists, o, d, cfg)
        col, saved = wide_mlp._plain(W, b, t, dists, o, d, cfg, keep=True)
        err = (got - col).abs()
        ray, ch = divmod(int(err.argmax()), 3)
        rows = slice(ray * S, ray * S + S)
        kern, plain, whole = [], [], []
        for m in range(L - 1):
            h = wide_mlp.wide_mlp(W[: m + 2], b[: m + 2], t, o, d, cfg)
            whole.append(int((h != saved[m + 1]).sum()))
            kern.append(h[rows].clone())
            plain.append(saved[m + 1][rows])
            del h
        enc = saved[0][rows]
        onsets = []
        for s in range(S):
            first = next((m for m in range(L - 1) if not torch.equal(kern[m][s], plain[m][s])),
                         None)
            if first is None:
                continue
            x = (enc[s] if first == 0 else kern[first - 1][s]).double()
            w = W[first, : x.shape[0]].double()
            for u in torch.nonzero(kern[first][s] != plain[first][s]).flatten().tolist():
                exact = float(x @ w[:, u] + b[first, u].double())
                kv, pv = float(kern[first][s, u]), float(plain[first][s, u])
                boundary = 0.0 if min(kv, pv) == 0.0 else (kv + pv) / 2
                onsets.append({
                    "sample": s, "layer": first, "unit": u, "kernel": kv, "plain": pv,
                    "f64_pre_activation": exact, "boundary": boundary,
                    "from_boundary": exact - boundary,
                    "f32_scale": float((x * w[:, u]).abs().sum() + abs(b[first, u])) * EPS_F32})
        left = [float(err[ray, ch])] + [
            abs(float(continued(kern[m], m + 1, W, b, dists[ray], cfg.mode)[ch]) -
                float(got[ray, ch])) for m in range(L - 1)]
    out = {"what": "bf16_flips", "mode": args.mode, "S": S, "rays": N_RAYS,
           "max_abs_err": float(err.max()), "ray": ray, "channel": ch,
           "kernel": float(got[ray, ch]), "plain": float(col[ray, ch]),
           "ray_values_apart_by_layer": [int((k != p).sum()) for k, p in zip(kern, plain)],
           "values_apart_by_layer": whole, "onsets": onsets,
           "err_left_continuing_from_layer": left}
    print(f"full {args.mode}, S={S}, {N_RAYS} rays, per-ray depths: max |kernel - "
          f"plain| {out['max_abs_err']:.4e} at ray {ray}, colour {ch} (kernel "
          f"{out['kernel']:.7f}, plain {out['plain']:.7f})")
    print(f"  stored bf16 values apart, by hidden layer, on the ray ({S} x {W.shape[1]} each): "
          f"{out['ray_values_apart_by_layer']}; on all {N_RAYS * S} rows: {whole}")
    for f in onsets:
        print(f"  onset: sample {f['sample']}, layer {f['layer']}, unit {f['unit']}: kernel "
              f"{f['kernel']:.8g} plain {f['plain']:.8g}; f64 pre-activation "
              f"{f['f64_pre_activation']:.10g}, {f['from_boundary']:+.3e} from the rounding "
              f"boundary {f['boundary']:.8g}; f32 scale of the sum {f['f32_scale']:.3e}")
    print("  colour error left when the plain version continues from the kernel's layer "
          "(none, 0, 1, ...): " + ", ".join(f"{e:.3e}" for e in left))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
