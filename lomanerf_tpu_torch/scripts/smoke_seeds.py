"""``chip_smoke.py`` phase 24's first check at other seeds than its own:
the wide kernels' train and render-backward gradients against their plain
versions on 1037 rays, at the phase's bound (1e-2 of each leaf's largest
entry, ``chip_smoke.wide_tolerances``), for each bf16 MLP of
``chip_smoke.width_configs`` at shared and per-ray depths.  Each case's worst
leaf gap is printed over its bound, so that a reading above 1 is a case the
phase would stop at with that seed; nothing stops here.

A gap of that size is a ReLU decision taken the other way by the kernel
and the plain version (two f32 sums in another order on each side of 0),
which moves a whole column of the next layer's gradient; how often that
happens at a seed shows how near the phase's bound the kernels run.

``--root DIR`` runs the check of another checkout (e.g. the parent
unpacked by ``git archive`` under ``build/``): its ``chip_smoke.py`` and its
kernels, in a process of its own.  Needs a card.  Run:

    python -m lomanerf_tpu_torch.scripts.smoke_seeds --seeds 31,32,33 [--root build/parent]

One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def check(seeds) -> list:
    """Phase 24's first loop at each seed, in this process (the checkout
    whose root is first on ``sys.path``)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from lomanerf_tpu_torch.models import NeRFConfig
    from lomanerf_tpu_torch.ops import fused_nerf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def over(got, want, rel):  # the worst leaf's gap over its bound
        return max(((a - b).abs().max() / (rel * b.abs().max())).item()
                   for a, b in zip(got, want))

    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)  # drawn in the phase's order, every MLP
        cases = {}
        for name, cfg in cs.width_configs(NeRFConfig).items():
            params = cs.seeded_params(rng, cfg)
            leaves = cs.leaves_of(params)
            o, d = cs.seeded_rays(rng, cs.N_CHECK)
            tgt = torch.tensor(rng.random((cs.N_CHECK, 3)), dtype=torch.float32,
                               device="cuda")
            cot = torch.tensor(rng.standard_normal((cs.N_CHECK, 3)), dtype=torch.float32,
                               device="cuda")
            rel = cs.wide_tolerances(cfg)[2]
            for depths, suf in ((cs.uniform_depths(cfg), ""),
                                (cs.jittered_depths(rng, cfg, cs.N_CHECK), "_rays")):
                if rel is None:  # f32: the phase's other bounds, not this one
                    continue
                t, dists = depths

                def train(fn):
                    loss = fn(params, o, d, t, dists, tgt, cfg)
                    return torch.autograd.grad(loss, leaves)

                def render_bwd(fn):
                    return torch.autograd.grad((fn(params, o, d, t, dists, cfg) * cot).sum(),
                                               leaves)

                cases[name + suf] = {
                    "train": over(train(fused_nerf.nerf_train_loss),
                                  train(fused_nerf.nerf_train_loss_reference), rel),
                    "render_bwd": over(render_bwd(fused_nerf.render_rays),
                                       render_bwd(fused_nerf.render_rays_reference), rel)}
        worst = max(max(v.values()) for v in cases.values())
        line = {"seed": seed, "passes": worst <= 1.0, "worst_over_bound": worst,
                "cases": cases}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="smoke_seeds")
    ap.add_argument("--seeds", default="31", help="comma-separated")
    ap.add_argument("--root", default=None, help="another checkout, checked in its own process")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.root:
        root = os.path.abspath(args.root)
        here = os.path.abspath(__file__)
        code = (f"import sys; sys.path.insert(0, {root!r}); ns = {{'__name__': 'smoke_seeds'}}; "
                f"exec(compile(open({here!r}).read(), {here!r}, 'exec'), ns); "
                f"ns['check']({seeds!r})")
        raise SystemExit(subprocess.run([sys.executable, "-c", code], cwd=root).returncode)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("smoke_seeds: needs a CUDA card")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    check(seeds)


if __name__ == "__main__":
    main()
