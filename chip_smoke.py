"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100 here).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``lomanerf_tpu_torch/ops/csrc`` with nvcc
(sm_90a), then:

1. holds the render kernel against its plain PyTorch version on the card,
   at the ``small`` (3x30, S=30) and ``single64`` (4x64, S=64) shapes, in
   both compositing modes, on 1037 rays (not a multiple of the block);
2. renders the trained 3x30 field (``tests/data/convergence_64_step5000.npz``)
   at 64x64 through ``NeRFModel.render_image`` and compares it with the JAX
   package's renders stored in that file, and its PSNR on the eval view with
   the JAX package's PSNR;
3. renders a 4-frame 800x800 orbit with ``render_orbit`` (the serving path),
   then times one frame through the kernel and through the plain version with
   CUDA events.

Phases 2 and 3's orbit are the main path: the kernel's launch count is reset
before them and must be above zero after.  The last lines are the card's name
and power limit, a JSON line per kernel, and ``{"ok": true, "device": ...}``.
It exits non-zero, before printing any result, without a CUDA device or
outside a checkout of the repository; any failing phase raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "convergence_64_step5000.npz")
KERNEL_SOURCE = "lomanerf_tpu_torch/ops/csrc/nerf_render_fwd.cu"
REPLACES = "lomanerf_tpu/ops/fused_nerf.py:1323"
# kernel vs plain version: both f32, sums taken in another order (MLP dot
# products, the colour sum over samples), encodings through different sin/cos
ATOL, RTOL = 1e-4, 1e-4
PSNR_TOL_DB = 0.05
N_CHECK = 1000 + 37  # not a multiple of the 128-ray block
SERVE_SIZE, SERVE_FRAMES = 800, 4


def phase_kernel_vs_plain(fused_nerf, NeRFConfig, seed=0):
    """Phase 1: numpy-seeded params and rays through the kernel and the plain
    version on the card."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for name in ("small", "single64"):
        for mode in ("loma", "standard"):
            cfg = dataclasses.replace(NeRFConfig.preset(name), mode=mode)
            sizes = [cfg.in_channels] + [cfg.filter_size] * (cfg.num_layers - 1) \
                + [cfg.out_channels]
            params = {"w": [], "b": []}
            for fi, fo in zip(sizes[:-1], sizes[1:]):
                params["w"].append(torch.tensor(
                    rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi),
                    dtype=torch.float32, device="cuda"))
                params["b"].append(torch.tensor(
                    rng.standard_normal(fo) * 0.5, dtype=torch.float32, device="cuda"))
            o = torch.tensor(rng.standard_normal((N_CHECK, 3)), dtype=torch.float32,
                             device="cuda")
            d = torch.tensor(rng.standard_normal((N_CHECK, 3)), dtype=torch.float32,
                             device="cuda")
            t = torch.linspace(cfg.near, cfg.far, cfg.num_samples, device="cuda")
            dists = torch.cat([t[1:] - t[:-1], torch.full((1,), 1e8, device="cuda")])
            got = fused_nerf.render_rays(params, o, d, t, dists, cfg)
            want = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            print(f"phase 1 {name:8s} {mode:8s} N={N_CHECK}: max|kernel-plain| = "
                  f"{err:.3e}")
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    return worst


def phase_trained_field(fx, model, normalized_intrinsics, psnr):
    """Phase 2: the trained 3x30 field at 64x64 against the JAX renders."""
    size = fx["jax_renders"].shape[1]
    K = normalized_intrinsics(float(fx["focal"]), device="cuda")
    worst = 0.0
    with torch.no_grad():
        for i, pose in enumerate(fx["poses"]):
            img = model.render_image(K, pose, size)
            want = torch.from_numpy(fx["jax_renders"][i]).cuda()
            err = (img - want).abs().max().item()
            worst = max(worst, err)
            torch.testing.assert_close(img, want, atol=ATOL, rtol=0.0)
        Ke = normalized_intrinsics(float(fx["eval_focal"]), device="cuda")
        img = model.render_image(Ke, fx["eval_pose"], size)
    target = torch.from_numpy(fx["eval_target"]).cuda()
    got_psnr = psnr(target, img).item()
    jax_psnr = float(fx["eval_jax_psnr"])
    print(f"phase 2 trained 3x30 field, {len(fx['poses'])} poses at {size}x{size}: "
          f"max|torch-jax| = {worst:.3e} (atol {ATOL}); eval-view PSNR "
          f"{got_psnr:.4f} dB (JAX {jax_psnr:.4f} dB)")
    if not np.isfinite(got_psnr) or abs(got_psnr - jax_psnr) > PSNR_TOL_DB:
        raise AssertionError(f"PSNR {got_psnr} vs JAX {jax_psnr}: off by more "
                             f"than {PSNR_TOL_DB} dB")
    return worst


def cuda_ms(fn):
    """One call of ``fn`` timed with CUDA events, in ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                         "False); the port's kernels run only on the card")
    sys.path.insert(0, ROOT)
    import lomanerf_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(lomanerf_tpu_torch.__file__))) != ROOT:
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    from lomanerf_tpu_torch.core import normalized_intrinsics, psnr, rays
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.ops import build, fused_nerf
    from lomanerf_tpu_torch.train.checkpoint import load_params_npz
    from lomanerf_tpu_torch.train.make_video import render_orbit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {os.path.relpath(lib_path, ROOT)} in {time.perf_counter() - t0:.1f} s")
    print((lib_path.parent / "build.log").read_text().strip())

    worst = phase_kernel_vs_plain(fused_nerf, NeRFConfig)

    # ---- the main path: trained field -> render_image / render_orbit ----
    fx = np.load(FIXTURE)
    p = load_params_npz(FIXTURE)
    cfg = NeRFConfig.small()
    model = NeRFModel.from_numpy(cfg, p["w"], p["b"], device="cuda")
    fused_nerf.launches = 0
    worst = max(worst, phase_trained_field(fx, model, normalized_intrinsics, psnr))
    after_phase2 = fused_nerf.launches
    if after_phase2 == 0:
        raise AssertionError("phase 2 made no kernel launch")
    t0 = time.perf_counter()
    frames = render_orbit(model, float(fx["focal"]), 4.0, SERVE_FRAMES, SERVE_SIZE)
    orbit_s = time.perf_counter() - t0
    launches = fused_nerf.launches
    if launches <= after_phase2:
        raise AssertionError("render_orbit made no kernel launch")
    if frames.shape != (SERVE_FRAMES, SERVE_SIZE, SERVE_SIZE, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"orbit frames {frames.shape} {frames.dtype}")
    if frames.std() < 1.0:
        raise AssertionError("orbit frames are blank")
    print(f"phase 3 render_orbit: {SERVE_FRAMES} frames at {SERVE_SIZE}x{SERVE_SIZE} "
          f"in {orbit_s:.2f} s host time (incl. copies); kernel launches on the main "
          f"path: {launches}")

    # ---- phase 3 timing: one frame, kernel vs plain version, CUDA events ----
    K = normalized_intrinsics(float(fx["focal"]), device="cuda")
    pose = torch.from_numpy(fx["poses"][1]).cuda()

    def plain_frame():
        o, d = rays.get_rays(SERVE_SIZE, SERVE_SIZE, K, pose)
        tv, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
        return fused_nerf.render_rays_reference(
            model.params, o, d, tv, dists, cfg).reshape(SERVE_SIZE, SERVE_SIZE, 3)

    def kernel_frame():
        return model.render_image(K, pose, SERVE_SIZE)

    kernel_ms, plain_ms = [], []
    with torch.no_grad():
        _, img_k = cuda_ms(kernel_frame)  # warm-up
        _, img_p = cuda_ms(plain_frame)
        err = (img_k - img_p).abs().max().item()
        torch.testing.assert_close(img_k, img_p, atol=ATOL, rtol=RTOL)
        if not torch.isfinite(img_k).all():
            raise AssertionError("non-finite pixels")
        worst = max(worst, err)
        for _ in range(SERVE_FRAMES):  # in turns: plain, kernel, kernel, plain
            plain_ms.append(cuda_ms(plain_frame)[0])
            kernel_ms.append(cuda_ms(kernel_frame)[0])
            kernel_ms.append(cuda_ms(kernel_frame)[0])
            plain_ms.append(cuda_ms(plain_frame)[0])
    k_med, p_med = statistics.median(kernel_ms), statistics.median(plain_ms)
    n_rays = SERVE_SIZE * SERVE_SIZE
    print(f"phase 3 800x800 frame ({n_rays} rays x {cfg.num_samples} samples), "
          f"max|kernel-plain| = {err:.3e}; on {smi}:")
    print(f"  kernel: median {k_med:.3f} ms/frame (min {min(kernel_ms):.3f}, max "
          f"{max(kernel_ms):.3f}, n={len(kernel_ms)}), {n_rays / k_med * 1e3:.4e} rays/s")
    print(f"  plain : median {p_med:.3f} ms/frame (min {min(plain_ms):.3f}, max "
          f"{max(plain_ms):.3f}, n={len(plain_ms)}), {n_rays / p_med * 1e3:.4e} rays/s")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "nerf_render_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": k_med, "plain_ms": p_med,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
