"""Differentiable sphere raytracer in the DSL (port of
``examples/diff_raytrace.py``).

Renders a sphere by a smooth ray-sphere hit written in the DSL with
structs, and differentiates one pixel's intensity with respect to the
sphere with ``rev_diff``.

Run: ``python -m lomanerf_tpu_torch.examples.diff_raytrace [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from lomanerf_tpu_torch import dsl

CODE = """
class Vec3:
    x : float
    y : float
    z : float

class Sphere:
    center : Vec3
    radius : float

def intensity(sph : In[Sphere], ox : In[float], oy : In[float]) -> float:
    # orthographic ray from (ox, oy, -10) along +z; soft hit via smooth
    # distance to the sphere surface (differentiable everywhere)
    dx : float = ox - sph.center.x
    dy : float = oy - sph.center.y
    d2 : float = dx * dx + dy * dy
    r2 : float = sph.radius * sph.radius
    s : float = 0
    s = r2 - d2
    # softplus-like shading: exp keeps it smooth for the gradient
    return 1.0 / (1.0 + exp(0.0 - 20.0 * s))

d_intensity = rev_diff(intensity)
"""


def main(argv=None) -> dict:
    """Returns the sphere, the rendered image and the gradient of the pixel
    at (0.45, 0) with respect to the sphere."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=24)
    args = ap.parse_args(argv)
    _, lib = dsl.compile(CODE, device=args.device)
    sphere = {"center": {"x": 0.2, "y": -0.1, "z": 0.0}, "radius": 0.5}
    grid = np.linspace(-1, 1, args.size)
    img = np.array([[lib.intensity(sphere, float(x), float(y)) for x in grid] for y in grid],
                   np.float32)
    print("rendered sphere, mean intensity:", img.mean())
    z = lambda: np.zeros((), np.float32)  # noqa: E731
    d_sph = {"center": {"x": z(), "y": z(), "z": z()}, "radius": z()}
    g = lib.d_intensity(sphere, d_sph, 0.45, z(), 0.0, z(), 1.0)["sph"]
    gx, gr = float(g["center"]["x"]), float(g["radius"])
    print(f"d(intensity)/d(center.x) = {gx:.4f}, d/d(radius) = {gr:.4f}")
    # a pixel right of the center: moving the sphere right or growing it
    # brightens it
    if not (gx > 0 and gr > 0):
        raise AssertionError(f"gradient signs: {g}")
    return {"sphere": sphere, "image": img, "grad": g}


if __name__ == "__main__":
    main()
