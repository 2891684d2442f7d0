"""Params fixtures in numpy ``.npz`` form.

The JAX package checkpoints with orbax, which the port does not depend on;
``scripts/export_torch_fixture.py`` converts an orbax checkpoint into this
format (``w0..w{L-1}``, ``b0..b{L-1}``, plus any other arrays).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def load_params_npz(path: str) -> Dict[str, List[np.ndarray]]:
    """``{"w": [...], "b": [...]}`` numpy f32 params read from ``path``."""
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("w") and k[1:].isdigit())
        if n == 0:
            raise ValueError(f"{path} holds no w0.. params")
        return {
            "w": [np.asarray(data[f"w{i}"], np.float32) for i in range(n)],
            "b": [np.asarray(data[f"b{i}"], np.float32) for i in range(n)],
        }
