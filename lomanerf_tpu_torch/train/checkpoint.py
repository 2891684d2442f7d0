"""Checkpoint / resume (port of ``lomanerf_tpu.train.checkpoint``), and params
fixtures in numpy ``.npz`` form.

``CheckpointManager`` keeps ``ckpt_<step>.pt`` files, each a ``torch.save``
of ``{"params", "optimizer", "step"}``, with keep-N rotation and
latest-step restore.  The JAX package checkpoints with orbax, which the port
does not depend on; ``scripts/export_torch_fixture.py`` converts an orbax
checkpoint into the ``.npz`` form (``w0..w{L-1}``, ``b0..b{L-1}``, plus any
other arrays) that :func:`load_params_npz` reads.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _params_of(model_or_params):
    if isinstance(model_or_params, torch.nn.Module):
        return model_or_params.params
    return model_or_params


class CheckpointManager:
    """Step-numbered checkpoints of params + optimizer state in one
    directory, keeping the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> List[int]:
        """The steps on disk, oldest first."""
        found = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model_or_params, optimizer: torch.optim.Optimizer) -> None:
        """Write step ``step`` (atomically: a temporary file, then a rename),
        then delete all but the newest ``max_to_keep``."""
        params = _params_of(model_or_params)
        state = {
            "params": {k: [p.detach().cpu() for p in params[k]] for k in ("w", "b")},
            "optimizer": optimizer.state_dict(),
            "step": int(step),
        }
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    @torch.no_grad()
    def restore(self, model_or_params, optimizer: Optional[torch.optim.Optimizer] = None,
                step: Optional[int] = None) -> int:
        """Load step ``step`` (default: the latest) into the params, in place
        and on their device, and into ``optimizer`` if given; returns the step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        params = _params_of(model_or_params)
        for k in ("w", "b"):
            for dst, src in zip(params[k], state["params"][k], strict=True):
                if dst.shape != src.shape:
                    raise ValueError(f"checkpoint param {tuple(src.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])


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
