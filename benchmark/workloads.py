"""What every kind of traffic shares: the model and its inputs made from the
seed, the closed loop over the window, and planting a fault.

A kind of traffic is the module ``loops/<kind>.py`` that a mix's
``"kind"`` names (``spec.load_kind``); a mix is ``traffic/<mix>.json``, the
parameters that its kind's loop reads.  Each kind module holds:

* ``Loop`` — a subclass of :class:`Loop`: set-up in the constructor, then
  :meth:`Loop.first` (what the check follows), :meth:`Loop.item` in the
  window, and :meth:`Loop.outputs` and :meth:`Loop.reference` once the
  program's state is freed; ``metric`` names the end-to-end metric it
  reports and ``span`` the host span around one item;
* ``work(model, traffic)`` — one item's ``macs`` and ``bytes``
  (``counts.py``'s arithmetic);
* ``NAMES`` and ``numbers(outputs, reference)`` — the numbers that decide
  ``correct``, each held to its limit in ``limits/<cell>.json``;
* ``FAULTS`` — the faults that a cell of this kind can have, each a
  context manager that breaks the program under the timed path and mends
  it on exit;
* ``control_outputs(reference)`` — the reference's outputs in the form of
  the program's, for the control;
* optionally ``look(outputs, reference)`` — finer readings that
  ``calibrate.py`` prints beside the numbers, and ``check_cell(name,
  config, traffic)`` — a refusal, as a string, of a configuration that the
  traffic cannot run.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark import counts, scene
from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def program_config(model: dict) -> NeRFConfig:
    """The port's ``NeRFConfig`` of a configuration file's ``model``."""
    fields = dict(model)
    fields["dtype"] = _DTYPES[fields["dtype"]]
    return NeRFConfig(**fields)


def norms(tensors) -> list:
    return [float(torch.linalg.vector_norm(t.detach().double())) for t in tensors]


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` replaced by ``value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class Loop:
    """A cell's closed loop on ``device``: the model with the seed's weights
    (``init``, which the reference takes too)."""

    metric = ""
    span = ""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.model_spec, self.traffic = cell.model, cell.traffic
        self.cfg = program_config(self.model_spec)
        self.gen = scene.generator(seed, "scene", self.device)
        self.focal = scene.focal(self.traffic["camera_angle_x"])
        self.init = scene.init_params(self.gen, counts.layer_sizes(self.model_spec),
                                      self.device)
        self.model = NeRFModel(self.cfg, device=self.device)
        self.model.load_params(self.init)

    def window(self, seconds: float) -> dict:
        """Items until ``seconds`` have passed: the count, the failures and
        the cell's end-to-end metric over the whole window."""
        n, failed, start = 0, 0, time.perf_counter()
        while True:
            failed += not self.item()
            n += 1
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        return {"attempted": n, "failed": failed, "metric": {self.metric: elapsed / n * 1e3}}

    def fill_check(self) -> None:
        """After :meth:`first`, without a window: make what the check
        compares where the window would have made it (``calibrate.py``)."""

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.model = None


def make(cell, seed: int, device) -> Loop:
    return cell.kind.Loop(cell, seed, device)
