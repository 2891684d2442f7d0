"""Losses and image metrics (port of ``lomanerf_tpu.core.losses``): the
reference's SUM-of-squared-errors loss and ``20*log10(max/sqrt(mse))`` PSNR.
"""

from __future__ import annotations

import torch


def sum_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum of squared errors (the reference's 'MSE')."""
    d = pred - target
    return torch.sum(d * d)


def mean_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred - target
    return torch.mean(d * d)


def psnr(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(max_val / torch.sqrt(mse))
