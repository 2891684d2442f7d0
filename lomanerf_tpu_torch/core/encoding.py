"""Sinusoidal positional encoding (port of ``lomanerf_tpu.core.encoding``).

Block layout ``[x | sin 2^0 x | cos 2^0 x | sin 2^1 x | cos 2^1 x | ...]``,
each block spanning all input features: ``(..., F) -> (..., F*(1+2n))``.
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, num_functions: int = 5) -> torch.Tensor:
    """Block-layout sinusoidal encoding (identity block first)."""
    blocks = [x]
    for i in range(num_functions):
        scaled = (2.0**i) * x
        blocks.append(torch.sin(scaled))
        blocks.append(torch.cos(scaled))
    return torch.cat(blocks, dim=-1)


def encoded_dim(in_features: int, num_functions: int) -> int:
    """Output feature count of :func:`positional_encoding`."""
    return in_features * (1 + 2 * num_functions)
