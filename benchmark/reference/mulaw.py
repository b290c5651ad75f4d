"""8-bit mu-law as in samplernn-pytorch's ``utils.py``: encode rounds
half up (``floor(v + 0.5)``), float32 throughout."""

from __future__ import annotations

import math

import torch


def decode(levels: torch.Tensor, q_levels: int) -> torch.Tensor:
    mu = float(q_levels - 1)
    y = 2.0 * (levels.to(torch.float32) / mu) - 1.0
    return torch.sign(y) * torch.expm1(torch.abs(y) * math.log1p(mu)) / mu


def encode(x: torch.Tensor, q_levels: int) -> torch.Tensor:
    mu = float(q_levels - 1)
    x = torch.clamp(x.to(torch.float32), -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    lv = torch.floor((y + 1.0) * 0.5 * mu + 0.5)
    return torch.clamp(lv, 0, q_levels - 1).to(torch.int64)


def to_float(levels: torch.Tensor, q_levels: int) -> torch.Tensor:
    """A frame tier's real-valued input, ``l / (Q / 2) - 1``."""
    return levels.to(torch.float32) / (q_levels / 2.0) - 1.0
