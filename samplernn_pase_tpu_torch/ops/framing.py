"""Framing, as ``samplernn_pase_tpu.ops.framing`` (``frame_signal``; the
host-side TBPTT batcher comes with ROADMAP.md A5)."""

from __future__ import annotations

import torch


def frame_signal(x: torch.Tensor, frame_size: int) -> torch.Tensor:
    """[..., T] -> [..., T // frame_size, frame_size]; T must divide evenly."""
    t = x.shape[-1]
    if t % frame_size != 0:
        raise ValueError(f"length {t} not divisible by frame_size {frame_size}")
    return x.reshape(*x.shape[:-1], t // frame_size, frame_size)
