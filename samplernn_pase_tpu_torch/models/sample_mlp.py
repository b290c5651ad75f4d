"""Sample-level MLP, as ``samplernn_pase_tpu.models.sample_mlp``: the
teacher-forced form (``mlp_apply``) and the decode step (``mlp_step``).

It embeds the last ``frame_size`` levels, adds the bottom tier's
conditioning row onto the first hidden layer, runs two ReLU layers and
projects to ``q_levels`` logits.
"""

from __future__ import annotations

import torch

from samplernn_pase_tpu_torch.ops import init as winit
from samplernn_pase_tpu_torch.ops import weight_norm as wnorm
from samplernn_pase_tpu_torch.ops.matmul import (
    matmul_dt, matmul_f32, torch_dtype)


def init_sample_mlp(gen: torch.Generator, frame_size: int, q_levels: int,
                    embed_dim: int, hidden: int,
                    use_weight_norm: bool = False) -> dict:
    flat_in = frame_size * embed_dim
    maybe_wn = wnorm.make if use_weight_norm else (lambda w: w)
    return {
        "embed": winit.uniform(gen, (q_levels, embed_dim), scale=1.0),
        # conv(kernel=frame_size) as a flat matmul weight, rows j*E + e
        "w_in": maybe_wn(winit.lecun_uniform(gen, (flat_in, hidden),
                                             fan_in=flat_in)),
        "b_in": torch.zeros(hidden),
        "w_h": maybe_wn(winit.lecun_uniform(gen, (hidden, hidden),
                                            fan_in=hidden)),
        "b_h": torch.zeros(hidden),
        "w_out": maybe_wn(winit.lecun_uniform(gen, (hidden, q_levels),
                                              fan_in=hidden)),
        "b_out": torch.zeros(q_levels),
    }


def _head(params, x, cond, compute_dtype) -> torch.Tensor:
    """x [.., flat_in] + cond [.., hidden] -> logits float32."""
    h = matmul_f32(x, wnorm.resolve(params["w_in"]), compute_dtype) \
        + params["b_in"]
    h = torch.relu(h + cond)
    h = torch.relu(matmul_f32(h, wnorm.resolve(params["w_h"]), compute_dtype)
                   + params["b_h"])
    return matmul_f32(h, wnorm.resolve(params["w_out"]), compute_dtype) \
        + params["b_out"]


def mlp_apply(params, samples, cond, frame_size: int, compute_dtype):
    """Teacher-forced logits for every position.

    samples [B, T + frame_size - 1] int levels at positions [t - f, t) for
    every target t; cond [B, T, hidden] bottom-tier conditioning.  Returns
    logits [B, T, q_levels] float32.  The embedding is a one-hot product
    and the window one valid convolution whose ``w_in`` rows are ordered
    ``j * E + e``; activations stay in compute dtype."""
    dt = torch_dtype(compute_dtype)
    q, e = params["embed"].shape
    hidden = params["b_h"].shape[0]
    oh = torch.nn.functional.one_hot(samples.long(), q).to(dt)
    emb = matmul_dt(oh, params["embed"], dt)                 # [B, T+f-1, E]
    w = wnorm.resolve(params["w_in"]).reshape(frame_size, e, hidden)
    x = torch.nn.functional.conv1d(
        emb.transpose(1, 2), w.to(dt).permute(2, 1, 0)).transpose(1, 2)
    h = torch.relu(x + params["b_in"].to(dt) + cond.to(dt))
    h = torch.relu(matmul_dt(h, wnorm.resolve(params["w_h"]), dt)
                   + params["b_h"].to(dt))
    return matmul_f32(h, wnorm.resolve(params["w_out"]), dt) \
        + params["b_out"]


def mlp_step(params, window, cond_vec, compute_dtype) -> torch.Tensor:
    """One decode step: window [B, frame_size] int levels, cond [B, hidden].

    Returns logits [B, q_levels] float32."""
    b = window.shape[0]
    emb = params["embed"][window.long()].reshape(b, -1)
    return _head(params, emb, cond_vec, compute_dtype)
