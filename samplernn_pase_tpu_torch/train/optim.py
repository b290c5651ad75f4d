"""Optimizer factory, as ``samplernn_pase_tpu.train.optim``: Adam with
global-norm gradient clipping and a learning-rate schedule, written over
the port's parameter trees (dicts and lists of tensors) with optax's
formulas.

``make_optimizer`` returns an ``Optimizer`` with optax's two functions:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; ``apply_updates(params, updates)`` adds them.  The state is
``{"count": int, "mu": tree, "nu": tree}`` with zero moments at init,
the same values as optax's ``adam`` state.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map


def make_schedule(lr: float, schedule: str = "constant",
                  warmup_steps: int = 0, decay_steps: int = 100_000,
                  end_lr_frac: float = 0.1) -> Callable[[int], float]:
    """'constant' | 'cosine' | 'exponential', each with optional linear
    warmup from 0; the base schedule's count restarts at warmup_steps
    (optax.join_schedules)."""
    if schedule == "constant":
        def base(count):
            return lr
    elif schedule == "cosine":
        def base(count):
            c = min(count, decay_steps)
            decay = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return lr * ((1 - end_lr_frac) * decay + end_lr_frac)
    elif schedule == "exponential":
        def base(count):
            if count <= 0:
                return lr
            return lr * end_lr_frac ** (count / decay_steps)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if not warmup_steps:
        return base

    def joined(count):
        if count < warmup_steps:
            c = min(max(count, 0), warmup_steps)
            return lr - lr * (1 - c / warmup_steps)
        return base(count - warmup_steps)
    return joined


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def make_optimizer(lr: float = 1e-3, grad_clip: float = 1.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   schedule: str = "constant", warmup_steps: int = 0,
                   decay_steps: int = 100_000) -> Optimizer:
    """Clip by global norm (when grad_clip > 0), then Adam with bias
    correction and ``eps`` outside the square root, scaled by the
    schedule's learning rate at the step count."""
    lr_at = make_schedule(lr, schedule, warmup_steps, decay_steps)

    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        return {"count": 0, "mu": zeros,
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        if grad_clip and grad_clip > 0:
            leaves = tree_leaves(grads)
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
            keep = g_norm < grad_clip
            grads = tree_map(
                lambda g: torch.where(keep, g, g / g_norm * grad_clip),
                grads)
        count = state["count"] + 1
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state["nu"])
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        step = -lr_at(state["count"])
        updates = tree_map(
            lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps) * step,
            mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
