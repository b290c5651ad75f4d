"""Weight initialization: LeCun-uniform projections, orthogonal recurrent
blocks, uniform embeddings, zero biases.  Each function draws from an explicit
``torch.Generator`` (CPU), so a seed gives the same weights on every
device; the caller moves them.  The numbers differ from ``jax.random``'s
for the same seed: cross-framework tests carry JAX weights over through
``convert.params_from_jax`` instead.
"""

from __future__ import annotations

import math

import torch


def lecun_uniform(gen: torch.Generator, shape, fan_in: int | None = None,
                  dtype=torch.float32) -> torch.Tensor:
    if fan_in is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
    bound = math.sqrt(3.0 / fan_in)
    return uniform(gen, shape, bound, dtype)


def orthogonal(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Orthogonal init of a 2-D matrix, as ``jax.nn.initializers.orthogonal``:
    QR of a normal draw, columns signed by ``diag(R)``."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.contiguous().to(dtype)


def uniform(gen: torch.Generator, shape, scale: float,
            dtype=torch.float32) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return (u * (2.0 * scale) - scale).to(dtype)


def zeros(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype)
