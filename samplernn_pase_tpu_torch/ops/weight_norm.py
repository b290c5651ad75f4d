"""Weight normalization in the reference's functional form.

A normalized weight is stored as ``{"v": direction, "g": per-output gain}``
and materialized as ``g * v / sqrt(sum(v*v) + 1e-12)``, the sum running
over every axis but the last (the output features).  This is not
``torch.nn.utils.weight_norm``, which normalizes over the other axes.
``resolve`` passes a plain tensor through unchanged.
"""

from __future__ import annotations

import torch


def make(weight: torch.Tensor) -> dict:
    """Wrap an initialized weight into weight-norm ``{v, g}`` form."""
    axes = tuple(range(weight.ndim - 1))
    g = torch.sqrt(torch.sum(weight * weight, dim=axes))
    return {"v": weight, "g": g}


def resolve(w, group=None):
    """Materialize a (possibly weight-normed) weight parameter.

    ``group``: the ``model`` group over which ``v``'s leading (normalized)
    rows are split (a row-sharded ``w_out``): the squares are summed over
    it, and the gradients of the replicated gain and of the sum come back
    summed over the ranks (each rank's rows give a part of them).  Column
    shards resolve locally."""
    if isinstance(w, dict) and "v" in w:
        v, g = w["v"], w["g"]
        axes = tuple(range(v.ndim - 1))
        sq = torch.sum(v * v, dim=axes, keepdim=True)
        if group is not None:
            from samplernn_pase_tpu_torch.parallel.mesh import (
                enter_model, sum_differentiable)
            sq = sum_differentiable(sq, group)
            g = enter_model(g, group)
        return g * v / torch.sqrt(sq + 1e-12)
    return w
