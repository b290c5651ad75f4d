"""The one converter between the JAX package's pytrees and the port's.

Every layout choice lives here.  The port keeps the JAX layouts as they
are, so conversion is a copy of each leaf:

* ``x @ W`` weights stay ``[in, out]`` (``w_in``, ``w_ih``, ``w_hh``,
  ``w_up``, the MLP's ``w_in``/``w_h``/``w_out``); the MLP's ``w_in`` rows
  are ordered ``j * embed_dim + e`` (window position-major);
* weight-norm leaves stay ``{"v", "g"}`` dicts, resolved at use;
* biases keep their shapes (``b_up`` is ``[frame_size, dim]``);
* tier states stay ``[n_rnn, B, dim]`` (GRU) or ``[n_rnn, 2, B, dim]``
  (LSTM), one array per tier, bottom tier first;
* PASE conv weights stay ``[out, in, k]`` (both frameworks' layout) and
  its BatchNorm state ``{"mean", "var", "count"}`` keeps the 0-d float32
  ``count``.

The arguments are trees of numpy arrays (``jax.device_get`` of the JAX
params), so this module needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from samplernn_pase_tpu_torch.tree import tree_map


def _leaf_to_torch(device):
    def fn(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    return fn


def params_from_jax(tree, device="cpu") -> dict:
    """JAX parameter pytree ``{"tiers": [...], "mlp": {...}}`` of numpy
    arrays -> the port's dict of tensors on ``device``, same structure."""
    return tree_map(_leaf_to_torch(device), tree)


def pase_from_jax(params, bn_state, device="cpu") -> tuple:
    """The JAX package's PASE encoder ``(params, bn_state)`` -> the port's
    two trees on ``device``."""
    return params_from_jax(params, device), params_from_jax(bn_state, device)


def joint_from_jax(params, bn_state, device="cpu") -> tuple:
    """A joint model's ``({"srnn": ..., "pase": ...}, bn_state)`` -> the
    port's two trees on ``device``."""
    if set(params) != {"srnn", "pase"}:
        raise ValueError(f"a joint tree has keys srnn and pase, got "
                         f"{sorted(params)}")
    return pase_from_jax(params, bn_state, device)


def state_from_jax(states, device="cpu") -> tuple:
    """Tuple of per-tier JAX states -> tuple of tensors, same layout."""
    return tuple(tree_map(_leaf_to_torch(device), list(states)))


def experiment_from_jax(restored) -> dict:
    """A checkpoint as the reference's ``CheckpointManager.restore()``
    returns it -> the port's checkpoint payload ``{"step", "params"}``
    (CPU tensors), for ``CheckpointManager(dir).save(payload["step"],
    payload["params"])``.  ``params`` is the model's tree, or a joint
    run's ``{"joint": {"srnn", "pase"}, "bn": bn_state}``.  The optimizer
    state is not carried: a resume across frameworks is not supported."""
    p = restored["params"]
    if isinstance(p, dict) and "joint" in p:
        joint, bn = joint_from_jax(p["joint"], p["bn"])
        params = {"joint": joint, "bn": bn}
    else:
        params = params_from_jax(p)
    return {"step": int(restored["step"]), "params": params}


def to_numpy(tree):
    """The inverse: a tree of tensors -> the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
