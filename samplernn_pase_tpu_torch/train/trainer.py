"""TBPTT step functions, as ``samplernn_pase_tpu.train.trainer``
(``make_train_step``, ``make_eval_step`` and their multi-step forms; the
``Trainer`` loop, its plugins and checkpoints come with ROADMAP.md A5/A6).

A step resets the hiddens of lanes whose reset flag is set, runs the
teacher-forced loss, and returns the new hiddens detached: the step
boundary is the TBPTT cut (the reference's ``hidden.detach()``).  As in
the reference, ``reset_state`` reads the parameters outside the
differentiated function, so a learned ``h0`` gets no gradient from a
step and Adam leaves it as it is.  Parameters and optimizer state come
back as new trees.
"""

from __future__ import annotations

import torch

from samplernn_pase_tpu_torch.config import SampleRNNConfig
from samplernn_pase_tpu_torch.models import samplernn
from samplernn_pase_tpu_torch.train.optim import Optimizer, apply_updates
from samplernn_pase_tpu_torch.tree import (
    tree_leaves, tree_map, tree_unflatten)


def _reset(params, cfg, hiddens, resets):
    with torch.no_grad():
        return samplernn.reset_state(params, cfg,
                                     tuple(h.detach() for h in hiddens),
                                     resets)


def _train_one(cfg, tx, params, opt_state, hiddens, inputs, targets, resets,
               cond, speakers, valid):
    hiddens = _reset(params, cfg, hiddens, resets)
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    nll, new_h = samplernn.loss_fn(p, cfg, inputs, targets, hiddens, cond,
                                   speakers, valid)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(nll, leaves, allow_unused=True)
    grads = tree_unflatten(p, [torch.zeros_like(x) if g is None else g
                               for x, g in zip(leaves, grads)])
    updates, opt_state = tx.update(grads, opt_state, params)
    params = apply_updates(params, updates)
    return (params, opt_state, tuple(h.detach() for h in new_h),
            nll.detach())


def make_train_step(cfg: SampleRNNConfig, tx: Optimizer):
    """The TBPTT train step: (params, opt_state, hiddens, inputs, targets,
    resets[, cond, speakers, valid]) -> (params, opt_state, hiddens,
    nll_bits)."""

    def step(params, opt_state, hiddens, inputs, targets, resets, cond=None,
             speakers=None, valid=None):
        return _train_one(cfg, tx, params, opt_state, hiddens, inputs,
                          targets, resets, cond, speakers, valid)

    return step


def _at(v, k):
    return None if v is None else v[k]


def make_multi_train_step(cfg: SampleRNNConfig, tx: Optimizer):
    """K train steps in one call: batches staged as [K, B, ...]; the math
    is K single steps.  Returns (params, opt_state, hiddens, nlls [K])."""

    def multi(params, opt_state, hiddens, xs, ys, rs, cond=None,
              speakers=None, valid=None):
        nlls = []
        for k in range(xs.shape[0]):
            params, opt_state, hiddens, nll = _train_one(
                cfg, tx, params, opt_state, hiddens, xs[k], ys[k], rs[k],
                _at(cond, k), _at(speakers, k), _at(valid, k))
            nlls.append(nll)
        return params, opt_state, hiddens, torch.stack(nlls)

    return multi


def _eval_one(cfg, params, hiddens, inputs, targets, resets, cond, speakers,
              valid):
    with torch.no_grad():
        hiddens = _reset(params, cfg, hiddens, resets)
        nll, new_h = samplernn.loss_fn(params, cfg, inputs, targets, hiddens,
                                       cond, speakers, valid)
    return new_h, nll


def make_eval_step(cfg: SampleRNNConfig):
    """(params, hiddens, inputs, targets, resets[, cond, speakers, valid])
    -> (hiddens, nll_bits), without gradients."""

    def step(params, hiddens, inputs, targets, resets, cond=None,
             speakers=None, valid=None):
        return _eval_one(cfg, params, hiddens, inputs, targets, resets, cond,
                         speakers, valid)

    return step


def make_multi_eval_step(cfg: SampleRNNConfig):
    """K staged eval batches [K, B, ...] in one call; returns (hiddens,
    nlls [K]), each the masked mean of its batch."""

    def multi(params, hiddens, xs, ys, rs, cond=None, speakers=None,
              valid=None):
        nlls = []
        for k in range(xs.shape[0]):
            hiddens, nll = _eval_one(cfg, params, hiddens, xs[k], ys[k],
                                     rs[k], _at(cond, k), _at(speakers, k),
                                     _at(valid, k))
            nlls.append(nll)
        return hiddens, torch.stack(nlls)

    return multi
