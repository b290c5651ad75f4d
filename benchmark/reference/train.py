"""Plain truncated-BPTT training of SampleRNN, float32: the reference that the
training cell's first steps are held to.

A step resets the state of the lanes that start an utterance to ``h0``
(read outside the differentiated function, so ``h0`` gets no gradient),
takes the mean negative log-likelihood in bits of every target, its
gradient by autograd, clips the gradient by its global norm and applies
Adam (Kingma and Ba, 2015: bias-corrected moments, epsilon outside the
square root); the state carries to the next step detached.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import samplernn as ref


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def rebuild(tree, values):
    it = iter(values)

    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, list):
            return [go(v) for v in node]
        return next(it)
    return go(tree)


def nll_bits(logits, targets):
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - picked).mean() / math.log(2.0)


def run_steps(params, cfg, batches, lr: float, clip: float,
              precision: str = "float32", b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> dict:
    """Train from ``params`` over ``batches`` (each (inputs [B, lookback +
    T], resets [B] bool)).  Returns the NLL of each step, the clipped
    gradient of the first step, Adam's first moment and the parameters
    after the last step (the leaves in tree order), and each step's
    gradient norm before the clip."""
    ref.full_float32()
    leaves = [t.detach().clone() for t in tree_leaves(params)]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    lb = ref.lookback(cfg)
    state = None
    nlls, norms, first = [], [], None
    for count, (inputs, resets) in enumerate(batches, start=1):
        p_leaves = [t.requires_grad_(True) for t in leaves]
        p = rebuild(params, p_leaves)
        if state is None:
            state = ref.initial_state(p, cfg, inputs.shape[0])
        state = ref.reset_lanes(p, cfg, [s.detach() for s in state], resets)
        logits, state = ref.forward(p, cfg, inputs, state,
                                    precision=precision)
        nll = nll_bits(logits, inputs[:, lb:].long())
        grads = torch.autograd.grad(nll, p_leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if norm >= clip:
                grads = [g / norm * clip for g in grads]
            if first is None:
                first = [g.clone() for g in grads]
            c1, c2 = 1 - b1 ** count, 1 - b2 ** count
            new = []
            for i, (t, g) in enumerate(zip(leaves, grads)):
                mu[i] = (1 - b1) * g + b1 * mu[i]
                nu[i] = (1 - b2) * g * g + b2 * nu[i]
                new.append(t.detach() - lr * (mu[i] / c1)
                           / (torch.sqrt(nu[i] / c2) + eps))
            leaves = new
        nlls.append(float(nll.detach()))
        norms.append(float(norm))
        state = [s.detach() for s in state]
    return {"nll": nlls, "grad": first, "mu": mu, "params": leaves,
            "norms": norms}


def leaf_gaps(prog: list, want: list, skip=frozenset()) -> list:
    """Each leaf's gap between two norms: ``| |prog_i| - |want_i| |`` over
    the larger of ``|want_i|`` and the median leaf's ``|want|``; None for
    the leaves in ``skip``."""
    pn = [float(torch.linalg.vector_norm(t.float())) for t in prog]
    wn = [float(torch.linalg.vector_norm(t.float())) for t in want]
    med = sorted(wn)[len(wn) // 2]
    return [None if i in skip else abs(a - b) / max(b, med, 1e-30)
            for i, (a, b) in enumerate(zip(pn, wn))]


def leaf_gap(prog: list, want: list, skip=frozenset()) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(g for g in leaf_gaps(prog, want, skip) if g is not None)


def still_leaves(grad: list, rel: float = 1e-3) -> set:
    """Leaves whose reference gradient is nought to rounding: a norm under
    ``rel`` of the median leaf's (Adam moves them by round-off alone)."""
    n = [float(torch.linalg.vector_norm(g)) for g in grad]
    med = sorted(n)[len(n) // 2]
    return {i for i, v in enumerate(n) if v < rel * med}
