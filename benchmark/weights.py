"""Random SampleRNN weights from the seed, made on the device.

The tree is the layout the port's entry points take (``samplernn.init_params``
gives the same keys and shapes): per tier ``w_in``, ``b_in``, ``w_up``,
``b_up``, ``rnn`` (per layer ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``),
``w_cond`` when conditioned and ``h0`` with ``learn_h0``; the MLP's
``embed``, ``w_in``, ``b_in``, ``w_h``, ``b_h``, ``w_out``, ``b_out``.
Every value is drawn in one ``torch.rand`` call on a generator on the
device, scaled per leaf (LeCun-uniform matrices, biases and ``h0`` within
0.1, the embedding within 1) and rounded to bfloat16, the type the port
serves them in; the tree holds them as float32, as the port's parameters
are.  Weight-normed matrices get a gain of 0.75-1.25 times their columns'
norm, so that a program which skipped the normalisation would show.
"""

from __future__ import annotations

import math

import torch


def _plan(cfg: dict) -> list:
    """(path, shape, scale, weight_norm) for every leaf, in tree order."""
    h, q, e = cfg["dim"], cfg["q_levels"], cfg["embed_dim"]
    gates = {"gru": 3, "lstm": 4}[cfg["rnn_type"]]
    wn = bool(cfg.get("weight_norm"))
    out = []
    span = 1
    for k, f in enumerate(cfg["frame_sizes"]):
        span *= f
        t = ("tiers", k)
        out += [(t + ("w_in",), (span, h), math.sqrt(3 / span), wn),
                (t + ("b_in",), (h,), 0.1, False),
                (t + ("w_up",), (h, f * h), math.sqrt(3 / h), wn),
                (t + ("b_up",), (f, h), 0.1, False)]
        for i in range(cfg["n_rnn"]):
            r = t + ("rnn", i)
            out += [(r + ("w_ih",), (h, gates * h), math.sqrt(3 / h), False),
                    (r + ("w_hh",), (h, gates * h), math.sqrt(3 / h), False),
                    (r + ("b_ih",), (gates * h,), 0.1, False),
                    (r + ("b_hh",), (gates * h,), 0.1, False)]
        if cfg.get("cond_dim"):
            d = cfg["cond_dim"]
            out.append((t + ("w_cond",), (d, h), math.sqrt(3 / d), False))
        if cfg.get("learn_h0", True):
            shape = ((cfg["n_rnn"], 1, h) if cfg["rnn_type"] == "gru"
                     else (cfg["n_rnn"], 2, 1, h))
            out.append((t + ("h0",), shape, 0.1, False))
    f1 = cfg["frame_sizes"][0]
    m = ("mlp",)
    out += [(m + ("embed",), (q, e), 1.0, False),
            (m + ("w_in",), (f1 * e, h), math.sqrt(3 / (f1 * e)), wn),
            (m + ("b_in",), (h,), 0.1, False),
            (m + ("w_h",), (h, h), math.sqrt(3 / h), wn),
            (m + ("b_h",), (h,), 0.1, False),
            (m + ("w_out",), (h, q), math.sqrt(3 / h), wn),
            (m + ("b_out",), (q,), 0.1, False)]
    return out


def _put(tree: dict, path: tuple, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        node.append(value)
    else:
        node[path[-1]] = value


def make_params(cfg: dict, seed: int, device) -> dict:
    """The weights of model ``cfg`` (the configuration file's ``model``)
    for ``seed``, on ``device``."""
    plan = _plan(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in plan]
    n_gain = sum(shape[-1] for _, shape, _, wn in plan if wn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes) + n_gain, generator=gen, device=device)
    u = (u * 2.0 - 1.0).to(torch.bfloat16).to(torch.float32)
    tree: dict = {}
    at = 0
    gains = u[sum(sizes):]
    g_at = 0
    for (path, shape, scale, wn), size in zip(plan, sizes):
        leaf = (u[at:at + size] * scale).view(shape)
        at += size
        if wn:
            cols = shape[-1]
            norm = torch.sqrt(torch.sum(leaf * leaf, dim=0))
            g = (norm * (1.0 + 0.25 * gains[g_at:g_at + cols])).to(
                torch.bfloat16).to(torch.float32)
            g_at += cols
            leaf = {"v": leaf, "g": g}
        _put(tree, path, leaf)
    return tree


def clone(tree):
    """A copy of a tree whose tensors share no storage with it."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.detach().clone()


def leaves(tree, prefix: str = "") -> list:
    """(dotted path, tensor) of every leaf, in tree order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]
