"""The frozen bound and FLOP arithmetic reproduces the numbers the port's
performance record keeps for these shapes, and the whole step's share of
the peak counts the model, not a route's arrangement of it."""

from __future__ import annotations

import json

import pytest

from benchmark import flops
from benchmark.tests import tiny


def model(name: str) -> dict:
    return json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())[
        "model"]


def test_k1_bound_per_bottom_frame():
    secs, by = flops.k1_bound(model("srnnpt_default"), 128)
    assert by == "bytes"
    assert round(secs * 1e6, 2) == 5.82


def test_k4_bounds_mean_over_the_tiers():
    cfg = model("srnnpt_default")
    fwd, bwd = zip(*(flops.seq_bounds("gru", 1024 // span, 128, 1024)
                     for span in flops.spans(cfg)))
    assert round(sum(f[0] for f in fwd) / 2 * 1e6, 1) == 65.1
    assert round(sum(b[0] for b in bwd) / 2 * 1e6, 1) == 130.3
    assert fwd[0][1] == bwd[0][1] == "operations"


def test_stacked_train_step_bound():
    t = flops.train_step_flops(model("srnnpt_default"), 128, 1024)
    assert round(t / flops.PEAK_BF16 * 1e3, 2) == 6.10


def test_model_flops_from_the_parameter_shapes():
    """Per sample, every matrix of the architecture once at its rate: a
    frame tier's matrices once per ``span`` samples, the MLP's once per
    sample, the embedding a lookup."""
    from benchmark.weights import _plan
    for name in ("srnnpt_default", "c4_tts"):
        cfg = model(name)
        spans = flops.spans(cfg)
        macs = 0.0
        for path, shape, _, _ in _plan(cfg):
            if len(shape) != 2 or path[-1] in ("b_up", "embed"):
                continue
            rate = 1.0 if path[0] == "mlp" else 1.0 / spans[path[1]]
            macs += shape[0] * shape[1] * rate
        assert flops.model_flops_per_sample(cfg) == pytest.approx(2 * macs)


def test_mfu_does_not_change_with_the_embedding_folded():
    """Folding the embedding into the MLP's first layer (W' = embed @ w_in,
    one [q, dim] table per window position, as the generation kernels and
    the reference hold it) gives the same logits as the one-hot product of
    the train step, so it is the same model: mfu counts that model (its
    train-step count less the one-hot product is the forward mfu counts,
    three times), whatever a route computes."""
    import torch

    from benchmark.reference import samplernn as ref
    from benchmark.weights import make_params
    cfg = dict(tiny.TINY_MODEL)
    p = make_params(cfg, 3, "cpu")
    f1, q, e = cfg["frame_sizes"][0], cfg["q_levels"], cfg["embed_dim"]
    lv = torch.randint(0, q, (2, 40), generator=torch.Generator().manual_seed(
        0))
    upper = torch.randn(2, 40 - f1 + 1, cfg["dim"])
    table = ref.mlp_table(p, cfg, "float32")
    folded = ref.mlp_logits(p, cfg, lv, upper, table, "float32")
    onehot = torch.nn.functional.one_hot(lv, q).float() @ p["mlp"]["embed"]
    win = torch.stack([onehot[:, j:j + upper.shape[1]] for j in range(f1)],
                      dim=2).reshape(2, upper.shape[1], f1 * e)
    m = p["mlp"]
    h = torch.relu(win @ ref.resolve(m["w_in"]) + m["b_in"] + upper)
    h = torch.relu(h @ ref.resolve(m["w_h"]) + m["b_h"])
    plain = h @ ref.resolve(m["w_out"]) + m["b_out"]
    assert torch.allclose(folded, plain, atol=1e-4, rtol=1e-4)
    for name in ("srnnpt_default", "c4_tts"):
        cfg = model(name)
        b, t, rate = 128, 1024, 5e6
        hot = 2.0 * b * (t + cfg["frame_sizes"][0] - 1) * (
            cfg["q_levels"] * cfg["embed_dim"])
        if not cfg["cond_dim"]:
            step = flops.train_step_flops(cfg, b, t)
            assert step / 3 - hot == pytest.approx(
                flops.model_flops_per_sample(cfg) * b * t)
        assert flops.mfu_percent(cfg, rate, True) == pytest.approx(
            3 * flops.mfu_percent(cfg, rate, False))
