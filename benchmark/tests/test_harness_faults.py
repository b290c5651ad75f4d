"""Each fault a cell can have, planted under a tiny run on the CPU, turns
``correct`` false: a token or a sample altered where it is produced (the
generation, streaming and batch-synthesis cells), a train step that returns
its state unchanged, half the batch left out of the loss, and faults of the
window's own multi-step call (its staging of a group, the hidden state
carried from step to step inside it)."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.scratch(tmp_path_factory.mktemp("faults"))


def altered(levels: torch.Tensor) -> torch.Tensor:
    """One sample of every lane moved half the level range away."""
    out = levels.clone()
    out[:, levels.shape[1] // 2] = (out[:, levels.shape[1] // 2] + 128) % 256
    return out


def run(root, cell, seed=17):
    return harness.execute(root, cell, seed, 0.5, False, "cpu")


def test_sound_runs_pass(root):
    for cell in tiny.CELLS:
        assert run(root, cell)["correct"], cell


def test_token_altered_in_generation(root, monkeypatch):
    from samplernn_pase_tpu_torch import generate
    orig = generate.generate_levels
    monkeypatch.setattr(generate, "generate_levels",
                        lambda *a, **k: altered(orig(*a, **k)))
    out = run(root, "tiny-gen")
    assert not out["correct"]
    assert out["checks"]["token_gap"]["value"] > 0.1


@pytest.mark.parametrize("cell", ["tiny-gen", "tiny-jobs"])
def test_waveform_altered(root, monkeypatch, cell):
    from samplernn_pase_tpu_torch import generate
    orig = generate.decode_waveform
    monkeypatch.setattr(generate, "decode_waveform",
                        lambda lv, cfg: orig(lv, cfg) * 0.99)
    out = run(root, cell)
    assert not out["correct"]
    assert out["checks"]["wave_err"]["value"] > out["checks"]["wave_err"][
        "limit"]


@pytest.mark.parametrize("cell", ["tiny-stream", "tiny-jobs"])
def test_token_altered_in_the_pool(root, monkeypatch, cell):
    from samplernn_pase_tpu_torch import serve
    orig = serve.StreamPool.emit
    monkeypatch.setattr(serve.StreamPool, "emit",
                        lambda self, n: altered(orig(self, n)))
    out = run(root, cell)
    assert not out["correct"]
    assert out["checks"]["token_gap"]["value"] > 0.1


def frozen_multi(make):
    """A multi-step call that returns the state it was given."""
    def build(*a, **k):
        multi = make(*a, **k)

        def step(params, opt_state, hiddens, *b, **kw):
            _, _, h, nlls = multi(params, opt_state, hiddens, *b, **kw)
            return params, opt_state, h, nlls
        return step
    return build


def uncarried_multi(cfg, tx, mesh=None):
    """A multi-step call whose every step starts from the group's first
    hidden state instead of the previous step's."""
    single = trainer_module().make_train_step(cfg, tx, mesh)

    def step(params, opt_state, hiddens, xs, ys, rs, **kw):
        nlls = []
        for i in range(xs.shape[0]):
            params, opt_state, _, nll = single(
                params, opt_state, hiddens, xs[i], ys[i], rs[i], **kw)
            nlls.append(nll)
        return params, opt_state, hiddens, torch.stack(nlls)
    return step


def trainer_module():
    from samplernn_pase_tpu_torch.train import trainer
    return trainer


@pytest.mark.parametrize("where", ["train_one", "multi"])
def test_step_returns_state_unchanged(root, monkeypatch, where):
    trainer = trainer_module()
    if where == "train_one":
        orig = trainer._train_one

        def frozen(cfg, tx, params, opt_state, hiddens, *a, **k):
            _, _, h, nll = orig(cfg, tx, params, opt_state, hiddens, *a,
                                **k)
            return params, opt_state, h, nll

        monkeypatch.setattr(trainer, "_train_one", frozen)
    else:
        monkeypatch.setattr(trainer, "make_multi_train_step",
                            frozen_multi(trainer.make_multi_train_step))
    out = run(root, "tiny-train")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_hiddens_not_carried_inside_the_group(root, monkeypatch):
    trainer = trainer_module()
    monkeypatch.setattr(trainer, "make_multi_train_step", uncarried_multi)
    out = run(root, "tiny-train")
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"][
        "limit"]


def test_group_staged_with_its_first_batch(root, monkeypatch):
    trainer = trainer_module()
    orig = trainer.Trainer._stage_group

    def stage(self, group):
        kind, (xs, ys, rs), kwargs = orig(self, group)
        if kind == "multi":
            xs, ys = xs[:1].expand_as(xs), ys[:1].expand_as(ys)
        return kind, (xs, ys, rs), kwargs

    monkeypatch.setattr(trainer.Trainer, "_stage_group", stage)
    out = run(root, "tiny-train")
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"][
        "limit"]


def test_half_the_batch_left_out(root, monkeypatch):
    from samplernn_pase_tpu_torch.models import samplernn

    def half(params, cfg, inputs, targets, state, *a, **k):
        logits, new_state = samplernn.forward(params, cfg, inputs, state)
        b = inputs.shape[0] // 2
        return samplernn.nll_bits(logits[:b], targets[:b]), new_state

    monkeypatch.setattr(samplernn, "loss_fn", half)
    out = run(root, "tiny-train")
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"][
        "limit"]
