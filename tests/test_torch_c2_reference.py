"""Config 2's model, the 3-tier LSTM SampleRNN, against the benchmark's plain
reference (``benchmark/reference/``, float32 PyTorch that imports nothing
of the port) on the CPU, at a tiny size: frame sizes (4, 2, 2), dim 32, one
and two LSTM layers a tier, weights from ``benchmark.weights.make_params``
(the benchmark's own), float32 products with TF32 off.

* ``forward``'s logits, NLL and every leaf's gradient, on a chunk that
  starts from the carried (h, c) state of the chunk before it, through
  K5's plain versions (``pallas_train_rnn=True``) and the autograd scan
  (``False``);
* one ``Trainer`` group of 8 steps on a corpus whose clips are 4 chunks
  long, so that the state crosses chunk boundaries and every lane resets
  to ``h0`` at step 4: its NLLs and its parameters after the group against
  ``benchmark/reference/train.py``.

Imports no JAX (the conftest does, for other files)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import samplernn as ref
from benchmark.reference import train as rtrain
from benchmark.weights import clone, leaves, make_params
from samplernn_pase_tpu_torch.config import SampleRNNConfig, TrainConfig
from samplernn_pase_tpu_torch.data.dataset import WavCorpus
from samplernn_pase_tpu_torch.models import samplernn
from samplernn_pase_tpu_torch.train.trainer import LoggerPlugin, Trainer

MODEL = {"frame_sizes": [4, 2, 2], "dim": 32, "n_rnn": 1, "rnn_type": "lstm",
         "q_levels": 256, "embed_dim": 8, "mlp_hidden": 32, "cond_dim": 0,
         "cond_rate": 0, "n_speakers": 0, "learn_h0": True,
         "weight_norm": False, "codec": "mulaw",
         "compute_dtype": "float32"}
B, T = 3, 32                    # lanes; targets a chunk (2 top frames)
ROUTES = {"kernel": True, "scan": False}

# Tolerances.  Both sides compute in float32 from the same weights; they
# differ only in the order of their sums (the reference multiplies the
# embedding into the MLP's first layer and steps the LSTM one product at a
# time; the port gathers and runs K5's plain version or the scan).  Read
# at these sizes: logits 3.6e-7 apart (of size 1.5), NLL 2.4e-7 relative,
# gradients 9e-7 of the leaf's largest element, the group's change 3.2e-7;
# each limit is about 10x that.  The port in bfloat16 reads logits 8.2e-3
# and the NLL 3.6e-5 away:
LOGITS = dict(rtol=0.0, atol=5e-6)
NLL = 2e-6                           # relative
GRAD = 1e-5                          # worst element over the leaf's largest
# Adam divides each moment by the root of the second, so a leaf's change
# is compared by norm (as the benchmark's ``change_gap``):
CHANGE = 5e-6


@pytest.fixture(autouse=True)
def full_float32():
    ref.full_float32()


def _cfg(n_rnn: int, route: bool = True) -> tuple[dict, SampleRNNConfig]:
    model = dict(MODEL, n_rnn=n_rnn)
    keys = {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in model.items()}
    return model, SampleRNNConfig(**keys, pallas_train_rnn=route)


def _levels(seed: int, shape) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g)


def _grad_leaves(params):
    return [t.detach().clone().requires_grad_(True)
            for _, t in leaves(params)]


def _gap(got, want) -> float:
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("n_rnn", [1, 2])
def test_forward_and_gradients_match_reference(n_rnn, route):
    model, cfg = _cfg(n_rnn, ROUTES[route])
    params = make_params(model, 1900 + n_rnn, "cpu")
    lb = cfg.lookback
    first, second = (_levels(s, (B, lb + T)) for s in (1, 2))
    with torch.no_grad():
        state = samplernn.initial_state(params, cfg, B)
        want_state = ref.initial_state(params, model, B)
        _, state = samplernn.forward(params, cfg, first, state)
        _, want_state = ref.forward(params, model, first, want_state)
    for got, want in zip(state, want_state):
        assert got.shape == want.shape == (n_rnn, 2, B, cfg.dim)
        torch.testing.assert_close(got, want, **LOGITS)

    p_leaves = _grad_leaves(params)
    p = rtrain.rebuild(params, p_leaves)
    logits, _ = samplernn.forward(p, cfg, second, state)
    nll = samplernn.nll_bits(logits, second[:, lb:])
    grads = torch.autograd.grad(nll, p_leaves, allow_unused=True)

    r_leaves = _grad_leaves(params)
    r = rtrain.rebuild(params, r_leaves)
    want_logits, _ = ref.forward(r, model, second, want_state)
    want_nll = rtrain.nll_bits(want_logits, second[:, lb:])
    want_grads = torch.autograd.grad(want_nll, r_leaves, allow_unused=True)

    assert logits.shape == (B, T, 256)
    torch.testing.assert_close(logits, want_logits, **LOGITS)
    nll, want_nll = float(nll.detach()), float(want_nll.detach())
    assert abs(nll - want_nll) <= NLL * want_nll
    names = [n for n, _ in leaves(params)]
    for name, g, w in zip(names, grads, want_grads):
        if name.endswith("h0"):
            # the state is read outside the differentiated function
            assert g is None and w is None, name
            continue
        assert _gap(g, w) <= GRAD, (name, _gap(g, w))


def _corpus(lb: int) -> tuple[WavCorpus, list]:
    """2 clips a lane of 4 chunks each, and the 8 batches the trainer's
    feed makes of them, worked out apart from it: clip i in lane i mod 2,
    each after ``lb`` levels of silence, cut into windows of ``lb + T``."""
    lanes = 2
    clips = [_levels(10 + i, (4 * T,)).numpy().astype(np.int32)
             for i in range(2 * lanes)]
    batches = []
    for step in range(8):
        rows = []
        for lane in range(lanes):
            clip = clips[lane + lanes * (step // 4)]
            padded = np.concatenate([np.full(lb, 128, np.int32), clip])
            k = step % 4
            rows.append(padded[k * T: k * T + lb + T])
        batches.append((torch.as_tensor(np.stack(rows)).long(),
                        torch.full((lanes,), step % 4 == 0)))
    return WavCorpus(clips, q_levels=256, val_frac=0.0), batches


class _Lines:
    def __init__(self):
        self.nll = []

    def write(self, **kv):
        if "nll_bits" in kv:
            self.nll.append(kv["nll_bits"])


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("n_rnn", [1, 2])
def test_trainer_group_matches_reference(n_rnn, route):
    model, cfg = _cfg(n_rnn, ROUTES[route])
    params = make_params(model, 1910 + n_rnn, "cpu")
    corpus, batches = _corpus(cfg.lookback)
    lr, clip = 0.01, 0.55
    lines = _Lines()
    tcfg = TrainConfig(batch_size=2, seq_len=T, lr=lr, grad_clip=clip,
                       steps_per_call=8, shuffle=False, epochs=1)
    trainer = Trainer(cfg, tcfg, corpus, plugins=[LoggerPlugin(lines, 1)],
                      params=clone(params), device="cpu")
    trainer.run()
    assert trainer.global_step == 8
    want = rtrain.run_steps(params, model, batches, lr, clip)
    # the clip acts on some steps and not on others
    assert min(want["norms"]) < clip < max(want["norms"])
    for got, w in zip(lines.nll, want["nll"]):
        assert abs(got - w) <= NLL * w
    assert len(lines.nll) == 8
    start = rtrain.tree_leaves(params)
    got = [t for _, t in leaves(trainer.params)]
    change = [a - s for a, s in zip(got, start)]
    want_change = [a - s for a, s in zip(want["params"], start)]
    skip = rtrain.still_leaves(want["grad"])
    gaps = rtrain.leaf_gaps(change, want_change, skip)
    assert max(g for g in gaps if g is not None) <= CHANGE, gaps
    # the h0 leaves get no gradient and stay where they started
    for (name, t), s in zip(leaves(trainer.params), start):
        if name.endswith("h0"):
            assert torch.equal(t, s)
    # steps 2-4 and 6-8 read the (h, c) state carried from the step before
    assert all(h.shape == (n_rnn, 2, 2, cfg.dim) for h in trainer.hiddens)
