"""The port's training slice against the JAX package, on the CPU in
float32: the teacher-forced forward and NLL over the configuration
matrix, the TBPTT train and eval steps, the optimizer and its schedules,
and the entry points' device default.  Parameters are the JAX package's,
carried across by convert.params_from_jax; inputs come from a seed with
numpy.  Tolerances: logits 2e-4 and NLL 1e-4 bits, the bar of
tests/test_torch_oracle.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu.train import optim as joptim
from samplernn_pase_tpu.train import trainer as jtrainer
from samplernn_pase_tpu_torch import convert, graft_entry
from samplernn_pase_tpu_torch.config import SampleRNNConfig as TCfg
from samplernn_pase_tpu_torch.device import resolve_device
from samplernn_pase_tpu_torch.models import samplernn as tsrnn
from samplernn_pase_tpu_torch.train import optim as toptim
from samplernn_pase_tpu_torch.train import trainer as ttrainer
from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map

B = 3
BASE = dict(frame_sizes=(4, 2), dim=16, embed_dim=8,
            compute_dtype="float32")


def _models(seed=0, **overrides):
    kw = {**BASE, **overrides}
    jc = JCfg(**kw)
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed), jc))
    for tier in jp["tiers"]:
        if "h0" in tier:      # a learned h0 that is not zero
            tier["h0"] = tier["h0"] + 0.3
    return jc, TCfg(**kw), jp, convert.params_from_jax(jp)


def _batch(cfg, seed, t_mult=4):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.q_levels, (B, cfg.lookback * (1 + t_mult)),
                     np.int32)
    extra = {}
    if cfg.cond_dim:
        t = cfg.lookback * t_mult
        extra["cond"] = rng.normal(
            size=(B, t // cfg.cond_rate, cfg.cond_dim)).astype(np.float32)
    if cfg.n_speakers:
        extra["speakers"] = rng.integers(0, cfg.n_speakers, (B,), np.int32)
    return x, extra


# (config overrides, valid per lane or None); T = 32 at lookback 8
CASES = {
    "gru": ({}, None),
    "lstm": ({"rnn_type": "lstm"}, None),
    "three_tiers": ({"frame_sizes": (4, 2, 2)}, None),
    "n_rnn2": ({"n_rnn": 2}, None),
    "zero_h0": ({"learn_h0": False}, None),
    "weight_norm": ({"weight_norm": True}, None),
    "cond_speakers": ({"cond_dim": 4, "cond_rate": 8, "n_speakers": 3},
                      None),
    "valid": ({}, [32, 13, 0]),
    "all_padding": ({}, [0, 0, 0]),
    "remat": ({"remat": True}, None),
    "kernel_route": ({"pallas_train_rnn": True, "dim": 128}, None),
    "scan_route": ({"pallas_train_rnn": False, "n_rnn": 2}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_nll_match_jax(case):
    overrides, valid = CASES[case]
    jc, tc, jp, tp = _models(**overrides)
    x, extra = _batch(jc, 1)
    y = x[:, jc.lookback:]
    jstate = jsrnn.initial_state(jp, jc, B)
    tstate = tsrnn.initial_state(tp, tc, B)
    jlog, jnew = jsrnn.forward(jp, jc, jnp.asarray(x), jstate,
                               **{k: jnp.asarray(v) for k, v in extra.items()})
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    tlog, tnew = tsrnn.forward(tp, tc, torch.from_numpy(x), tstate, **textra)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-4)
    for a, b in zip(tnew, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)
    tv = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    jn = float(jsrnn.nll_bits(jlog, jnp.asarray(y), jv))
    tn = float(tsrnn.nll_bits(tlog, torch.from_numpy(y), tv))
    assert abs(tn - jn) < 1e-4, (tn, jn)
    if case == "all_padding":
        assert tn == 0.0
    if case == "kernel_route":
        # the model-level gradient through the sequence kernel's plain
        # versions against the JAX Pallas kernel (interpret)
        def jloss(p):
            return jsrnn.loss_fn(p, jc, jnp.asarray(x), jnp.asarray(y),
                                 jstate)[0]

        jg = jax.tree.leaves(jax.grad(jloss)(jp))
        tleaves = tree_map(
            lambda t: t.detach().requires_grad_(True), tp)
        nll, _ = tsrnn.loss_fn(tleaves, tc, torch.from_numpy(x),
                               torch.from_numpy(y), tstate)
        tg = torch.autograd.grad(nll, tree_leaves(tleaves),
                                 allow_unused=True)
        for g, w in zip(tg, jg):
            g = np.zeros_like(w) if g is None else g.numpy()
            np.testing.assert_allclose(g, np.asarray(w), atol=5e-4,
                                       rtol=5e-4)


@pytest.mark.parametrize("flag,rnn_type,raises", [
    (True, "gru", ValueError), ("auto", "gru", ValueError),
    (True, "lstm", ValueError), ("auto", "lstm", ValueError),
    (False, "gru", None), (False, "lstm", None)])
def test_cuda_route_refuses_what_the_kernel_cannot_take(flag, rnn_type,
                                                        raises):
    """On CUDA only pallas_train_rnn=False scans: a GRU or LSTM tier of a
    width the sequence kernels do not tile (dim 100, not a multiple of 8)
    raises under True/"auto".  The width is refused before the kernel
    library is asked, so no card is needed."""
    cfg = TCfg(**{**BASE, "dim": 100, "rnn_type": rnn_type,
                  "pallas_train_rnn": flag})
    if raises is None:
        assert tsrnn._rnn_route(cfg, 0, torch.device("cuda")) is False
        return
    with pytest.raises(raises, match="dim 100 is not a multiple of 8"):
        tsrnn._rnn_route(cfg, 0, torch.device("cuda"))


def test_state_helpers_match_jax():
    jc, tc, jp, tp = _models(rnn_type="lstm", n_rnn=2)
    rng = np.random.default_rng(2)
    state = tuple(rng.normal(size=(2, 2, B, 16)).astype(np.float32)
                  for _ in range(jc.n_tiers))
    resets = np.array([1, 0, 1], np.float32)
    want = jsrnn.reset_state(jp, jc, tuple(map(jnp.asarray, state)),
                             jnp.asarray(resets))
    got = tsrnn.reset_state(tp, tc, tuple(map(torch.from_numpy, state)),
                            torch.from_numpy(resets))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tsrnn.slice_state_lane(got, 1),
                    jsrnn.slice_state_lane(want, 1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tsrnn.cond_index(7, 4, 6).numpy(), np.asarray(jsrnn.cond_index(7, 4,
                                                                       6)))


# Adam turns every gradient component well above eps into a step of
# about lr, so a component whose sign differed between the frameworks
# would move its parameter by 2 * lr = 2e-3 per step; the bound 1e-5 is
# far below that and far above the float32 differences of the sums
# (about 1e-7 here), so any wrong step or sign fails it.
# (grad clip, model overrides): the base GRU model clipped and not, and
# four models with cond, speakers, weight norm, stacked layers, no h0, a
# small q and f1 = 1, each with the clip at 1.0
TRAIN_CASES = {
    "clipped": (1e-3, {}),
    "unclipped": (1e3, {}),
    "lstm3_cond_spk_wn": (1.0, {"rnn_type": "lstm",
                                "frame_sizes": (4, 2, 2), "cond_dim": 4,
                                "cond_rate": 8, "n_speakers": 3,
                                "weight_norm": True}),
    "gru_n_rnn2_cond_spk": (1.0, {"n_rnn": 2, "cond_dim": 4, "cond_rate": 8,
                                  "n_speakers": 2}),
    "lstm_n_rnn2_no_h0_q64": (1.0, {"rnn_type": "lstm", "n_rnn": 2,
                                    "learn_h0": False, "q_levels": 64}),
    "gru_f1_1": (1.0, {"frame_sizes": (4, 1)}),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_steps_match_jax(case):
    grad_clip, overrides = TRAIN_CASES[case]
    jc, tc, jp, tp = _models(3, **overrides)
    k_steps = 3
    rng = np.random.default_rng(4)
    xs = rng.integers(0, jc.q_levels, (k_steps, B, jc.lookback * 5),
                      np.int32)
    ys = xs[:, :, jc.lookback:]
    rs = np.array([[1, 1, 1], [0, 1, 0], [0, 0, 0]], np.float32)
    valid = np.minimum(np.array([[32, 32, 32], [32, 20, 0], [32, 32, 32]],
                                np.int32), ys.shape[-1])
    extra = [{} for _ in range(k_steps)]
    for e in extra:
        if jc.cond_dim:
            e["cond"] = rng.normal(size=(B, ys.shape[-1] // jc.cond_rate,
                                         jc.cond_dim)).astype(np.float32)
        if jc.n_speakers:
            e["speakers"] = rng.integers(0, jc.n_speakers, (B,), np.int32)
    jtx = joptim.make_optimizer(1e-3, grad_clip)
    ttx = toptim.make_optimizer(1e-3, grad_clip)
    jstep = jtrainer.make_train_step(jc, jtx)
    tstep = ttrainer.make_train_step(tc, ttx)
    jpar = jax.tree.map(jnp.asarray, jp)
    jopt, jh = jtx.init(jpar), jsrnn.initial_state(jpar, jc, B)
    tpar, topt = tp, ttx.init(tp)
    th = tsrnn.initial_state(tp, tc, B)
    h0_before = tp["tiers"][0].get("h0", torch.zeros(0)).clone()
    tnlls = []
    for k in range(k_steps):
        jpar, jopt, jh, jn = jstep(jpar, jopt, jh, jnp.asarray(xs[k]),
                                   jnp.asarray(ys[k]), jnp.asarray(rs[k]),
                                   valid=jnp.asarray(valid[k]),
                                   **{n: jnp.asarray(v)
                                      for n, v in extra[k].items()})
        tpar, topt, th, tn = tstep(tpar, topt, th, torch.from_numpy(xs[k]),
                                   torch.from_numpy(ys[k]),
                                   torch.from_numpy(rs[k]),
                                   valid=torch.from_numpy(valid[k]),
                                   **{n: torch.from_numpy(v)
                                      for n, v in extra[k].items()})
        assert abs(float(tn) - float(jn)) < 1e-4, (k, float(tn), float(jn))
        tnlls.append(float(tn))
    for a, b in zip(tree_leaves(tpar),
                    jax.tree.leaves(jax.device_get(jpar))):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0)
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert torch.equal(tpar["tiers"][0].get("h0", torch.zeros(0)),
                       h0_before)
    # the multi-step function is K single steps
    multi = ttrainer.make_multi_train_step(tc, ttx)
    staged = {n: torch.from_numpy(np.stack([e[n] for e in extra]))
              for n in extra[0]}
    mpar, _, mh, mn = multi(tp, ttx.init(tp), tsrnn.initial_state(tp, tc, B),
                            torch.from_numpy(xs), torch.from_numpy(ys),
                            torch.from_numpy(rs),
                            valid=torch.from_numpy(valid), **staged)
    np.testing.assert_array_equal(mn.numpy(), np.float32(tnlls))
    for a, b in zip(tree_leaves(mpar), tree_leaves(tpar)):
        assert torch.equal(a, b)
    for a, b in zip(mh, th):
        assert torch.equal(a, b)


def test_eval_steps_match_jax():
    jc, tc, jp, tp = _models(5, cond_dim=4, cond_rate=8, n_speakers=3)
    x, extra = _batch(jc, 6)
    y = x[:, jc.lookback:]
    resets = np.array([0, 1, 0], np.float32)
    rng = np.random.default_rng(7)
    state = tuple(rng.normal(size=(1, B, 16)).astype(np.float32)
                  for _ in range(jc.n_tiers))
    jh, jn = jtrainer.make_eval_step(jc)(
        jp, tuple(map(jnp.asarray, state)), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(resets), **{k: jnp.asarray(v) for k, v in extra.items()})
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    th, tn = ttrainer.make_eval_step(tc)(
        tp, tuple(map(torch.from_numpy, state)), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(resets), **textra)
    assert abs(float(tn) - float(jn)) < 1e-4
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
    # two staged batches in one call: the second carries the first's state
    stack = {k: torch.from_numpy(np.stack([v, v])) for k, v in extra.items()}
    mh, mn = ttrainer.make_multi_eval_step(tc)(
        tp, tuple(map(torch.from_numpy, state)),
        torch.from_numpy(np.stack([x, x])), torch.from_numpy(np.stack([y, y])),
        torch.from_numpy(np.stack([resets, resets * 0])), **stack)
    assert mn[0].item() == tn.item()
    th2, tn2 = ttrainer.make_eval_step(tc)(
        tp, th, torch.from_numpy(x), torch.from_numpy(y),
        torch.zeros(B), **textra)
    assert mn[1].item() == tn2.item()
    for a, b in zip(mh, th2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "exponential"])
@pytest.mark.parametrize("warmup", [0, 4])
def test_schedules_match_optax(schedule, warmup):
    want = joptim.make_schedule(2e-3, schedule, warmup, decay_steps=10)
    got = toptim.make_schedule(2e-3, schedule, warmup, decay_steps=10)
    for step in range(20):
        assert abs(got(step) - float(want(step))) <= 1e-6 * 2e-3, step
    if warmup:
        assert got(0) == 0.0


def test_optimizer_matches_optax():
    """Clipping (triggered, then not) and Adam over three updates of
    random gradients, with a near-zero component that Adam must scale by
    the same eps."""
    rng = np.random.default_rng(8)
    shapes = {"a": (3, 4), "b": [(5,), (2, 2)]}
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.normal(size=s).astype(np.float32)
                    for s in shapes["b"]]}
    jtx = joptim.make_optimizer(1e-2, 1.0, schedule="cosine",
                                warmup_steps=1, decay_steps=5)
    ttx = toptim.make_optimizer(1e-2, 1.0, schedule="cosine",
                                warmup_steps=1, decay_steps=5)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jst, tst = jtx.init(jp), ttx.init(tp)
    for k, scale in enumerate((10.0, 0.01, 1.0)):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale)
                         .astype(np.float32), params)
        g["a"][0, 0] = 1e-9
        ju, jst = jtx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tst = ttx.update(tree_map(torch.from_numpy, g), tst, tp)
        tp = toptim.apply_updates(tp, tu)
        # optax takes the schedule and the bias corrections in float32,
        # the port in float64: a few float32 ulps of the update
        for a, b in zip(tree_leaves(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-5,
                                       atol=1e-9)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_entry_points_default_to_cuda(monkeypatch):
    """init_params, graft_entry.entry, the Trainer, the bench twins and
    the quality smoke run on the card unless asked for the CPU: without a
    card they refuse rather than fall back."""
    from samplernn_pase_tpu_torch import bench
    from samplernn_pase_tpu_torch.config import TrainConfig
    from samplernn_pase_tpu_torch.data.dataset import synthetic_corpus
    from samplernn_pase_tpu_torch.scripts import bench_train, quality_smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TCfg(**BASE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsrnn.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
    corpus = synthetic_corpus(n_utts=1, length=256)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.Trainer(cfg, TrainConfig(batch_size=1, seq_len=64), corpus)
    for run in (bench.run, bench_train.run):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quality_smoke.main(["--tiny"])
    t = ttrainer.Trainer(cfg, TrainConfig(batch_size=1, seq_len=64),
                         corpus, device="cpu")
    assert t.device.type == "cpu" and t.hiddens[0].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device().type == "cuda"
    params = tsrnn.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    assert params["mlp"]["b_out"].device.type == "cpu"


def test_graft_entry_runs_on_cpu(monkeypatch):
    """entry(device="cpu") at the tiny width (the flagship's width on the
    CPU is a card-sized run): a finite NLL and the state's layout."""
    tiny = TCfg(frame_sizes=(4, 2), dim=32, embed_dim=16,
                compute_dtype="float32")
    monkeypatch.setattr(graft_entry, "FLAGSHIP", tiny)
    fn, args = graft_entry.entry(device="cpu")
    nll, state = fn(*args)
    assert np.isfinite(nll.item())
    assert [tuple(s.shape) for s in state] == [(1, 8, 32), (1, 8, 32)]
