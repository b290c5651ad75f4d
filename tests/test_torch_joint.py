"""Joint PASE + SampleRNN training: the port's steps and JointTrainer
against the JAX package's, on the CPU in float32, from the same joint
parameters (``convert.joint_from_jax``) and the same numpy batches.
Tolerances: conditioning 2e-4 (the conv bar of tests/test_torch_pase.py);
three train steps' NLL, both halves' parameters, BatchNorm state and
hiddens 1e-5 (tests/test_torch_train.py's bar: Adam turns a gradient
whose sign differs into a 2e-3 step); the trainers' per-step NLLs, final
parameters and ``validate()`` 1e-5; a resumed port run equal to the
uninterrupted one bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu.config import PASEConfig as JPase
from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.config import TrainConfig as JTrain
from samplernn_pase_tpu.data import dataset as jds
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu.train import joint as jjoint
from samplernn_pase_tpu.train import optim as joptim
from samplernn_pase_tpu.train import trainer as jtr
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch.config import PASEConfig as TPase
from samplernn_pase_tpu_torch.config import SampleRNNConfig as TCfg
from samplernn_pase_tpu_torch.config import TrainConfig as TTrain
from samplernn_pase_tpu_torch.data import dataset as tds
from samplernn_pase_tpu_torch.models import samplernn as tsrnn
from samplernn_pase_tpu_torch.train import checkpoint as tckpt
from samplernn_pase_tpu_torch.train import joint as tjoint
from samplernn_pase_tpu_torch.train import optim as toptim
from samplernn_pase_tpu_torch.train import trainer as ttr
from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map

PASE = dict(sinc_filters=8, sinc_kernel=33, blocks=((8, 5, 4), (12, 5, 4)),
            emb_dim=10, compute_dtype="float32")
MODEL = dict(frame_sizes=(4, 2), dim=16, embed_dim=8, cond_dim=10,
             cond_rate=16, compute_dtype="float32")
B, T = 2, 64            # T a multiple of lookback (8) and decimation (16)
TOL = 1e-5


def _close(port_tree, jax_tree, atol):
    """Leaf by leaf, matched by key and index."""
    if isinstance(port_tree, dict):
        assert set(port_tree) == set(jax_tree)
        for k in port_tree:
            _close(port_tree[k], jax_tree[k], atol)
    elif isinstance(port_tree, (list, tuple)):
        assert len(port_tree) == len(jax_tree)
        for a, b in zip(port_tree, jax_tree):
            _close(a, b, atol)
    else:
        np.testing.assert_allclose(port_tree.detach().numpy(),
                                   np.asarray(jax_tree), atol=atol, rtol=0)


def _models(seed, **kw):
    jm, tm = JCfg(**MODEL, **kw), TCfg(**MODEL, **kw)
    jpc, tpc = JPase(**PASE), TPase(**PASE)
    jp, jb = jax.device_get(jjoint.init_joint(jax.random.PRNGKey(seed), jm,
                                              jpc))
    tp, tb = convert.joint_from_jax(jp, jb)
    return jm, tm, jpc, tpc, jp, jb, tp, tb


def test_joint_from_jax_and_init_layout():
    jm, tm, jpc, tpc, jp, jb, tp, tb = _models(0)
    _close(tp, jp, 0)
    _close(tb, jb, 0)
    assert tb["sinc"]["count"].shape == () and tb["sinc"]["count"].dtype \
        == torch.float32
    with pytest.raises(ValueError, match="srnn and pase"):
        convert.joint_from_jax(jp["srnn"], jb)
    gp, gb = tjoint.init_joint(torch.Generator().manual_seed(0), tm, tpc,
                               device="cpu")
    _close(jax.tree.map(torch.zeros_like, gp),
           jax.tree.map(np.zeros_like, jp), 0)
    with pytest.raises(ValueError, match="cond_rate"):
        tjoint.make_joint_train_step(TCfg(**{**MODEL, "cond_rate": 8}), tpc,
                                     toptim.make_optimizer())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_joint_cond_matches_reference(train):
    jm, tm, jpc, tpc, jp, jb, tp, tb = _models(1)
    x = np.random.default_rng(2).integers(0, 256, (B, jm.lookback + T),
                                          np.int32)
    want, wst = jjoint.joint_cond(jax.tree.map(jnp.asarray, jp["pase"]),
                                  jax.tree.map(jnp.asarray, jb), jm, jpc,
                                  jnp.asarray(x), train=train)
    got, gst = tjoint.joint_cond(tp["pase"], tb, tm, tpc, torch.from_numpy(x),
                                 train=train)
    assert got.shape == want.shape == (B, T // 16, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    _close(gst, jax.device_get(wst), 1e-6)


# (freeze_pase, steps_per_call, n_speakers)
STEP_CASES = {"joint": (False, 1, 0), "frozen": (True, 1, 0),
              "multi3": (False, 3, 0), "speakers": (False, 1, 3),
              "multi3_frozen_speakers": (True, 3, 3)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_joint_train_steps_match_reference(case):
    """Three steps (resets, a masked tail, grad clip 1.0): NLL, both
    halves' parameters, the BatchNorm state and the hiddens."""
    freeze, k_call, n_spk = STEP_CASES[case]
    jm, tm, jpc, tpc, jp, jb, tp, tb = _models(3, n_speakers=n_spk)
    rng = np.random.default_rng(4)
    xs = rng.integers(0, 256, (3, B, jm.lookback + T), np.int32)
    ys = xs[:, :, jm.lookback:]
    rs = np.array([[1, 1], [0, 1], [0, 0]], np.float32)
    valid = np.array([[T, T], [T, 40], [T, T]], np.int32)
    kw = {"valid": valid}
    if n_spk:
        kw["speakers"] = rng.integers(0, n_spk, (3, B), np.int32)
    jtx, ttx = joptim.make_optimizer(1e-3, 1.0), toptim.make_optimizer(1e-3,
                                                                        1.0)
    jpar, jbn = jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, jb)
    jopt, jh = jtx.init(jpar), jsrnn.initial_state(jpar["srnn"], jm, B)
    topt, th = ttx.init(tp), tsrnn.initial_state(tp["srnn"], tm, B)
    jstep = jjoint.make_joint_train_step(jm, jpc, jtx, freeze_pase=freeze)
    jnlls = []
    for k in range(3):
        jpar, jopt, jbn, jh, jn = jstep(
            jpar, jopt, jbn, jh, jnp.asarray(xs[k]), jnp.asarray(ys[k]),
            jnp.asarray(rs[k]), **{n: jnp.asarray(v[k])
                                   for n, v in kw.items()})
        jnlls.append(float(jn))
    tpar, tbn = tp, tb
    if k_call == 1:
        tstep = tjoint.make_joint_train_step(tm, tpc, ttx, freeze_pase=freeze)
        tnlls = []
        for k in range(3):
            tpar, topt, tbn, th, tn = tstep(
                tpar, topt, tbn, th, torch.from_numpy(xs[k]),
                torch.from_numpy(ys[k]), torch.from_numpy(rs[k]),
                **{n: torch.from_numpy(v[k]) for n, v in kw.items()})
            tnlls.append(float(tn))
    else:
        multi = tjoint.make_joint_multi_step(tm, tpc, ttx, freeze_pase=freeze)
        tpar, topt, tbn, th, tn = multi(
            tpar, topt, tbn, th, torch.from_numpy(xs), torch.from_numpy(ys),
            torch.from_numpy(rs), **{n: torch.from_numpy(v)
                                     for n, v in kw.items()})
        tnlls = tn.tolist()
    np.testing.assert_allclose(tnlls, jnlls, atol=TOL, rtol=0)
    _close(tpar, jax.device_get(jpar), TOL)
    _close(tbn, jax.device_get(jbn), TOL)
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    assert float(tbn["proj"]["count"]) == 3.0
    moved = any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(tpar["pase"]), tree_leaves(tp["pase"])))
    assert moved != freeze
    assert all(not t.requires_grad for t in tree_leaves((tpar, tbn, th)))


def test_joint_eval_steps_match_reference():
    jm, tm, jpc, tpc, jp, jb, tp, tb = _models(5)
    rng = np.random.default_rng(6)
    xs = rng.integers(0, 256, (2, B, jm.lookback + T), np.int32)
    ys, rs = xs[:, :, jm.lookback:], np.array([[1, 1], [0, 0]], np.float32)
    jev = jjoint.make_joint_multi_eval_step(jm, jpc)
    jh, jn = jev(jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, jb),
                 jsrnn.initial_state(jax.tree.map(jnp.asarray, jp["srnn"]),
                                     jm, B),
                 jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(rs))
    h = tsrnn.initial_state(tp["srnn"], tm, B)
    th, tn = tjoint.make_joint_multi_eval_step(tm, tpc)(
        tp, tb, h, torch.from_numpy(xs), torch.from_numpy(ys),
        torch.from_numpy(rs))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=TOL)
    single = tjoint.make_joint_eval_step(tm, tpc)
    h1, n1 = single(tp, tb, h, torch.from_numpy(xs[0]),
                    torch.from_numpy(ys[0]), torch.from_numpy(rs[0]))
    h1, n2 = single(tp, tb, h1, torch.from_numpy(xs[1]),
                    torch.from_numpy(ys[1]), torch.from_numpy(rs[1]))
    assert torch.equal(torch.stack([n1, n2]), tn)
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


def _corpora(n=5, seed=3, length=300):
    """The same ragged utterances for both packages' corpora."""
    rng = np.random.default_rng(seed)
    utts = []
    for _ in range(n):
        x = 0.6 * np.sin(np.arange(int(rng.integers(length // 2, length)))
                         * rng.uniform(0.05, 0.3))
        utts.append(tds._quantize_host(x.astype(np.float32), 256))
    kw = dict(val_frac=0.3)
    return tds.WavCorpus(utts, **kw), jds.WavCorpus(utts, **kw)


class _Cap:
    def __init__(self, base):
        rec = self.rec = []

        class Cap(base):
            def on_step(self, trainer, step, metrics):
                rec.append((step, metrics["nll_bits"], trainer.batch_idx))
        self.plugin = Cap()


def _trainers(steps_per_call, epochs=2, plugins=()):
    jm, tm, jpc, tpc, jp, jb, tp, tb = _models(7)
    train = dict(batch_size=2, seq_len=T, epochs=epochs,
                 steps_per_call=steps_per_call)
    tc, jc = _corpora()
    jcap, tcap = _Cap(jtr.Plugin), _Cap(ttr.Plugin)
    jt = jjoint.JointTrainer(jm, jpc, JTrain(**train), jc, [jcap.plugin],
                             params=jax.tree.map(jnp.asarray, jp),
                             bn_state=jax.tree.map(jnp.asarray, jb))
    tt = tjoint.JointTrainer(tm, tpc, TTrain(**train), tc,
                             [tcap.plugin, *plugins], params=tp, bn_state=tb,
                             device="cpu")
    return jt, jcap.rec, tt, tcap.rec


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_joint_trainer_matches_reference(steps_per_call):
    """Two epochs over ragged utterances (masked tails, resets inside a
    group, at 3 a group and a tail): per-step NLL, final parameters, BN
    state and hiddens, then ``validate()`` and ``generation_cond``."""
    jt, jrec, tt, trec = _trainers(steps_per_call)
    jt.run()
    tt.run()
    assert len(trec) >= 6
    assert [(s, b) for s, _, b in trec] == [(s, b) for s, _, b in jrec]
    np.testing.assert_allclose([v for _, v, _ in trec],
                               [v for _, v, _ in jrec], atol=TOL, rtol=0)
    _close(tt.params, jax.device_get(jt.params), TOL)
    _close(tt.bn_state, jax.device_get(jt.bn_state), TOL)
    for a, b in zip(tt.hiddens, jt.hiddens):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    assert abs(tt.validate() - jt.validate()) < TOL
    got, want = tt.generation_cond(3, 7), jt.generation_cond(3, 7)
    assert got.shape == want.shape == (3, 7, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)
    assert tt.gen_params is tt.params["srnn"]


def test_joint_trainer_mid_epoch_resume_is_exact(tmp_path):
    """A checkpoint inside a group (cadence 2, steps_per_call 3) and a
    fresh trainer restored from it run to the end bit-equal to the
    uninterrupted run: NLLs, both halves, BN state, hiddens, Adam."""
    mgr = tckpt.CheckpointManager(tmp_path / "c", max_to_keep=20)
    _, _, tt, trec = _trainers(3, plugins=[ttr.CheckpointPlugin(mgr, 2)])
    tt.run()
    saved = mgr.restore(2)
    assert set(saved["params"]) == {"joint", "bn"}
    _, _, t2, _ = _trainers(3)
    resumed = _Cap(ttr.Plugin)
    t2.plugins = [resumed.plugin]
    assert t2.restore(mgr, step=2)
    nxt = int(saved["cursor"][2])
    assert nxt == 3
    t2.run()
    assert resumed.rec == trec[nxt:]
    for name in ("params", "bn_state", "hiddens"):
        _close(getattr(t2, name), tree_map(lambda t: t.numpy(),
                                           getattr(tt, name)), 0)
    for m in ("mu", "nu"):
        _close(t2.opt_state[m], tree_map(lambda t: t.numpy(),
                                         tt.opt_state[m]), 0)


def test_legacy_bias_restore_zeroes_moments(tmp_path):
    """A checkpoint whose encoder blocks carry a conv bias (and Adam
    moments for it): the bias folds into the running mean, the leaf and its
    moments restore as zeros, every other moment as saved."""
    _, _, tt, _ = _trainers(1, epochs=1)
    params, bn = tt.params, tt.bn_state
    legacy = {"srnn": params["srnn"], "pase": dict(
        params["pase"], blocks=[dict(b, b=torch.full((b["w"].shape[0],),
                                                     0.5))
                                for b in params["pase"]["blocks"]])}

    def moments(fill):
        return {"srnn": {k: v for k, v in params["srnn"].items()},
                "pase": dict(legacy["pase"], blocks=[
                    {k: torch.full_like(v, fill) for k, v in b.items()}
                    for b in legacy["pase"]["blocks"]])}
    opt = {"count": 4, "mu": moments(0.25), "nu": moments(0.5)}
    mgr = tckpt.CheckpointManager(tmp_path / "legacy")
    mgr.save(4, {"joint": legacy, "bn": bn}, opt, tt.hiddens,
             cursor=np.asarray([0, 1, 5]))
    _, _, t2, _ = _trainers(1, epochs=1)
    assert t2.restore(mgr)
    for blk, st, old in zip(t2.params["pase"]["blocks"],
                            t2.bn_state["blocks"], bn["blocks"]):
        assert torch.equal(blk["b"], torch.zeros_like(blk["b"]))
        assert torch.equal(st["mean"], old["mean"] - 0.5)
    for which, fill in (("mu", 0.25), ("nu", 0.5)):
        for b in t2.opt_state[which]["pase"]["blocks"]:
            assert torch.equal(b["b"], torch.zeros_like(b["b"]))
            assert torch.equal(b["w"], torch.full_like(b["w"], fill))
    assert t2.opt_state["count"] == 4 and t2.global_step == 5
    t2.run()    # the migrated tree trains on


def test_joint_trainer_rejects_cached_cond_and_runs_joint_training():
    tc, _ = _corpora()
    rng = np.random.default_rng(0)
    cached = tds.WavCorpus(tc.utterances, conditioning=[
        rng.normal(size=(8, 10)).astype(np.float32) for _ in tc.utterances])
    tm, tpc = TCfg(**MODEL), TPase(**PASE)
    train = TTrain(batch_size=2, seq_len=T, epochs=1)
    with pytest.raises(ValueError, match="cached embeddings"):
        tjoint.JointTrainer(tm, tpc, train, cached, device="cpu")
    with pytest.raises(ValueError, match="bn_state"):
        tjoint.JointTrainer(tm, tpc, train, tc, params={}, device="cpu")
    params, bn, losses = tjoint.run_joint_training(tm, tpc, train, tc,
                                                   seed=3, device="cpu")
    assert losses and all(np.isfinite(losses))
    assert float(bn["proj"]["count"]) == len(losses)
