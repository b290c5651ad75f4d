"""The port's Trainer, plugins and checkpoints against the JAX package's,
on the CPU in float32: both trainers start from the same parameters
(``convert.params_from_jax``) on the same corpus (numpy from a seed) and
must agree step for step.  Tolerances: per-step NLL, final parameters
and ``validate()`` within 1e-5 (bits, absolute); the data cursor, the step
numbering and the checkpoint retention exactly; GeneratorPlugin wavs at
temperature 0 sample for sample.  Also the port's own properties: a
mid-epoch resume equal to the uninterrupted run bit for bit, the flush of
the pending group on an exception, the trace of steps 10-12, and the
``--tiny`` quality smoke."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.config import TrainConfig as JTrain
from samplernn_pase_tpu.data import dataset as jds
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu.train import checkpoint as jckpt
from samplernn_pase_tpu.train import metrics as jmetrics
from samplernn_pase_tpu.train import trainer as jtr
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch.config import SampleRNNConfig as TCfg
from samplernn_pase_tpu_torch.config import TrainConfig as TTrain
from samplernn_pase_tpu_torch.data import dataset as tds
from samplernn_pase_tpu_torch.train import checkpoint as tckpt
from samplernn_pase_tpu_torch.train import metrics as tmetrics
from samplernn_pase_tpu_torch.train import trainer as ttr
from samplernn_pase_tpu_torch.tree import tree_leaves

from torch_threads import one_thread  # noqa: F401 (a fixture)

TOL = 1e-5
BASE = dict(frame_sizes=(4, 2), dim=16, embed_dim=8, compute_dtype="float32")
COND = dict(cond_dim=4, cond_rate=8, n_speakers=2)


def _corpus(seed, n, cond=False, val_frac=0.3):
    """n ragged utterances (2-5 chunks of 64 samples at the tests'
    seq_len), with cond rows and two speakers when ``cond``."""
    rng = np.random.default_rng(seed)
    utts, conds = [], []
    for _ in range(n):
        x = 0.5 * np.sin(np.arange(int(rng.integers(130, 300)))
                         * rng.uniform(0.05, 0.3))
        utts.append(tds._quantize_host(x.astype(np.float32), 256))
        conds.append(rng.normal(size=(len(x) // 8 + 1, 4)).astype(
            np.float32))
    kw = dict(val_frac=val_frac)
    if cond:
        kw.update(conditioning=conds, speakers=[i % 2 for i in range(n)])
    return tds.WavCorpus(utts, **kw), jds.WavCorpus(utts, **kw)


def _params(jc, seed=0):
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed), jc))
    return jp, convert.params_from_jax(jp)


class _Cap:
    """Per-step (step, nll, batch_idx) records of either package."""

    def __init__(self, base):
        rec = self.rec = []

        class Cap(base):
            def on_step(self, trainer, step, metrics):
                rec.append((step, metrics["nll_bits"], trainer.batch_idx))
        self.plugin = Cap()


def _pair(model, train, corpora, jp, tp, **tkw):
    jcap, tcap = _Cap(jtr.Plugin), _Cap(ttr.Plugin)
    jt = jtr.Trainer(JCfg(**model), JTrain(**train), corpora[1],
                     plugins=[jcap.plugin],
                     params=jax.tree.map(jnp.asarray, jp))
    tt = ttr.Trainer(TCfg(**model), TTrain(**train), corpora[0],
                     plugins=[tcap.plugin], params=tp, device="cpu", **tkw)
    return jt, jcap.rec, tt, tcap.rec


def _agree(jt, jrec, tt, trec):
    assert [(s, b) for s, _, b in trec] == [(s, b) for s, _, b in jrec]
    worst = max(abs(a[1] - b[1]) for a, b in zip(trec, jrec))
    assert worst < TOL, worst
    assert tt.global_step == jt.global_step and tt.epoch == jt.epoch
    for a, b in zip(tree_leaves(tt.params),
                    jax.tree.leaves(jax.device_get(jt.params))):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL, rtol=0)
    for a, b in zip(tt.hiddens, jt.hiddens):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_trainer_matches_reference(steps_per_call):
    """Two epochs over ragged utterances (masked tails, resets inside a
    group), 8 steps an epoch: at steps_per_call 3, two groups and a
    2-step tail; the validation split's 4 steps end in a 1-step tail."""
    corpora = _corpus(1, 5)
    jp, tp = _params(JCfg(**BASE))
    train = dict(batch_size=2, seq_len=64, epochs=2, shuffle=True,
                 steps_per_call=steps_per_call)
    jt, jrec, tt, trec = _pair(BASE, train, corpora, jp, tp)
    assert corpora[0].has_val
    jt.run()
    tt.run()
    assert len(trec) == 16
    _agree(jt, jrec, tt, trec)
    assert abs(tt.validate() - jt.validate()) < TOL
    assert sum(tt.host_s.values()) > 0


def test_trainer_conditioned_speakers_match_reference():
    corpora = _corpus(2, 6, cond=True)
    jp, tp = _params(JCfg(**BASE, **COND), seed=3)
    train = dict(batch_size=2, seq_len=64, epochs=1, steps_per_call=3)
    jt, jrec, tt, trec = _pair({**BASE, **COND}, train, corpora, jp, tp)
    jt.run()
    tt.run()
    assert len(trec) >= 5
    _agree(jt, jrec, tt, trec)
    assert abs(tt.validate() - jt.validate()) < TOL


def test_logger_and_validation_lines_match(tmp_path):
    corpora = _corpus(4, 5)
    jp, tp = _params(JCfg(**BASE))
    train = dict(batch_size=2, seq_len=64, epochs=1, steps_per_call=2)
    jw = jmetrics.MetricsWriter(tmp_path / "j.jsonl", echo=False)
    tw = tmetrics.MetricsWriter(tmp_path / "t.jsonl", echo=False)
    jt = jtr.Trainer(JCfg(**BASE), JTrain(**train), corpora[1],
                     params=jax.tree.map(jnp.asarray, jp),
                     plugins=[jtr.LoggerPlugin(jw, every=2),
                              jtr.ValidationPlugin(jw, every_steps=3)])
    tt = ttr.Trainer(TCfg(**BASE), TTrain(**train), corpora[0], params=tp,
                     device="cpu",
                     plugins=[ttr.LoggerPlugin(tw, every=2),
                              ttr.ValidationPlugin(tw, every_steps=3)])
    jt.run()
    tt.run()
    jw.close()
    tw.close()
    jl = [json.loads(s) for s in (tmp_path / "j.jsonl").read_text().split(
        "\n") if s]
    tl = [json.loads(s) for s in (tmp_path / "t.jsonl").read_text().split(
        "\n") if s]
    assert [sorted(d) for d in tl] == [sorted(d) for d in jl]
    assert any(d.get("split") == "val" for d in tl)
    for a, b in zip(tl, jl):
        for k in ("step", "epoch", "split", "event"):
            assert a.get(k) == b.get(k)
        if "nll_bits" in a:
            assert abs(a["nll_bits"] - b["nll_bits"]) < TOL
    assert tt.last_val_nll is not None


def test_val_fallback_is_tagged(tmp_path):
    corpora = _corpus(5, 3, val_frac=0.0)
    tw = tmetrics.MetricsWriter(tmp_path / "m.jsonl", echo=False)
    mgr = tckpt.CheckpointManager(tmp_path / "ck")
    tt = ttr.Trainer(TCfg(**BASE), TTrain(batch_size=2, seq_len=64,
                                          epochs=1), corpora[0],
                     plugins=[ttr.ValidationPlugin(tw, every_steps=0),
                              ttr.CheckpointPlugin(mgr, every_steps=2)],
                     device="cpu", seed=1)
    assert tt.val_is_train_fallback
    with pytest.warns(UserWarning, match="falling back"):
        tt.run()
    tw.close()
    val = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text(
    ).split("\n") if s]
    assert val and all(d["val_is_train_fallback"] for d in val)
    # a train-split fallback NLL never chooses the best checkpoint
    assert mgr.best_step(strict=True) is None


def test_mid_epoch_resume(tmp_path):
    """The counterpart of tests/test_trainer.py::
    test_mid_epoch_resume_skips_trained_chunks, through CheckpointPlugin
    at a cadence inside a group: the resumed run's first step follows the
    saved cursor, and its final parameters and hiddens equal the
    uninterrupted run's bit for bit."""
    tc, _ = _corpus(6, 10, val_frac=0.0)
    model = TCfg(**BASE)
    train = TTrain(batch_size=2, seq_len=64, epochs=1, steps_per_call=3)
    mgr = tckpt.CheckpointManager(tmp_path / "c", max_to_keep=10)
    full = _Cap(ttr.Plugin)
    t = ttr.Trainer(model, train, tc, device="cpu", seed=2,
                    plugins=[full.plugin, ttr.CheckpointPlugin(mgr, 4)])
    t.run()
    n = t.global_step
    assert n >= 8
    # step 4 fired inside the group of steps 3-5: the checkpoint holds
    # the state after step 5 and the cursor (epoch 0, batch 5, next 6)
    assert mgr.all_steps() == list(range(4, n, 4)) + [n]
    r = mgr.restore(4)
    np.testing.assert_array_equal(r["cursor"], [0, 5, 6])
    t2 = ttr.Trainer(model, train, tc, device="cpu", seed=99)
    resumed = _Cap(ttr.Plugin)
    t2.plugins.append(resumed.plugin)
    assert t2.restore(mgr, step=4)
    t2.run()
    rec = resumed.rec
    # the first resumed group starts at batch 6, after the cursor's 5;
    # hooks see batch_idx pinned to the group's last batch, as in the
    # uninterrupted run
    assert rec[0][0] == 6 and rec[0][2] == full.rec[6][2] > 5
    assert [(s, b) for s, _, b in rec] == [(s, b) for s, _, b in
                                           full.rec[6:]]
    assert [v for _, v, _ in rec] == [v for _, v, _ in full.rec[6:]]
    for a, b in zip(tree_leaves(t2.params), tree_leaves(t.params)):
        assert torch.equal(a, b)
    for a, b in zip(t2.hiddens, t.hiddens):
        assert torch.equal(a, b)
    assert t2.opt_state["count"] == t.opt_state["count"] == n


def test_mid_epoch_resume_matches_reference_cursor(tmp_path):
    """The reference's resume test, step for step in both packages: stop
    at step 4, save (epoch, batch_idx, step + 1), restore, run on."""
    tc, jc = _corpus(7, 3, val_frac=0.0)
    jp, tp = _params(JCfg(**BASE))
    train = dict(batch_size=1, seq_len=64, epochs=1)

    class Stop(Exception):
        pass

    def stopper(base, mgr_cls, path):
        seen = []

        class Tracker(base):
            def on_step(self, trainer, step, metrics):
                seen.append(trainer.batch_idx)
                if step == 4:
                    mgr = mgr_cls(path)
                    mgr.save(step, trainer.params, trainer.opt_state,
                             trainer.hiddens,
                             cursor=np.asarray([trainer.epoch,
                                                trainer.batch_idx,
                                                step + 1]))
                    mgr.wait()
                    mgr.close()
                    raise Stop()
        return Tracker(), seen

    runs = {}
    for name, mod, mgr_cls, corpus, params, cfg, tcfg, kw in (
            ("jax", jtr, jckpt.CheckpointManager, jc,
             lambda: jax.tree.map(jnp.asarray, jp), JCfg(**BASE),
             JTrain(**train), {}),
            ("torch", ttr, tckpt.CheckpointManager, tc, lambda: tp,
             TCfg(**BASE), TTrain(**train), {"device": "cpu"})):
        plug, seen = stopper(mod.Plugin, mgr_cls, tmp_path / name)
        t = mod.Trainer(cfg, tcfg, corpus, plugins=[plug], params=params(),
                        **kw)
        with pytest.raises(Stop):
            t.run()
        t2 = mod.Trainer(cfg, tcfg, corpus, params=params(), **kw)
        mgr = mgr_cls(tmp_path / name)
        assert t2.restore(mgr)
        mgr.close()
        cap = _Cap(mod.Plugin)
        t2.plugins.append(cap.plugin)
        t2.run()
        runs[name] = (seen, cap.rec, t2)
    assert runs["torch"][0] == runs["jax"][0] and runs["torch"][0][-1] == 4
    trec, jrec = runs["torch"][1], runs["jax"][1]
    assert trec[0][2] == 5
    _agree(runs["jax"][2], jrec, runs["torch"][2], trec)


# (max_to_keep, [(step, val_nll_bits or None), ...])
RETENTION = {
    "latest_only": (2, [(1, None), (2, None), (3, None), (4, None)]),
    "best_kept": (2, [(1, 5.0), (2, 4.0), (3, 6.0), (4, 7.0), (5, None),
                      (6, 8.0)]),
    "tie_latest": (1, [(1, 3.0), (2, 3.0), (3, 9.0), (4, None)]),
    "best_moves": (3, [(2, 9.0), (4, 8.0), (6, None), (8, 7.5), (10, 7.0),
                       (12, None), (14, 7.2), (16, None)]),
}


@pytest.mark.parametrize("case", sorted(RETENTION))
def test_checkpoint_retention_matches_reference(tmp_path, case):
    """After every save the kept steps equal the orbax manager's, and so
    does best_step; a new manager on the same directory (a restarted
    process) keeps the record and goes on retaining the same way."""
    keep, seq = RETENTION[case]
    cfg = JCfg(**BASE)
    jp, tp = _params(cfg)
    half = len(seq) // 2
    jm = jckpt.CheckpointManager(tmp_path / "j", max_to_keep=keep)
    tm = tckpt.CheckpointManager(tmp_path / "t", max_to_keep=keep)
    for i, (step, val) in enumerate(seq):
        if i == half:   # restart both managers
            jm.close()
            jm = jckpt.CheckpointManager(tmp_path / "j", max_to_keep=keep)
            tm = tckpt.CheckpointManager(tmp_path / "t", max_to_keep=keep)
        metrics = None if val is None else {"val_nll_bits": val}
        jm.save(step, jp, metrics=metrics)
        jm.wait()
        tm.save(step, tp, metrics=metrics)
        assert tm.all_steps() == list(jm.mgr.all_steps()), (case, step)
        assert tm.latest_step() == jm.latest_step()
        assert tm.best_step() == jm.best_step()
        assert tm.best_step(strict=True) == jm.best_step(strict=True)
    jm.close()


def test_templateless_restore_is_cpu(tmp_path):
    """Restore without a template gives CPU tensors (the counterpart of
    test_templateless_restore_is_platform_neutral); with a template, each
    leaf takes the template leaf's dtype and device."""
    cfg = TCfg(**BASE)
    _, tp = _params(JCfg(**BASE))
    from samplernn_pase_tpu_torch.models import samplernn as tsrnn
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    hid = tsrnn.initial_state(tp, cfg, 2)
    opt = make_optimizer(1e-3, 1.0).init(tp)
    mgr = tckpt.CheckpointManager(tmp_path / "ck")
    mgr.save(5, tp, opt, hiddens=hid, cursor=np.asarray([0, 3, 6]))
    r = mgr.restore()
    assert r["step"] == 5 and isinstance(r["hiddens"], tuple)
    assert len(r["hiddens"]) == cfg.n_tiers
    np.testing.assert_array_equal(r["cursor"], [0, 3, 6])
    assert r["cursor"].dtype == np.int64
    for a, b in zip(tree_leaves(r["params"]), tree_leaves(tp)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    assert r["opt_state"]["count"] == 0
    assert type(r["params"]["tiers"]) is type(tp["tiers"])
    half = {"params": {k: v for k, v in tp.items()},
            "hiddens": [h.to(torch.float64) for h in hid]}
    r2 = mgr.restore(template=half)
    assert all(h.dtype == torch.float64 for h in r2["hiddens"])
    assert tckpt.CheckpointManager(tmp_path / "empty").restore() is None


def test_generator_plugin_wavs_match_reference(tmp_path):
    """Greedy (temperature 0) conditioned generation through both
    packages' GeneratorPlugin from the same parameters: the written wavs
    agree sample for sample, named per sequence and speaker."""
    model = {**BASE, **COND}
    corpora = _corpus(8, 2, cond=True, val_frac=0.0)
    jp, tp = _params(JCfg(**model), seed=5)
    cond = np.random.default_rng(9).normal(size=(2, 9, 4)).astype(
        np.float32)
    train = dict(batch_size=2, seq_len=64, epochs=1)
    jt = jtr.Trainer(JCfg(**model), JTrain(**train), corpora[1],
                     params=jax.tree.map(jnp.asarray, jp))
    tt = ttr.Trainer(TCfg(**model), TTrain(**train), corpora[0], params=tp,
                     device="cpu")
    length = 96
    for t, mod, d in ((jt, jtr, "j"), (tt, ttr, "t")):
        t.global_step = 4
        mod.GeneratorPlugin(tmp_path / d, every_steps=4, length=length,
                            temperature=0.0, cond=cond).on_step(t, 4, {})
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == ["step00000004_seq0_spk0.wav",
                     "step00000004_seq1_spk1.wav"]
    for n in names:
        sr_t, got = wavfile.read(tmp_path / "t" / n)
        sr_j, want = wavfile.read(tmp_path / "j" / n)
        assert sr_t == sr_j and got.shape == want.shape == (length,)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="speaker ids"):
        ttr.GeneratorPlugin(tmp_path / "x", 1, speakers=[0],
                            cond=cond)._cond_args(tt)


def test_pending_group_flushed_on_exception(tmp_path):
    """An exception while the next group is read leaves the previous
    group's hooks fired (its checkpoint cadence included)."""
    tc, _ = _corpus(10, 6, val_frac=0.0)
    train = TTrain(batch_size=2, seq_len=64, epochs=1, steps_per_call=2)
    cap = _Cap(ttr.Plugin)
    t = ttr.Trainer(TCfg(**BASE), train, tc, plugins=[cap.plugin],
                    device="cpu")
    real = t._batcher

    def failing(split):
        for i, item in enumerate(real(split)):
            if i == 4:
                raise KeyError("disk")
            yield item

    t._batcher = failing
    with pytest.raises(KeyError):
        t.run()
    assert [s for s, _, _ in cap.rec] == [0, 1, 2, 3]


def test_mask_passed_only_with_padding_and_profile(tmp_path):
    """``valid`` reaches the step only when a batch has padding; with
    profile_dir, steps 10-12 are traced into it."""
    tc, _ = _corpus(11, 12, val_frac=0.0)
    train = TTrain(batch_size=2, seq_len=64, epochs=1, steps_per_call=1,
                   profile_dir=str(tmp_path / "prof"))
    t = ttr.Trainer(TCfg(**BASE), train, tc, device="cpu")
    seen = []
    step = t._train_step

    def spy(*args, **kwargs):
        seen.append("valid" in kwargs)
        return step(*args, **kwargs)

    t._train_step = spy
    batches = list(t._batcher("train"))
    t.run()
    assert seen == [t._needs_mask(b) for b in batches]
    assert any(seen) and not all(seen)
    assert len(seen) > 12 and t.profile is not None
    assert (tmp_path / "prof" / "trace.json").exists()
    assert t.profile.wall_s > 0


# the fixture holds to the file's end: the file's last test takes it
@pytest.mark.usefixtures("one_thread")
def test_quality_smoke_tiny():
    """The port's quality smoke, --tiny on the CPU: the model fits the
    two-speaker sine corpus and each primed continuation keeps its
    speaker's fundamental."""
    from samplernn_pase_tpu_torch.scripts import quality_smoke
    assert quality_smoke.main(["--tiny", "--device", "cpu"]) == 0
