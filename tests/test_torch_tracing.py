"""The port's spans (``utils/profiling.py``) on the CPU: nothing recorded
and no clock read without a profiler; names, parents, attrs and the
buffer's bound under one; each span's ``e0`` against its own
``record_function`` event; and the spans of the serving pool,
``run_jobs``, the kernel route of ``generate_levels`` and
``Trainer.run``, with ``Trainer.host_s`` equal to its spans' sums, and
``forward``'s ``samplernn.tier`` spans inside each ``train.forward``."""

import collections
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from samplernn_pase_tpu_torch import generate as gen
from samplernn_pase_tpu_torch import serve
from samplernn_pase_tpu_torch.config import SampleRNNConfig, TrainConfig
from samplernn_pase_tpu_torch.data.dataset import synthetic_corpus
from samplernn_pase_tpu_torch.models import samplernn
from samplernn_pase_tpu_torch.train.trainer import Trainer
from samplernn_pase_tpu_torch.utils import profiling

TTS = SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8, cond_dim=6,
                      cond_rate=12, compute_dtype="float32")


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _params(cfg, seed=0):
    return samplernn.init_params(torch.Generator().manual_seed(seed), cfg,
                                 "cpu")


def _rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 6)).astype(
        np.float32)


def _named(name):
    return [s for s in profiling.spans() if s.name == name]


def _by_index():
    return {s.index: s for s in profiling.spans()}


def _parent(s):
    return _by_index().get(s.parent)


def test_off_is_the_shared_noop_and_reads_no_clock(monkeypatch):
    assert not torch.autograd._profiler_enabled()

    def no_clock():
        raise AssertionError("a clock was read")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(time, "time_ns", no_clock)
    s = profiling.span("off", lanes=3)
    assert s is profiling.span("other") is profiling._OFF
    with s:
        profiling.note(lane=1)
    with pytest.raises(KeyError):
        with profiling.span("off"):
            raise KeyError("goes on")
    assert profiling.spanned("off.fn")(lambda x: x + 1)(1) == 2
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_off_allocates_nothing():
    def loop():
        for _ in range(2000):
            with profiling.span("off", lanes=3, samples=64):
                pass

    loop()
    tracemalloc.start()
    try:
        loop()
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 512          # no object per span


def test_timed_adds_its_seconds_without_a_profiler():
    acc = {"work": 0.0}
    with profiling.timed("t.work", acc, "work") as t:
        sum(range(1000))
    assert acc["work"] == (t.t1 - t.t0) / 1e9 > 0
    assert profiling.spans() == []


def test_spans_parents_and_attrs_under_a_profiler():
    @profiling.spanned("leaf.fn")
    def leaf():
        profiling.note(found=True)

    with _profiled():
        with profiling.span("outer", lanes=4):
            with profiling.span("inner"):
                leaf()
            profiling.note(extra=1)
        with profiling.span("second"):
            pass
    got = profiling.spans()
    assert [s.name for s in got] == ["outer", "inner", "leaf.fn", "second"]
    assert [s.index for s in got] == [0, 1, 2, 3]
    assert [s.parent for s in got] == [-1, 0, 1, -1]
    assert got[0].attrs == {"lanes": 4, "extra": 1}
    assert got[2].attrs == {"found": True}
    for s in got:
        assert s.t0 <= s.t1 and s.e0 > 0
    assert got[0].t0 <= got[1].t0 <= got[2].t1 <= got[1].t1 <= got[0].t1
    assert got[0].t1 <= got[3].t0


def test_a_span_records_by_the_profiler_at_its_entry():
    acc = {"k": 0.0}
    prof = _profiled()
    with profiling.timed("opened.before", acc, "k"):
        prof.start()
        with profiling.span("opened.inside"):
            pass
    prof.stop()
    with profiling.span("after"):
        pass
    assert [(s.name, s.parent) for s in profiling.spans()] == [
        ("opened.inside", -1)]
    assert acc["k"] > 0


def test_the_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_buf", collections.deque(maxlen=4))
    with _profiled():
        for i in range(10):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s6", "s7", "s8", "s9"]
    assert [s.index for s in profiling.spans()] == [6, 7, 8, 9]
    assert profiling.dropped() == 6
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_e0_lies_on_its_record_function_event():
    with _profiled() as prof:
        for i in range(50):
            with profiling.span(f"clock.{i}"):
                torch.ones(8).sum()
    events = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.")}
    errs = [abs(s.e0 - events[s.name]) for s in profiling.spans()]
    assert len(errs) == 50
    assert max(errs) < 1_000_000          # 1 ms


def test_pool_start_and_emit_spans():
    params = _params(TTS)
    pool = serve.StreamPool(params, TTS, n_lanes=3, temperature=0.9,
                            seed=7, use_kernels=True, device="cpu")
    pool.start(cond=_rows(5, 1))
    with _profiled():
        lane = pool.start(cond=_rows(4, 2),
                          seed_levels=np.arange(40) % 256,
                          seed_cond=_rows(4, 3))
        copy = serve.host_copy(pool.emit(16))
        serve.host_wait(copy)
    (start,) = _named("pool.start")
    assert start.attrs == {"lane": lane, "epoch": 0} and start.parent == -1
    parts = [s.name for s in profiling.spans() if s.parent == start.index]
    assert parts == ["pool.start.upload", "pool.start.reset",
                     "pool.start.prime"]
    (emit,) = _named("pool.emit")
    assert emit.attrs == {"lanes_active": 2}
    (levels,) = _named("generate.levels")
    assert _parent(levels) is emit
    assert levels.attrs == {"lanes": 3, "samples": 16, "route": "kernels"}
    (prep,) = _named("generate.prepare_weights")   # the first emit's
    assert _parent(prep) is emit
    (run,) = _named("megagen.run")
    assert _parent(run) is levels
    # a GRU hg a tier step, on the chain on the CPU: 2 x (1 + 2) of them
    assert run.attrs == {"top_frames": 2, "lanes": 3, "graphed": 0,
                         "offchain": 0, "hg": 6}
    (proj,) = _named("generate.project_cond")
    assert _parent(proj) is levels and proj.t1 <= run.t0
    for name in ("serve.host_copy", "serve.host_wait"):
        (s,) = _named(name)
        assert s.parent == -1


def test_pool_start_without_a_prompt_has_no_prime():
    pool = serve.StreamPool(_params(TTS), TTS, n_lanes=2, temperature=0.9,
                            device="cpu")
    with _profiled():
        pool.start(cond=_rows(3, 1))
        pool.start(cond=_rows(3, 2))
    starts = _named("pool.start")
    assert [s.attrs for s in starts] == [{"lane": 0, "epoch": 0},
                                         {"lane": 1, "epoch": 0}]
    assert _named("pool.start.prime") == []
    assert len(_named("pool.start.upload")) == 2


def test_run_jobs_spans():
    done = []
    jobs = [{"id": i, "cond": _rows(n, 10 + i)}
            for i, n in enumerate((2, 5, 3, 4))]
    with _profiled():
        _, stats = serve.run_jobs(
            _params(TTS), TTS, jobs, n_lanes=2, chunk=TTS.lookback * 2,
            temperature=1.0, seed=3, use_kernels=True,
            on_done=lambda jid, levels: done.append(jid), device="cpu")
    chunks = _named("jobs.chunk")
    assert [s.attrs["chunk"] for s in chunks] == list(range(stats["chunks"]))
    assert all(s.parent == -1 for s in chunks)
    idx = {s.index for s in chunks}
    claims = _named("jobs.claim")
    assert len(claims) == len(chunks) and all(s.parent in idx
                                              for s in claims)
    starts = _named("pool.start")
    assert len(starts) == len(jobs)
    assert all(_parent(s).name == "jobs.claim" for s in starts)
    drains = _named("jobs.drain")
    assert len(drains) == stats["chunks"]
    inside = [s for s in drains if s.parent in idx]
    assert len(inside) == stats["chunks"] - 1   # one chunk queued ahead
    drain_idx = {s.index for s in drains}
    waits = _named("serve.host_wait")
    assert len(waits) == len(drains) and all(s.parent in drain_idx
                                             for s in waits)
    dones = _named("jobs.on_done")
    assert len(dones) == len(jobs) == len(done)
    assert all(s.parent in drain_idx for s in dones)
    assert len(_named("generate.prepare_weights")) == 1
    assert len(_named("megagen.run")) == stats["chunks"]


@pytest.mark.parametrize("route", [True, False], ids=["kernels", "plain"])
def test_generate_levels_spans(route):
    cfg = SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8,
                          compute_dtype="float32")
    with _profiled():
        gen.generate_levels(_params(cfg), cfg, 2, 20, 1.0, seed=1,
                            use_kernels=route, device="cpu")
    (levels,) = _named("generate.levels")
    assert levels.attrs == {"lanes": 2, "samples": 20,
                            "route": "kernels" if route else "plain"}
    runs = _named("megagen.run")
    if route:
        (run,) = runs
        assert _parent(run) is levels
        assert run.attrs == {"top_frames": 3, "lanes": 2, "graphed": 0,
                             "offchain": 0, "hg": 9}
        (prep,) = _named("generate.prepare_weights")
        assert _parent(prep) is levels
    else:
        assert runs == []


def _trainer():
    cfg = SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8,
                          compute_dtype="float32")
    corpus = synthetic_corpus(n_utts=4, length=1024)
    tcfg = TrainConfig(batch_size=2, seq_len=64, epochs=1, steps_per_call=3)
    return Trainer(cfg, tcfg, corpus, device="cpu")


def test_trainer_spans_and_host_s():
    t = _trainer()
    with _profiled():
        t.run()
    names = {s.name for s in profiling.spans()}
    loop = ["data", "stage", "dispatch", "sync", "plugins"]
    assert {f"trainer.{k}" for k in loop} <= names
    for k in loop:
        got = [(s.t1 - s.t0) / 1e9 for s in _named(f"trainer.{k}")]
        assert t.host_s[k] == pytest.approx(sum(got), rel=1e-12, abs=0)
    dispatch = {s.index for s in _named("trainer.dispatch")}
    for part in ("train.forward", "train.backward", "train.optim"):
        got = _named(part)
        assert len(got) == t.global_step
        assert all(s.parent in dispatch for s in got)
    fwd, bwd, opt = (_named(p)[0] for p in ("train.forward",
                                           "train.backward", "train.optim"))
    assert fwd.t1 <= bwd.t0 and bwd.t1 <= opt.t0
    (batcher,) = _named("trainer.batcher")           # one epoch
    (end,) = _named("trainer.epoch_end")
    assert batcher.t1 <= _named("trainer.data")[0].t0
    assert _named("trainer.plugins")[-1].t1 <= end.t0


def test_trainer_host_s_without_a_profiler():
    t = _trainer()
    t.run()
    assert profiling.spans() == []
    assert t.global_step > 0
    assert all(t.host_s[k] > 0 for k in ("data", "stage", "dispatch",
                                          "sync", "plugins"))


@pytest.mark.parametrize("route", [True, "auto"], ids=["kernel", "scan"])
def test_tier_spans_nest_under_train_forward(route):
    cfg = SampleRNNConfig(frame_sizes=(4, 2, 2), dim=16, embed_dim=8,
                          rnn_type="lstm", compute_dtype="float32",
                          pallas_train_rnn=route)
    tcfg = TrainConfig(batch_size=2, seq_len=32, epochs=1, steps_per_call=2)
    t = Trainer(cfg, tcfg, synthetic_corpus(n_utts=2, length=128),
                device="cpu")
    t.run()                                   # no profiler: nothing kept
    assert profiling.spans() == []
    steps = t.global_step
    with _profiled():
        t.run()                               # the same epoch again
    forwards = {s.index: s for s in _named("train.forward")}
    tiers = _named("samplernn.tier")
    assert len(forwards) == t.global_step - steps == steps > 0
    assert len(tiers) == 3 * len(forwards)
    name = "kernel" if route is True else "scan"
    for fwd in forwards.values():
        mine = [s for s in tiers if s.parent == fwd.index]
        assert [s.attrs for s in mine] == [
            {"tier": k, "cell": "lstm", "steps": 32 // span, "layers": 1,
             "route": name} for k, span in ((2, 16), (1, 8), (0, 4))]
        assert all(fwd.t0 <= s.t0 <= s.t1 <= fwd.t1 for s in mine)
        assert all(a.t1 <= b.t0 for a, b in zip(mine, mine[1:]))
