"""The readers of ``megagen.run``'s replayed share
(``megagen.graphed_share.gen`` and ``.stream``): on known spans, on a tiny
traced run of the port's loop on the CPU (with a stand-in graph whose
replay runs its block again), and None where no ``megagen.run`` span
carries ``graphed``."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.tests import tiny
from samplernn_pase_tpu_torch.config import SampleRNNConfig
from samplernn_pase_tpu_torch.models import samplernn
from samplernn_pase_tpu_torch.ops.kernels import megagen
from samplernn_pase_tpu_torch.utils import profiling

METRICS = ["megagen.graphed_share.gen", "megagen.graphed_share.stream"]
S = 1_000_000_000


def _read(metric, run):
    mod = harness.load_module(tiny.BENCH / "metrics" / f"{metric}.py",
                              f"reader_{metric}")
    return mod.read(run)


def _span(i, name, t0, t1, **attrs):
    s = profiling.Span(i, name, -1, attrs)
    s.t0, s.t1, s.e0 = round(t0 * S), round(t1 * S), round(t0 * S)
    return s


def _run(t0=100.0, window_s=10.0, traced_s=2.0):
    return SimpleNamespace(trace={"window_s": traced_s, "busy_s": 1.0},
                           window_t0=t0, window_s=window_s)


SPANS = [
    _span(0, "megagen.run", 108.1, 108.2, top_frames=34, lanes=4,
          graphed=32),
    _span(1, "megagen.run", 108.3, 108.4, top_frames=16, lanes=4,
          graphed=16),
    _span(2, "megagen.run", 108.5, 108.6, top_frames=30, lanes=4,
          graphed=0),
    _span(3, "pool.emit", 108.7, 108.8, lanes_active=3),
    # before the traced tail (108-110 s)
    _span(4, "megagen.run", 101.0, 101.1, top_frames=50, lanes=4,
          graphed=0),
]


@pytest.mark.parametrize("metric", METRICS)
def test_share_of_the_tail(metric, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: SPANS)
    assert _read(metric, _run()) == pytest.approx(100.0 * 48 / 80)


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_to_read(metric, monkeypatch):
    older = [_span(s.index, s.name, s.t0 / S, s.t1 / S,
                   **{k: v for k, v in s.attrs.items() if k != "graphed"})
             for s in SPANS]
    monkeypatch.setattr(profiling, "spans", lambda: older)
    assert _read(metric, _run()) is None        # no span carries graphed
    monkeypatch.setattr(profiling, "spans", lambda: SPANS)
    no_trace = _run()
    no_trace.trace = None
    assert _read(metric, no_trace) is None
    assert _read(metric, _run(t0=50.0)) is None  # every span before the tail
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read(metric, _run()) is None
    monkeypatch.delattr(profiling, "spans")     # a port with no spans
    assert _read(metric, _run()) is None


class _EagerGraph(megagen._Graph):
    """A graph whose replay runs its recorded block again (CPU)."""

    def capture(self, *args):
        self.args = args

    def replay(self):
        self.block(*self.args)


@pytest.mark.parametrize("graphed", [False, True])
def test_tiny_traced_run(graphed, monkeypatch):
    """Calls of the port's loop on the CPU under the profiler: none
    replayed (the CPU's route), or, through the stand-in graph, every
    block after a structure's first."""
    if graphed:
        blocks = megagen.graph_blocks
        monkeypatch.setattr(megagen, "graph_blocks", lambda n, dev, *a: blocks(
            n, torch.device("cuda"), *a))
        monkeypatch.setattr(megagen, "_Graph", _EagerGraph)
        monkeypatch.setattr(megagen, "_GRAPHS", type(megagen._GRAPHS)())
    cfg = SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8,
                          compute_dtype="float32")
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    weights = megagen.prepare(params["tiers"], params["mlp"], torch.float32)
    window = torch.full((3, cfg.lookback), 128, dtype=torch.int32)
    states = samplernn.initial_state(params, cfg, 3)
    b = megagen.BLOCK
    profiling.clear()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        for n_top in (2 * b + 1, 2 * b + 1, b):
            megagen.run(weights, window, states, 1.0, n_top, 256, seed=4)
    window_s = time.perf_counter() - t0
    try:
        run = _run(t0, window_s, window_s)
        want = 100.0 * (b + 2 * b + b) / (5 * b + 2) if graphed else 0.0
        for metric in METRICS:
            assert _read(metric, run) == pytest.approx(want)
    finally:
        profiling.clear()


def test_entries_appended():
    """Both entries follow every entry the benchmark had before them."""
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    names = [m["name"] for m in spec["per_layer"]]
    at = names.index(METRICS[0])
    assert names[at:at + 2] == METRICS
    assert names.index("train.optim_host_ms_per_step") < at
    gen, stream = spec["per_layer"][at:at + 2]
    for m in (gen, stream):
        assert (tiny.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert (m["unit"], m["better"], m["source"], m["layer"]) == (
            "%", "higher", "program_span", "whole-generation loop")
    assert gen["workloads"] == ["srnnpt-gen-b128", "tts-jobs-b128"]
    assert stream["workloads"] == ["tts-stream-b128"]
