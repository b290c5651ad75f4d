"""The readers of the port's spans (``benchmark/program_spans.py`` and the
metric files that use it) on a run carrying known spans and a synthetic
trace: the traced-tail filter, idle gaps put on the innermost span, the
idle inside named spans, each metric's value, and None where there is
nothing to read; then the tiny cells on the CPU report the metrics whose
spans they record."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans
from benchmark.tests import tiny
from samplernn_pase_tpu_torch.utils import profiling

S = 1_000_000_000             # ns a second
OFF = 7 * 10 ** 17            # the profiler's clock minus perf_counter_ns
WINDOW_T0, WINDOW_S, TRACED_S = 100.0, 10.0, 2.0     # tail: 108-110 s

# (index, name, parent, t0 s, t1 s, attrs)
SPANS = [
    (0, "jobs.chunk", -1, 108.10, 108.50, {"chunk": 0}),
    (1, "pool.emit", 0, 108.10, 108.30, {"lanes_active": 3}),
    (2, "megagen.run", 1, 108.15, 108.25, {"top_frames": 2, "lanes": 4}),
    (3, "jobs.drain", 0, 108.30, 108.45, {}),
    (4, "serve.host_wait", 3, 108.30, 108.40, {}),
    (5, "megagen.run", -1, 108.60, 108.70, {"top_frames": 3, "lanes": 4}),
    (6, "serve.host_copy", 1, 108.26, 108.27, {}),
    (7, "pool.start", -1, 108.75, 108.76, {}),
    (8, "pool.start", -1, 108.77, 108.79, {}),
    (9, "pool.start", -1, 108.80, 108.83, {}),
    (10, "train.optim", -1, 108.91, 108.92, {}),
    (11, "train.optim", -1, 108.93, 108.96, {}),
    (12, "train.forward", -1, 108.96, 108.99, {}),
    # before the traced tail: another run's
    (13, "megagen.run", -1, 101.00, 101.10, {"top_frames": 5, "lanes": 4}),
    (14, "pool.start", -1, 101.20, 101.90, {}),
]
# busy on the card (s): gaps 108.16-108.20 (inside megagen.run 2),
# 108.32-108.65 (midpoint in jobs.chunk; 108.60-108.65 inside megagen.run
# 5), 108.80-108.90 (in no span), 108.97-108.98 (inside train.forward)
BUSY = [(108.00, 108.16), (108.20, 108.32), (108.65, 108.80),
        (108.90, 108.97), (108.98, 109.00)]


def _ns(t):
    return round(t * S)


def _spans():
    out = []
    for i, name, parent, t0, t1, attrs in SPANS:
        s = profiling.Span(i, name, parent, dict(attrs))
        s.t0, s.t1, s.e0 = _ns(t0), _ns(t1), _ns(t0) + OFF
        out.append(s)
    return out


def _run(busy=BUSY):
    merged = [[_ns(a) + OFF, _ns(b) + OFF] for a, b in busy]
    trace = {"busy_intervals": merged,
             "bounds_ns": (_ns(108.0) + OFF, _ns(109.0) + OFF),
             "busy_s": sum(b - a for a, b in busy), "window_s": TRACED_S,
             "kernels": [], "notes": []}
    return SimpleNamespace(trace=trace, window_t0=WINDOW_T0,
                           window_s=WINDOW_S)


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(profiling, "spans", _spans)


def _read(metric, run):
    mod = harness.load_module(tiny.BENCH / "metrics" / f"{metric}.py",
                              f"reader_{metric}")
    return mod.read(run)


def test_tail_keeps_the_traced_tail_only(spans):
    got = program_spans.tail(_run())
    assert sorted(s.index for s in got) == list(range(13))


def test_idle_gaps_as_the_harness_builds_them():
    got = program_spans.idle_gaps(_run().trace)
    want = [(108.16, 108.20), (108.32, 108.65), (108.80, 108.90),
            (108.97, 108.98)]
    assert got == [(_ns(a) + OFF, _ns(b) + OFF) for a, b in want]


def test_idle_goes_to_the_innermost_span(spans):
    got = program_spans.idle_by_span(_run())
    assert set(got) == {"megagen.run", "jobs.chunk", "outside",
                        "train.forward"}
    assert got["megagen.run"] == pytest.approx(0.04)
    assert got["jobs.chunk"] == pytest.approx(0.33)
    assert got["outside"] == pytest.approx(0.10)
    assert got["train.forward"] == pytest.approx(0.01)


def test_idle_inside_named_spans(spans):
    run = _run()
    # 108.16-108.20 and 108.60-108.65, of 2 s
    assert program_spans.idle_inside_percent(
        run, {"megagen.run"}) == pytest.approx(4.5)
    assert program_spans.idle_inside_percent(
        run, {"jobs.drain"}) == pytest.approx(6.5)
    assert program_spans.idle_inside_percent(run, {"none"}) is None


@pytest.mark.parametrize("metric,want", [
    ("megagen.host_ms_per_top_frame.gen", 40.0),
    ("megagen.host_ms_per_top_frame.stream", 40.0),
    ("device.idle_launching.gen", 4.5),
    ("device.idle_launching.stream", 4.5),
    ("device.idle_launching.train", 0.5),
    ("pool.start_ms", 20.0),
    ("pool.emit_host_ms", 300.0),       # emit 200 + wait 100; the copy
                                        # inside emit counts once
    ("jobs.host_ms_per_chunk", 300.0),  # chunk 400 less its wait 100
    ("train.optim_host_ms_per_step", 20.0),
])
def test_metric_values(spans, metric, want):
    assert _read(metric, _run()) == pytest.approx(want)


NEW = ["megagen.host_ms_per_top_frame.gen",
       "megagen.host_ms_per_top_frame.stream", "device.idle_launching.gen",
       "device.idle_launching.stream", "device.idle_launching.train",
       "pool.start_ms", "pool.emit_host_ms", "jobs.host_ms_per_chunk",
       "train.optim_host_ms_per_step"]
IDLE = [m for m in NEW if m.startswith("device.")]


@pytest.mark.parametrize("metric", NEW)
def test_nothing_to_read(spans, metric, monkeypatch):
    no_trace = _run()
    no_trace.trace = None
    assert _read(metric, no_trace) is None
    before_tail = _run()
    before_tail.window_t0 = 50.0
    assert _read(metric, before_tail) is None
    no_device = _run(busy=[])
    no_device.trace["busy_s"] = 0.0
    if metric in IDLE:
        assert _read(metric, no_device) is None
    else:
        assert _read(metric, no_device) is not None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read(metric, _run()) is None
    monkeypatch.delattr(profiling, "spans")       # a port with no spans
    assert _read(metric, _run()) is None


def test_every_new_metric_has_its_entry():
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    for metric in NEW:
        assert (tiny.BENCH / "metrics" / f"{metric}.py").is_file()
        assert entries[metric]["better"] == "lower"
    assert list(entries)[-len(NEW):] == NEW          # appended


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.scratch(tmp_path_factory.mktemp("bench"))


SEEN_ON_CPU = {
    "tiny-stream": {"pool.start_ms", "pool.emit_host_ms"},
    "tiny-jobs": {"jobs.host_ms_per_chunk"},
    "tiny-train": {"train.optim_host_ms_per_step"},
}
# the whole window is traced (a tiny group of 4 steps takes about 1 s on
# the CPU, and the profiler starts at a group's end)
SECONDS = {"tiny-stream": 0.8, "tiny-jobs": 0.8, "tiny-train": 4.0}


@pytest.mark.parametrize("cell", sorted(SEEN_ON_CPU))
def test_tiny_cells_report_their_span_metrics(root, cell):
    """The plain route on the CPU runs no ``megagen.run`` and no device
    operation: the span metrics of the pool, the jobs loop and the train
    step are read, the idle and launch-loop ones left out."""
    secs = SECONDS[cell]
    result = harness.execute(
        root, cell, 2 ** 31 + 29, secs, True, "cpu",
        patch=lambda run: run.traffic.update(trace_seconds=secs))
    buf = io.StringIO()
    with redirect_stdout(buf):
        harness.report(result)
    metrics = json.loads(buf.getvalue().strip().splitlines()[-1])["metrics"]
    assert SEEN_ON_CPU[cell] <= set(metrics)
    assert all(metrics[m]["value"] > 0 for m in SEEN_ON_CPU[cell])
    assert not set(metrics) & {m for m in NEW
                               if m.startswith(("device.", "megagen."))}
