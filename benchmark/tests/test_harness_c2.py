"""Config 2's cell at a tiny size on the CPU: a 3-tier LSTM training cell
(frame sizes (4, 2, 2), dim 32) runs through the train driver and is
``correct``, while the float8 control in the program's place is not; and
the cell's two new readers, ``k5_roofline.train`` and
``train.tier_host_ms_per_step``, on a synthetic trace and span list, with
None where nothing is traced."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import flops, harness
from benchmark.tests import tiny
from samplernn_pase_tpu_torch.utils import profiling

CELL = "tiny-c2-train"
REAL = "c2-train-b64"
MODEL = dict(tiny.TINY_MODEL, frame_sizes=[4, 2, 2], dim=32, n_rnn=1,
             rnn_type="lstm", weight_norm=False)
TRAFFIC = {"driver": "train", "batch": 4, "seq_len": 32, "steps_per_call": 4,
           "loss_steps": 3, "control": "fp8", "lr": 0.001, "grad_clip": 1.0,
           "clips": 8, "clip_samples": 256, "sample_rate": 1000,
           "trace_seconds": 4.0}
# Read at this size (float32 on the CPU, seeds 1-3): the program's gaps
# 0 (NLL) and 2-9e-7 (change); float8's 2.3e-3-4.6e-3 and 0.039-0.058.
LIMITS = {"loss_gap": 1e-3, "change_gap": 1e-3}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A scratch benchmark holding the tiny cell, listed wherever the real
    cell is."""
    root = tiny.scratch(tmp_path_factory.mktemp("c2"), cells={})
    bench = root / "benchmark"
    (bench / "configs" / "tiny_c2.json").write_text(json.dumps(
        {"name": "tiny_c2", "model": MODEL, "reduced": []}))
    (bench / "traffic" / f"{CELL}.json").write_text(json.dumps(TRAFFIC))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_c2", "source": "tiny",
                            "file": "benchmark/configs/tiny_c2.json",
                            "reduced": [], "why": "CPU test"})
    spec["workloads"].append({"name": CELL, "config": "tiny_c2",
                              "traffic": CELL, "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_real_cell_entries():
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    cell = harness.Cell(tiny.REPO, REAL)
    assert cell.config["model"]["rnn_type"] == "lstm"
    assert cell.config["model"]["frame_sizes"] == [16, 4, 4]
    assert cell.config["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {"train_samples_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "mfu.train", "trainer.host_ms_per_step", "device.idle.train",
        "device.idle_launching.train", "train.optim_host_ms_per_step",
        "k5_roofline.train", "train.tier_host_ms_per_step"}
    names = [m["name"] for m in spec["per_layer"]]
    assert names.index("train.tier_host_ms_per_step") == names.index(
        "k5_roofline.train") + 1                 # appended together
    assert set(cell.limits) == {"loss_gap", "change_gap"}


@pytest.mark.parametrize("seed", [2 ** 31 + 19, 7])
def test_program_correct_and_control_not(root, seed):
    out = harness.execute(root, CELL, seed, 0.5, False, "cpu")
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    runs = []

    def patch(run):
        run.control = True
        runs.append(run)

    out = harness.execute(root, CELL, seed, 0.5, False, "cpu", patch=patch)
    assert out["correct"] is False, out["checks"]
    r = runs[0].readings
    assert all(r[k] <= LIMITS[k] for k in LIMITS), r
    assert out["checks"]["change_gap"]["value"] == r["fp8"]["change_gap"]


def test_traced_tiny_cell_reads_its_tier_spans(root):
    """On the CPU the spans are recorded and no device operation runs:
    the tier metric is read, K5's roofline and the idle shares left out."""
    out = harness.execute(root, CELL, 2 ** 31 + 3, 4.0, True, "cpu")
    got = out["metrics"]
    assert got["train.tier_host_ms_per_step"]["value"] > 0
    assert "k5_roofline.train" not in got
    assert not {m for m in got if m.startswith("device.")}


# -- the readers on synthetic input ------------------------------------

def _read(metric, run):
    mod = harness.load_module(tiny.BENCH / "metrics" / f"{metric}.py",
                              f"reader_{metric}")
    return mod.read(run)


C2 = {"frame_sizes": [16, 4, 4], "dim": 1024, "n_rnn": 1, "rnn_type": "lstm"}


def _kernel_run(names_us):
    """A run whose trace holds kernels of the given names and durations
    (us), each once, at config 2's shapes."""
    kernels = [(n, i * 10_000, round(us * 1e3))
               for i, (n, us) in enumerate(names_us)]
    return SimpleNamespace(trace={"kernels": kernels}, model=C2,
                           counters={"lanes": 64},
                           traffic={"seq_len": 4096})


def test_k5_roofline_counts_steps_by_forward_chains():
    # two traced steps: 3 tiers x 1 layer forward chains each
    names = ([("void lstmseq_fwd_chain_tc<8, 2, 8>(CUtensorMap)", 300.0)] * 6
             + [("lstmseq_bwd_chain_tc<8, 1, 8>", 500.0)] * 6
             + [("seq_gemm_tc<false, true>", 100.0)] * 12
             + [("gruseq_fwd_chain_tc", 1e6), ("elementwise_kernel", 1e6)])
    got = _read("k5_roofline.train", _kernel_run(names))
    bound = flops.k4_step_bound(C2, 64, 4096)
    k5_s = (6 * 300.0 + 6 * 500.0 + 12 * 100.0) * 1e-6
    assert got == pytest.approx(100.0 * bound * 2 / k5_s)
    assert 0 < got <= 100


def test_k5_roofline_nothing_to_read():
    assert _read("k5_roofline.train", _kernel_run([])) is None
    gru = [("gruseq_fwd_chain_tc", 300.0), ("seq_gemm_tc", 100.0)]
    assert _read("k5_roofline.train", _kernel_run(gru)) is None
    untraced = _kernel_run([("lstmseq_fwd_chain_tc", 1.0)])
    untraced.trace = None
    assert _read("k5_roofline.train", untraced) is None


S = 1_000_000_000
OFF = 7 * 10 ** 17
# (index, name, parent, t0 s, t1 s): the traced tail is 108-110 s
SPANS = [
    (0, "train.forward", -1, 108.10, 108.20),
    (1, "samplernn.tier", 0, 108.10, 108.11),
    (2, "samplernn.tier", 0, 108.11, 108.13),
    (3, "samplernn.tier", 0, 108.13, 108.16),
    (4, "train.forward", -1, 108.30, 108.40),
    (5, "samplernn.tier", 4, 108.30, 108.32),
    (6, "samplernn.tier", 4, 108.32, 108.34),
    (7, "samplernn.tier", 4, 108.34, 108.36),
    (8, "samplernn.tier", -1, 108.50, 108.90),     # an evaluation's
    (9, "train.forward", -1, 101.00, 101.50),      # before the tail
    (10, "samplernn.tier", 9, 101.00, 101.40),
]


def _spans(rows=SPANS):
    out = []
    for i, name, parent, t0, t1 in rows:
        s = profiling.Span(i, name, parent, {})
        s.t0, s.t1 = round(t0 * S), round(t1 * S)
        s.e0 = s.t0 + OFF
        out.append(s)
    return out


def _span_run():
    trace = {"busy_intervals": [], "bounds_ns": (None, None), "busy_s": 1.0,
             "window_s": 2.0, "kernels": [], "notes": []}
    return SimpleNamespace(trace=trace, window_t0=100.0, window_s=10.0)


def test_tier_host_ms_per_forward(monkeypatch):
    monkeypatch.setattr(profiling, "spans", _spans)
    # (10 + 20 + 30) + (20 + 20 + 20) ms over 2 forward spans
    got = _read("train.tier_host_ms_per_step", _span_run())
    assert got == pytest.approx(60.0)


def test_tier_host_ms_nothing_to_read(monkeypatch):
    monkeypatch.setattr(profiling, "spans", _spans)
    untraced = _span_run()
    untraced.trace = None
    assert _read("train.tier_host_ms_per_step", untraced) is None
    # a port with no tier span (an older tree): nothing, not 0
    monkeypatch.setattr(profiling, "spans", lambda: _spans(
        [r for r in SPANS if r[1] != "samplernn.tier"]))
    assert _read("train.tier_host_ms_per_step", _span_run()) is None
    monkeypatch.setattr(profiling, "spans", lambda: _spans(SPANS[8:9]))
    assert _read("train.tier_host_ms_per_step", _span_run()) is None
    monkeypatch.delattr(profiling, "spans")
    assert _read("train.tier_host_ms_per_step", _span_run()) is None
