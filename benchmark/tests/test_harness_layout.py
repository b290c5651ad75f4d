"""The benchmark is driven by data: a cell made only of new data files, and a
per-layer metric made of one new reader file, run with no existing file
edited; ``BENCHMARK.json`` keeps to the shape the harness reads."""

from __future__ import annotations

import json
import re

from benchmark import harness
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _snapshot(root):
    return {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_from_new_files_only(tmp_path):
    root = tiny.scratch(tmp_path, cells={})
    before = _snapshot(root)
    bench = root / "benchmark"
    model = dict(tiny.TINY_MODEL, n_rnn=1, weight_norm=False)
    (bench / "configs" / "tiny_new.json").write_text(json.dumps(
        {"name": "tiny_new", "model": model, "reduced": []}))
    (bench / "traffic" / "gen-new.json").write_text(json.dumps(
        {"driver": "gen", "lanes": 3, "samples": 32, "temperature": 0.7,
         "trace_seconds": 0.2, "check_requests": 2, "check_lanes": 2}))
    (bench / "limits" / "tiny-new-gen.json").write_text(json.dumps(
        {"token_gap": 1e-3, "wave_err": 1e-3}))
    (bench / "metrics" / "gen.requests.py").write_text(
        '"""Requests finished in the window."""\n\n\n'
        "def read(run):\n"
        '    return run.counters.get("requests")\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_new", "source": "test",
                            "file": "benchmark/configs/tiny_new.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-new-gen", "config": "tiny_new",
                              "traffic": "gen-new", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if "srnnpt-gen-b128" in m.get("workloads", []):
            m["workloads"].append("tiny-new-gen")
    spec["per_layer"].append({"name": "gen.requests", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "whole-generation loop",
                              "moves": "gen_samples_per_s",
                              "workloads": ["tiny-new-gen"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _snapshot(root)
    assert all(after[p] == b for p, b in before.items())   # none edited
    out = harness.execute(root, "tiny-new-gen", 5, 0.4, False, "cpu")
    assert out["correct"] and set(out["metrics"]) == {"gen_samples_per_s",
                                                      "setup_s"}
    traced = harness.execute(root, "tiny-new-gen", 6, 0.4, True, "cpu")
    assert traced["metrics"]["gen.requests"]["value"] >= 1


def test_benchmark_json_shape():
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    used = {w["config"] for w in spec["workloads"]}
    assert used == set(names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(spec["paths"][0] + "/")
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        moves = next(x for x in spec["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
    for cell in cells:
        c = harness.Cell(tiny.REPO, cell)
        assert len(c.end_to_end) >= 2 and c.per_layer
    assert len(json.dumps(spec)) < 64 * 1024
