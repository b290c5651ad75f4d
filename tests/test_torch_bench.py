"""The GPU twins of bench.py, scripts/bench_train.py and
scripts/bench_pool.py on a machine without CUDA: each prints bench.py's
skip line and exits 0, and
``--smoke --device cpu`` prints its metric line from a tiny run of the
plain versions.  The numbers of a CPU run measure nothing; the test holds
the lines' form."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from samplernn_pase_tpu_torch import bench
from samplernn_pase_tpu_torch.scripts import bench_pool, bench_train

ROOT = Path(__file__).resolve().parents[1]
MODULES = ("samplernn_pase_tpu_torch.bench",
           "samplernn_pase_tpu_torch.scripts.bench_train",
           "samplernn_pase_tpu_torch.scripts.bench_pool")
KEYS = {
    bench: {"metric", "value", "unit", "vs_baseline", "smoke"},
    bench_train: {"metric", "value", "unit", "samples_per_sec", "step_ms",
                  "smoke"},
}


@pytest.mark.parametrize("module", MODULES)
def test_skip_line_without_cuda(module):
    """Run as a user would, in a fresh interpreter with no card: the skip
    line, exit code 0, and nothing else on stdout."""
    res = subprocess.run([sys.executable, "-m", module], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "",
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == {"skipped": True,
                                      "reason": "cuda_unavailable"}


@pytest.mark.parametrize("mod", [bench, bench_train],
                         ids=["bench", "bench_train"])
def test_smoke_on_cpu(mod, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # --smoke alone never falls back to the CPU: it skips like a full run
    assert mod.main(["--smoke"]) == 0
    assert json.loads(capsys.readouterr().out)["skipped"] is True
    assert mod.main(["--smoke", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == KEYS[mod] and line["smoke"] is True
    assert line["value"] > 0
    want = ("generated_samples_per_sec_per_chip_b128_16khz" if mod is bench
            else "train_bottom_frames_per_sec_b128_seq1024")
    assert line["metric"] == want
    if mod is bench:
        assert line["vs_baseline"] == round(line["value"] / bench.TARGET, 4)
    else:
        assert line["step_ms"] > 0
        # samples = frames x f1 (4 in the smoke model), each rounded to 0.1
        assert abs(line["samples_per_sec"] - 4 * line["value"]) <= 0.25


def test_bench_pool_smoke_rows(capsys, monkeypatch):
    """The reference's rows in its order: two solo streams, then pools at
    two chunk sizes, each line with the reference's keys."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_pool.main(["--smoke"]) == 0
    assert json.loads(capsys.readouterr().out)["skipped"] is True
    assert bench_pool.main(["--smoke", "--device", "cpu"]) == 0
    rows = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in rows] == [
        "solo_plain_b1_chunk16", "solo_conditioned_b1_chunk16",
        "pool_serving_n2_chunk16", "pool_serving_n3_chunk16",
        "pool_serving_n2_chunk8", "pool_serving_n3_chunk8"]
    solo = {"metric", "median_ms_per_chunk", "worst_ms", "realtime_x",
            "smoke"}
    pool = {"metric", "median_ms_per_chunk", "worst_ms", "join_ms",
            "per_stream_realtime_x", "aggregate_realtime_x", "smoke"}
    for r in rows:
        assert set(r) == (solo if r["metric"].startswith("solo") else pool)
        assert r["smoke"] is True
        assert r["median_ms_per_chunk"] > 0
        assert r["worst_ms"] >= r["median_ms_per_chunk"]
