"""The port's twins of the repo's ``examples/`` and of
``scripts/bench_host.py`` and ``scripts/perf_floor.py``: each example runs
through ``python -m`` on the CPU (``--device cpu``, a model that trains
and generates in seconds) with the reference example's own checks; the
twins print their skip line without a card and their smoke lines on the
CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
PKG = "samplernn_pase_tpu_torch"


# one intra-op thread in this process (torch_threads.py)
pytestmark = pytest.mark.usefixtures("one_thread")


def _run(module, *args, timeout=300):
    # one intra-op thread: under -n 6 a thread per core in every process
    # oversubscribes the CPU (a 3 s example took minutes)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


# example -> (the line its check prints, the files it writes)
EXAMPLES = {
    "train_and_generate": ("bits/sample over", ["sample_0.wav",
                                                "sample_1.wav"]),
    "tts_speakers": ("wrote 4 wavs", ["speaker0.wav", "speaker1.wav",
                                      "continuation_spk0.wav",
                                      "continuation_spk1.wav"]),
    "serving_stream": ("conditioned stream == one-shot decode: OK", []),
    "pool_serving": ("sampled pool lane A == solo generator", []),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(name, tmp_path):
    from samplernn_pase_tpu_torch.ops.audio_io import read_wav
    line, files = EXAMPLES[name]
    out = tmp_path / ("out" if files else "out.wav")
    res = _run(f"{PKG}.examples.{name}", "--device", "cpu", str(out))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "device: cpu" in res.stdout and line in res.stdout
    for f in files or [""]:
        wav, sr = read_wav(out / f if f else out)
        assert sr == 16_000 and len(wav) > 0


def test_examples_carry_no_device_claims():
    """The reference's docstrings quote its own chip's rates; the port's
    examples quote none."""
    for name in EXAMPLES:
        text = (ROOT / PKG / "examples" / f"{name}.py").read_text()
        for word in ("TPU", "realtime aggregate", "v5e", "tunnel"):
            assert word not in text, (name, word)


@pytest.mark.parametrize("module", ["bench_host", "perf_floor"])
def test_twin_skips_without_cuda(module):
    res = _run(f"{PKG}.scripts.{module}")
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "skipped": True, "reason": "cuda_unavailable"}


def test_bench_host_smoke_on_cpu(capsys):
    from samplernn_pase_tpu_torch.scripts import bench_host
    assert bench_host.main(["--smoke", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "host_batches_per_sec_b128_seq1024"
    assert rec["smoke"] is True and rec["route"] in ("native", "numpy")
    for key in ("native_gather", "python_stack", "device_consumption",
                "headroom_native_x", "train_step_ms"):
        assert rec[key] > 0, key
    # measured in the same run, not a constant
    assert rec["device_consumption"] == round(1000.0 / rec["train_step_ms"],
                                              1)


def test_perf_floor_smoke_on_cpu(capsys):
    from samplernn_pase_tpu_torch.scripts import perf_floor
    assert perf_floor.main(["--smoke", "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["metric"] for r in recs] == list(perf_floor.FLOORS)
    assert all(r["value"] > 0 and r["smoke"] and r["card"] == "cpu"
               for r in recs)


def test_perf_floor_measures_the_metrics_it_is_given(capsys):
    from samplernn_pase_tpu_torch.scripts import perf_floor
    names = ["train_lstm3_step_ms_b64_seq1024", "gen_3tier_lstm"]
    assert perf_floor.main(["--smoke", "--device", "cpu"]
                           + [a for n in names for a in ("--metric", n)]) == 0
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["metric"] for r in recs] == sorted(
        names, key=list(perf_floor.FLOORS).index)


def test_perf_floor_floors_name_their_card():
    """Every floor is set (from PERF.md's H100 numbers) and the floors'
    card is named beside them."""
    from samplernn_pase_tpu_torch.scripts import perf_floor
    assert all(v is not None and v > 0 for v in perf_floor.FLOORS.values())
    assert perf_floor.FLOOR_CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
