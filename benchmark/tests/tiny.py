"""A scratch copy of the benchmark with tiny cells, for the CPU tests: the
harness's files as they are, plus configuration, traffic and limit files
of small sizes and a ``BENCHMARK.json`` naming them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_MODEL = {"frame_sizes": [4, 2], "dim": 16, "n_rnn": 2, "rnn_type": "gru",
              "q_levels": 256, "embed_dim": 8, "mlp_hidden": 0, "cond_dim": 0,
              "cond_rate": 0, "n_speakers": 0, "learn_h0": True,
              "weight_norm": True, "codec": "mulaw",
              "compute_dtype": "float32"}
TINY_TTS = dict(TINY_MODEL, n_rnn=1, weight_norm=False, cond_dim=6,
                cond_rate=16)
LENGTHS = {"n": 8, "min_s": 0.05, "max_s": 0.2, "mean_s": 0.12}

CELLS = {
    "tiny-gen": ("tiny_srnn", "tiny-gen", {
        "driver": "gen", "lanes": 4, "samples": 64, "temperature": 1.0,
        "trace_seconds": 0.5, "check_requests": 3, "check_lanes": 2}),
    "tiny-stream": ("tiny_tts", "tiny-stream", {
        "driver": "stream", "lanes": 4, "chunk": 16, "temperature": 1.0,
        "rate_per_s": 12.0, "lengths": LENGTHS, "sample_rate": 1000,
        "max_cond_frames": 16, "warm_lanes": 2, "trace_seconds": 0.5,
        "check_requests": 3}),
    "tiny-jobs": ("tiny_tts", "tiny-jobs", {
        "driver": "jobs", "lanes": 4, "chunk": 16, "temperature": 1.0,
        "jobs": 8, "lengths": LENGTHS, "sample_rate": 1000,
        "max_cond_frames": 16, "warm_jobs": 2, "warm_rows": 2,
        "trace_seconds": 1.0, "check_requests": 3}),
    "tiny-train": ("tiny_srnn", "tiny-train", {
        "driver": "train", "batch": 4, "seq_len": 64, "steps_per_call": 4, "loss_steps": 3,
        "control": "int8",
        "lr": 0.001, "grad_clip": 1.0, "clips": 8, "clip_samples": 256,
        "sample_rate": 1000, "trace_seconds": 0.5}),
}


NUMBERS = {"gen": ("token_gap", "wave_err"), "stream": ("token_gap",),
           "jobs": ("token_gap", "wave_err"),
           "train": ("loss_gap", "change_gap")}
REAL = {"gen": "srnnpt-gen-b128", "stream": "tts-stream-b128",
        "jobs": "tts-jobs-b128", "train": "srnnpt-train-b128"}


def _dump(path: Path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def scratch(root: Path, cells=CELLS, limit: float | None = 1e-3) -> Path:
    """``root`` holding ``benchmark/`` (a copy) and a ``BENCHMARK.json`` of
    the tiny ``cells``; the real cells' entries are kept too.  Each tiny
    cell's numbers take ``limit``, or with None the limits committed for
    the real cell of its driver."""
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, model in (("tiny_srnn", TINY_MODEL), ("tiny_tts", TINY_TTS)):
        _dump(root / "benchmark" / "configs" / f"{name}.json",
              {"name": name, "model": model, "reduced": []})
        spec["configs"].append({"name": name, "source": "tiny",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "CPU test"})
    for cell, (config, mix, traffic) in cells.items():
        _dump(root / "benchmark" / "traffic" / f"{mix}.json", traffic)
        kind = traffic["driver"]
        real = REAL[kind]
        limits = (json.loads((BENCH / "limits" / f"{real}.json").read_text())
                  if limit is None else
                  {k: limit for k in NUMBERS[kind]})
        _dump(root / "benchmark" / "limits" / f"{cell}.json", limits)
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": mix, "chips": 1, "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    _dump(root / "BENCHMARK.json", spec)
    return root
