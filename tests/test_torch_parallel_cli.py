"""The port's command line under a world of ranks: ``python -m
torch.distributed.run --standalone --nproc-per-node 2 -m
samplernn_pase_tpu_torch.cli --platform cpu train ...`` (two gloo ranks,
the batch split over a ``data`` mesh) against the one-process run, and
the world rules: a batch the world does not divide, and every verb but
``train``, exit non-zero before any file is written."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from samplernn_pase_tpu_torch import config as C
from samplernn_pase_tpu_torch.ops.audio_io import write_wav

ROOT = Path(__file__).resolve().parents[1]
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "samplernn_pase_tpu_torch.cli",
            "--platform", "cpu"]
ONE = [sys.executable, "-m", "samplernn_pase_tpu_torch.cli", "--platform",
       "cpu"]


def _run(cmd, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Six ragged sine wavs and a tiny config that logs every step."""
    d = tmp_path_factory.mktemp("world")
    ds = d / "ds"
    ds.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        t = np.arange(int(rng.integers(500, 800))) / 16000
        write_wav(ds / f"u{i}.wav",
                  (0.5 * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(
                      np.float32), 16000)
    exp = C.ExperimentConfig(
        model=C.SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8,
                                compute_dtype="float32"),
        train=C.TrainConfig(batch_size=4, seq_len=64, epochs=1,
                            log_every_steps=1, val_every_steps=4,
                            ckpt_every_steps=4))
    cfg = d / "cfg.json"
    cfg.write_text(C.to_json(exp))
    return d, ds, cfg


def _nlls(exp_dir):
    return [(m.get("step"), m.get("split"), m["nll_bits"])
            for m in map(json.loads, (exp_dir / "metrics.jsonl").open())
            if "nll_bits" in m]


def test_train_under_torchrun_matches_one_process(setup):
    """Two gloo ranks give the one-process run's metrics.jsonl NLLs (train
    and val, step by step) within 1e-5, written once, by the chief, with
    the same checkpoints and config.json."""
    d, ds, cfg = setup
    args = ["train", "--config", str(cfg), "--dataset", str(ds)]
    world = _run(TORCHRUN + args + ["--exp-dir", str(d / "world")])
    assert world.returncode == 0, world.stderr[-3000:]
    one = _run(ONE + args + ["--exp-dir", str(d / "one")])
    assert one.returncode == 0, one.stderr[-3000:]
    got, want = _nlls(d / "world"), _nlls(d / "one")
    assert len(got) == len(want) > 8
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               atol=1e-5, rtol=0)
    assert (sorted(p.name for p in (d / "world" / "ckpt").iterdir())
            == sorted(p.name for p in (d / "one" / "ckpt").iterdir()))
    cfgs = [json.loads((d / e / "config.json").read_text())
            for e in ("world", "one")]
    for c in cfgs:
        c["train"].pop("exp_dir")
    assert cfgs[0] == cfgs[1]


def test_train_refuses_a_batch_the_world_does_not_divide(setup):
    d, ds, cfg = setup
    out = d / "uneven"
    res = _run(TORCHRUN + ["train", "--config", str(cfg), "--dataset",
                           str(ds), "--exp-dir", str(out),
                           "--batch_size", "3"])
    assert res.returncode != 0
    assert "batch_size 3 does not divide over the world of 2" in res.stderr
    assert not out.exists()


@pytest.mark.parametrize("verb", ["generate", "evaluate", "stream", "serve",
                                  "extract"])
def test_other_verbs_refuse_a_world(setup, verb):
    """The reference builds no mesh outside train: under a world the other
    verbs exit before reading or writing anything."""
    d, ds, _ = setup
    out = d / f"out_{verb}"
    args = {"generate": ["--ckpt", str(d), "--out", str(out)],
            "evaluate": ["--ckpt", str(d), "--dataset", str(ds)],
            "stream": ["--ckpt", str(d), "--out", str(out)],
            "serve": ["--ckpt", str(d), "--out", str(out), "--n", "1"],
            "extract": ["--dataset", str(ds), "--out", str(out)]}[verb]
    res = _run(TORCHRUN + [verb] + args)
    assert res.returncode != 0
    assert f"{verb} runs in one process" in res.stderr
    assert not out.exists()
