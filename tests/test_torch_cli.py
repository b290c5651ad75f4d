"""The port's command line (``samplernn_pase_tpu_torch.cli``) on the CPU:
each of the reference's CLI tests (tests/test_cli.py) mirrored on the
port, ``config.json`` byte for byte against the reference's ``train``
for a set of argv, every ``sys.exit`` of the verbs, ``--platform``, the
``--stream-key`` words against ``jax.random.PRNGKey``, and
``utils.debug.checked``.  Every port call passes ``--platform cpu``; the
experiments are trained once per module."""

import contextlib
import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu import cli as jcli
from samplernn_pase_tpu import utils as jutils
from samplernn_pase_tpu_torch import cli
from samplernn_pase_tpu_torch import config as C
from samplernn_pase_tpu_torch.ops.audio_io import read_wav, write_wav
from samplernn_pase_tpu_torch.ops.kernels.noise import int_key
from samplernn_pase_tpu_torch.utils import checked

from torch_threads import one_thread  # noqa: F401 (a fixture)

TINY = ["--frame_sizes", "4", "2", "--dim", "16", "--embed_dim", "8"]


# one intra-op thread in this process (torch_threads.py)
pytestmark = pytest.mark.usefixtures("one_thread")


def run(*argv):
    cli.main(["--platform", "cpu", *map(str, argv)])


def run_json(*argv):
    """The verb's last stdout line, as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(*argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _write_corpus(d, lengths, seed, f0=150, df=60, cond_dir=None):
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16_000
        x = 0.5 * np.sin(2 * np.pi * (f0 + df * i) * t)
        x += 0.05 * rng.normal(size=n)
        write_wav(d / f"utt{i}.wav", np.clip(x, -1, 1), 16_000)
        if cond_dir is not None:
            cond_dir.mkdir(exist_ok=True)
            np.save(cond_dir / f"utt{i}.npy", rng.normal(
                size=(-(-n // 16), 10)).astype(np.float32))
    return d


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("cli")


@pytest.fixture(scope="module")
def wav_dir(root):
    """The reference tests' corpus: 3 utterances of 4,096 samples."""
    return _write_corpus(root / "wavs", [4096] * 3, 0)


@pytest.fixture(scope="module")
def plain(root, wav_dir):
    """A tiny unconditioned experiment, 2 epochs."""
    exp = root / "exp"
    run("train", "--dataset", wav_dir, "--exp-dir", exp, *TINY,
        "--batch_size", 2, "--seq_len", 256, "--epochs", 2)
    return exp


@pytest.fixture(scope="module")
def cond_exp(root, wav_dir):
    """Conditioned on cached rows (cond_dim 10, cond_rate 16)."""
    cond_dir = root / "cond"
    cond_dir.mkdir()
    rng = np.random.default_rng(21)
    for f in sorted(wav_dir.glob("*.wav")):
        np.save(cond_dir / f"{f.stem}.npy",
                rng.normal(size=(4096 // 16, 10)).astype(np.float32))
    exp = root / "exp_cond"
    run("train", "--dataset", wav_dir, "--cond-dir", cond_dir,
        "--exp-dir", exp, *TINY, "--cond_dim", 10, "--cond_rate", 16,
        "--batch_size", 2, "--seq_len", 256, "--epochs", 1)
    return exp


PASE_TINY = C.PASEConfig(sinc_filters=8, sinc_kernel=33,
                         blocks=((8, 5, 4), (12, 5, 4)), emb_dim=10,
                         compute_dtype="float32")


@pytest.fixture(scope="module")
def joint(root, wav_dir):
    """`train --joint` on a model without cond_dim: the CLI takes cond_dim
    and cond_rate from the encoder (a small one, decimation 16)."""
    cfg = root / "joint.json"
    cfg.write_text(C.to_json(C.ExperimentConfig(pase=PASE_TINY)))
    exp = root / "exp_joint"
    run("train", "--joint", "--config", cfg, "--dataset", wav_dir,
        "--exp-dir", exp, *TINY, "--batch_size", 2, "--seq_len", 320,
        "--epochs", 1)
    return exp


@pytest.fixture(scope="module")
def spk(root, wav_dir):
    """A speaker model (n_speakers 2, no cached rows), for the --speaker
    checks."""
    e = C.ExperimentConfig(
        model=C.SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8,
                                cond_dim=10, cond_rate=16, n_speakers=2),
        train=C.TrainConfig(batch_size=2, seq_len=256, epochs=1))
    cfg = root / "spk.json"
    cfg.write_text(C.to_json(e))
    exp = root / "exp_spk"
    run("train", "--config", cfg, "--dataset", wav_dir, "--exp-dir", exp)
    return exp


@pytest.fixture(scope="module")
def imb(root):
    """An imbalanced corpus (chunk counts [12, 9, 5, 3] at seq_len 256)
    with cached rows, an unconditioned and a conditioned experiment."""
    d = _write_corpus(root / "imb", [3000, 2100, 1200, 700], 7, f0=100,
                      df=55, cond_dir=root / "imb_cond")
    exps = {}
    for name, extra in (("plain", []),
                        ("cond", ["--cond-dir", root / "imb_cond",
                                  "--cond_dim", 10, "--cond_rate", 16])):
        exps[name] = root / f"exp_imb_{name}"
        run("train", "--dataset", d, "--exp-dir", exps[name], *TINY,
            *extra, "--batch_size", 2, "--seq_len", 256, "--epochs", 1)
    return d, root / "imb_cond", exps


# ------------------------------------------- the reference's tests --

def test_audio_io_roundtrip(tmp_path):
    x = np.linspace(-0.9, 0.9, 1000).astype(np.float32)
    write_wav(tmp_path / "a.wav", x, 16_000)
    y, sr = read_wav(tmp_path / "a.wav")
    assert sr == 16_000
    np.testing.assert_allclose(y, x, atol=1e-4)


def test_cli_train_then_generate(plain, tmp_path):
    assert (plain / "config.json").exists()
    metrics = [json.loads(line) for line in
               (plain / "metrics.jsonl").read_text().splitlines()]
    assert any("nll_bits" in m for m in metrics)
    out = tmp_path / "gen"
    run("generate", "--ckpt", plain, "--out", out, "--n_seqs", 2,
        "--length", 128, "--temperature", 0.9)
    wavs = sorted(out.glob("*.wav"))
    assert len(wavs) == 2
    y, sr = read_wav(wavs[0])
    assert sr == 16_000 and len(y) == 128


def test_cli_extract(wav_dir, tmp_path):
    out = tmp_path / "emb"
    run("extract", "--dataset", wav_dir, "--out", out, "--batch_size", 2)
    files = sorted(out.glob("*.npy"))
    assert len(files) == 3
    e = np.load(files[0])
    assert e.ndim == 2 and e.shape[0] == 4096 // 160


def test_cli_resume(plain, wav_dir, tmp_path, capsys):
    exp = tmp_path / "exp"
    shutil.copytree(plain, exp)
    run("train", "--dataset", wav_dir, "--exp-dir", exp, *TINY,
        "--batch_size", 2, "--seq_len", 256, "--epochs", 3, "--resume")
    assert "resumed at step 32" in capsys.readouterr().err
    steps = [json.loads(line).get("step") for line in
             (exp / "metrics.jsonl").read_text().splitlines()]
    assert max(s for s in steps if s is not None) >= 40   # epoch 3 ran


def test_cli_tts_pipeline_extract_train_generate(wav_dir, tmp_path):
    """extract PASE embeddings -> train conditioned on them (--cond-dir)
    -> generate with --cond."""
    emb = tmp_path / "emb"
    run("extract", "--dataset", wav_dir, "--out", emb, "--batch_size", 2)
    exp = tmp_path / "exp_tts"
    run("train", "--dataset", wav_dir, "--exp-dir", exp, "--cond-dir", emb,
        *TINY, "--cond_dim", 256, "--cond_rate", 160, "--batch_size", 2,
        "--seq_len", 320, "--epochs", 1)
    assert json.loads((exp / "config.json").read_text())[
        "model"]["cond_dim"] == 256
    out = tmp_path / "gen_tts"
    run("generate", "--ckpt", exp, "--out", out, "--n_seqs", 2,
        "--length", 320, "--temperature", 0.9,
        "--cond", sorted(emb.glob("*.npy"))[0])
    wavs = sorted(out.glob("*.wav"))
    assert len(wavs) == 2
    y, _ = read_wav(wavs[0])
    assert len(y) == 320 and np.isfinite(y).all()


def test_cli_train_joint(joint):
    cfgj = json.loads((joint / "config.json").read_text())
    assert cfgj["model"]["cond_dim"] == cfgj["pase"]["emb_dim"] == 10
    assert cfgj["model"]["cond_rate"] == 16
    metrics = [json.loads(line) for line in
               (joint / "metrics.jsonl").read_text().splitlines()]
    assert any(m.get("mode") == "joint" for m in metrics)
    assert (joint / "ckpt").exists()


def test_cli_evaluate(plain, wav_dir):
    rep = run_json("evaluate", "--ckpt", plain, "--dataset", wav_dir,
                   "--split", "val", "--batch_size", 2, "--seq_len", 256)
    assert rep["split"] == "val" and rep["batches"] > 0
    assert np.isfinite(rep["nll_bits"]) and rep["nll_bits"] > 0
    assert isinstance(rep["held_out"], bool)


def test_cli_generate_seed_wav(plain, wav_dir, tmp_path):
    out = tmp_path / "gen_seeded"
    run("generate", "--ckpt", plain, "--out", out, "--n_seqs", 1,
        "--length", 128, "--temperature", 0.9,
        "--seed-wav", sorted(wav_dir.glob("*.wav"))[0])
    wavs = sorted(out.glob("*.wav"))
    assert len(wavs) == 1
    y, _ = read_wav(wavs[0])
    assert len(y) == 128 and np.isfinite(y).all()


def test_cli_generate_flag_validation(plain, tmp_path):
    out = tmp_path / "gen"
    with pytest.raises(SystemExit, match="n_speakers"):
        run("generate", "--ckpt", plain, "--out", out, "--n_seqs", 1,
            "--length", 64, "--speaker", 0)
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((4, 8), np.float32))
    with pytest.raises(SystemExit, match="cond"):
        run("generate", "--ckpt", plain, "--out", out, "--n_seqs", 1,
            "--length", 64, "--cond", bad)


def test_cli_generate_best_and_step_flags(plain, tmp_path):
    from samplernn_pase_tpu_torch.train.checkpoint import CheckpointManager
    mgr = CheckpointManager(plain / "ckpt")
    steps = sorted({mgr.latest_step(), mgr.best_step()} - {None})
    out = tmp_path / "gen_best"
    run("generate", "--ckpt", plain, "--out", out, "--n_seqs", 1,
        "--length", 64, "--temperature", 0, "--best")
    assert len(list(out.glob("*.wav"))) == 1
    out2 = tmp_path / "gen_step"
    run("generate", "--ckpt", plain, "--out", out2, "--n_seqs", 1,
        "--length", 64, "--temperature", 0, "--step", steps[0])
    assert len(list(out2.glob("*.wav"))) == 1


def test_cli_joint_synthesis_workflow(joint, wav_dir, tmp_path):
    """A `train --joint` experiment end to end: generate conditioned on a
    wav through the adapted encoder, extract with it, evaluate."""
    out = tmp_path / "gen_joint"
    run("generate", "--ckpt", joint, "--out", out, "--n_seqs", 1,
        "--length", 320, "--temperature", 0.9,
        "--cond-wav", sorted(wav_dir.glob("*.wav"))[0])
    wavs = sorted(out.glob("*.wav"))
    assert len(wavs) == 1
    y, _ = read_wav(wavs[0])
    assert len(y) == 320 and np.isfinite(y).all()
    emb_out = tmp_path / "emb_joint"
    run("extract", "--dataset", wav_dir, "--out", emb_out, "--ckpt", joint,
        "--batch_size", 2)
    embs = sorted(emb_out.glob("*.npy"))
    assert len(embs) == 3
    cfgj = json.loads((joint / "config.json").read_text())
    assert np.load(embs[0]).shape[1] == cfgj["model"]["cond_dim"]
    rep = run_json("evaluate", "--ckpt", joint, "--dataset", wav_dir,
                   "--split", "val", "--batch_size", 2, "--seq_len", 320)
    assert np.isfinite(rep["nll_bits"]) and rep["batches"] > 0
    assert rep["conditioning"] == "joint"


def test_cli_generate_short_cond_stream_is_clamp_extended(cond_exp,
                                                          tmp_path):
    short = tmp_path / "short.npy"
    np.save(short, np.random.default_rng(0).normal(
        size=(2, 10)).astype(np.float32))   # 2 rows < 512/16 = 32 needed
    out = tmp_path / "gen_short_cond"
    run("generate", "--ckpt", cond_exp, "--out", out, "--n_seqs", 1,
        "--length", 512, "--temperature", 0.9, "--cond", short)
    y, _ = read_wav(sorted(out.glob("*.wav"))[0])
    assert len(y) == 512 and np.isfinite(y).all()


def test_cli_joint_full_trainer_contract(tmp_path):
    """--joint on the full Trainer plugin loop: held-out val NLL,
    checkpoints at cadence, --resume, `evaluate --best`."""
    d = tmp_path / "wavs"
    d.mkdir()
    rng = np.random.default_rng(1)
    t = np.arange(2048) / 16_000
    for i in range(12):
        x = 0.4 * np.sin(2 * np.pi * (120 + 40 * i) * t)
        x += 0.05 * rng.normal(size=t.size)
        write_wav(d / f"clip{i}.wav", np.clip(x, -1, 1), 16_000)
    exp = tmp_path / "exp_joint2"
    e = C.ExperimentConfig(
        model=C.SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8,
                                cond_dim=10, cond_rate=16,
                                compute_dtype="float32"),
        pase=PASE_TINY,
        train=C.TrainConfig(batch_size=2, seq_len=128, epochs=1,
                            exp_dir=str(exp), ckpt_every_steps=20,
                            val_every_steps=20, log_every_steps=5))
    cfg_path = tmp_path / "joint_cfg.json"
    cfg_path.write_text(C.to_json(e))
    run("train", "--joint", "--config", cfg_path, "--dataset", d,
        "--exp-dir", exp)
    metrics = [json.loads(line) for line in
               (exp / "metrics.jsonl").read_text().splitlines()]
    val_lines = [m for m in metrics if m.get("split") == "val"]
    assert val_lines and all(not m.get("val_is_train_fallback")
                             for m in val_lines)
    assert any(m.get("mode") == "joint" for m in metrics)
    run("train", "--joint", "--config", cfg_path, "--dataset", d,
        "--exp-dir", exp, "--resume", "--epochs", 2)
    out = run_json("evaluate", "--ckpt", exp, "--dataset", d,
                   "--split", "val", "--best")
    assert out["held_out"] is True
    assert np.isfinite(out["nll_bits"])


def test_cli_train_joint_pase_ckpt_frozen(wav_dir, tmp_path):
    """`train --joint --pase-ckpt F --freeze-pase`: the encoder starts from
    the file's weights and keeps them (only its BatchNorm state moves)."""
    from samplernn_pase_tpu_torch.models import pase
    from samplernn_pase_tpu_torch.train.checkpoint import CheckpointManager
    pcfg = PASE_TINY
    enc, bn = pase.init_pase(torch.Generator().manual_seed(5), pcfg, "cpu")
    pase.export_torch_pase(enc, bn, tmp_path / "pase.pt")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(C.to_json(C.ExperimentConfig(
        model=C.SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8,
                                cond_dim=10, cond_rate=16,
                                compute_dtype="float32"),
        pase=pcfg, train=C.TrainConfig(batch_size=2, seq_len=64,
                                       epochs=1))))
    exp = tmp_path / "exp"
    run("train", "--joint", "--config", cfg, "--dataset", wav_dir,
        "--exp-dir", exp, "--pase-ckpt", tmp_path / "pase.pt",
        "--freeze-pase")
    got = CheckpointManager(exp / "ckpt").restore()["params"]
    want, want_bn, _ = pase.load_torch_pase(tmp_path / "pase.pt", pcfg)
    for k in ("sinc", "bn_sinc", "proj"):
        for name, v in want[k].items():
            assert torch.equal(got["joint"]["pase"][k][name], v), (k, name)
    assert torch.equal(got["joint"]["pase"]["blocks"][0]["w"],
                       want["blocks"][0]["w"])
    assert float(got["bn"]["proj"]["count"]) > float(
        want_bn["proj"]["count"])


def test_cli_stream_verb(plain, tmp_path):
    out = tmp_path / "stream.wav"
    run("stream", "--ckpt", plain, "--out", out, "--seconds", 0.05,
        "--chunk-ms", 16, "--temperature", 0.9, "--seed", 3)
    y, sr = read_wav(out)
    assert sr == 16_000 and len(y) >= 256 and np.isfinite(y).all()
    out2 = tmp_path / "stream2.wav"
    run("stream", "--ckpt", plain, "--out", out2, "--seconds", 0.05,
        "--chunk-ms", 16, "--chunks-per-call", 4, "--temperature", 0)
    assert len(read_wav(out2)[0]) >= 256
    # --stream-key pins per-stream noise: the SAMPLED stream is identical
    # across chunk sizes and lookahead schedules
    outs = {}
    for tag, extra in (("a", ["--chunk-ms", 16]), ("b", ["--chunk-ms", 32]),
                       ("c", ["--chunk-ms", 16, "--chunks-per-call", 2])):
        p = tmp_path / f"sk_{tag}.wav"
        run("stream", "--ckpt", plain, "--out", p, "--seconds", 0.064,
            "--temperature", 0.9, "--stream-key", 5, *extra)
        outs[tag], _ = read_wav(p)
    assert len(outs["a"]) == len(outs["b"]) == 1024
    np.testing.assert_array_equal(outs["a"], outs["b"])
    np.testing.assert_array_equal(outs["a"], outs["c"])
    assert len(np.unique(outs["a"])) > 8          # genuinely sampled


def test_cli_stream_seed_wav_starts_at_continuation(plain, wav_dir,
                                                    tmp_path):
    """The warm-up emit must not advance the primed state: `stream
    --seed-wav` (greedy) equals the primed one-shot continuation."""
    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.data.dataset import _quantize_host
    from samplernn_pase_tpu_torch.train.checkpoint import CheckpointManager

    seed_wav = sorted(wav_dir.glob("*.wav"))[0]
    out = tmp_path / "sw.wav"
    run("stream", "--ckpt", plain, "--out", out, "--seconds", 0.02,
        "--chunk-ms", 8, "--temperature", 0, "--seed-wav", seed_wav)
    got, _ = read_wav(out)
    ecfg = C.load_config(plain / "config.json")
    params = CheckpointManager(plain / "ckpt").restore()["params"]
    x, _ = read_wav(seed_wav)
    lv = _quantize_host(x, ecfg.model.q_levels, ecfg.model.codec)
    states, hist = gen.prime(params, ecfg.model, lv[None], device="cpu")
    ref_levels = gen.generate_levels(
        params, ecfg.model, 1, len(got), temperature=None,
        initial_states=states, hist=hist, device="cpu")
    ref = gen.decode_waveform(ref_levels, ecfg.model).numpy()[0]
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_cli_stream_conditioned_matches_oneshot(cond_exp, tmp_path):
    """The greedy conditioned stream, enqueue-ahead and --blocked, is the
    one-shot `generate --cond` decode."""
    emb = np.random.default_rng(21).normal(size=(40, 10)).astype(
        np.float32)
    emb_path = tmp_path / "emb.npy"
    np.save(emb_path, emb)
    sr, chunk_ms, seconds, lb = 16_000, 16, 0.05, 8
    chunk = -(-int(sr * chunk_ms / 1000) // lb) * lb
    total = -(-int(sr * seconds) // chunk) * chunk
    outs = {}
    for tag, extra in (("ahead", []), ("blocked", ["--blocked"])):
        out = tmp_path / f"cs_{tag}.wav"
        run("stream", "--ckpt", cond_exp, "--out", out, "--seconds",
            seconds, "--chunk-ms", chunk_ms, "--temperature", 0,
            "--cond", emb_path, *extra)
        outs[tag], got_sr = read_wav(out)
        assert got_sr == sr and len(outs[tag]) == total
    np.testing.assert_array_equal(outs["ahead"], outs["blocked"])
    gen_out = tmp_path / "cs_gen"
    run("generate", "--ckpt", cond_exp, "--out", gen_out, "--n_seqs", 1,
        "--length", total, "--temperature", 0, "--cond", emb_path)
    ref, _ = read_wav(sorted(gen_out.glob("*.wav"))[0])
    np.testing.assert_allclose(outs["ahead"], ref, atol=1e-6)


def _split_total(d, split="train"):
    from samplernn_pase_tpu_torch.data.dataset import WavCorpus
    corpus = WavCorpus.from_folder(d, 256)
    idx = getattr(corpus, f"{split}_idx") or corpus.train_idx
    return corpus, sum(len(corpus.utterances[i]) for i in idx)


def test_cli_evaluate_small_split_scores_every_sample(imb):
    """A split smaller than batch_size runs in one lane, so every
    utterance is scored in full."""
    d, _, exps = imb
    rep = run_json("evaluate", "--ckpt", exps["plain"], "--dataset", d,
                   "--split", "train", "--batch_size", 8, "--seq_len", 256)
    _, total = _split_total(d)
    assert rep["batch_size"] == 1
    assert rep["samples"] == total, (rep["samples"], total)
    assert rep["coverage"] == 1.0
    assert np.isfinite(rep["nll_bits"]) and rep["nll_bits"] > 0


def test_cli_evaluate_conditioned_exact_on_imbalanced_split(imb):
    """The per-lane tail passes thread per-chunk conditioning too."""
    d, cond_dir, exps = imb

    def ev(batch_size):
        return run_json("evaluate", "--ckpt", exps["cond"], "--dataset", d,
                        "--cond-dir", cond_dir, "--split", "train",
                        "--batch_size", batch_size, "--seq_len", 256)

    full, exact = ev(2), ev(1)
    _, total = _split_total(d)
    assert full["samples"] == total == exact["samples"]
    assert full["coverage"] == 1.0 == exact["coverage"]
    assert full["conditioning"] == "cached"
    assert abs(full["nll_bits"] - exact["nll_bits"]) < 1e-4


def test_cli_evaluate_full_batch_exact_on_imbalanced_split(imb):
    """At batch 2 the aligned pass stops at the shortest lane; the
    per-lane tail passes score the rest: the full-batch NLL equals the
    1-lane NLL and coverage is exactly 1.0."""
    d, _, exps = imb
    corpus, total = _split_total(d)
    b = corpus.batcher("train", 2, 256, 8)
    assert any(len(lane) > len(b) for lane in b.lanes)

    def ev(batch_size):
        return run_json("evaluate", "--ckpt", exps["plain"], "--dataset", d,
                        "--split", "train", "--batch_size", batch_size,
                        "--seq_len", 256)

    full, exact = ev(2), ev(1)
    assert full["batch_size"] == 2 and exact["batch_size"] == 1
    assert full["samples"] == total == exact["samples"]
    assert full["coverage"] == 1.0 == exact["coverage"]
    assert abs(full["nll_bits"] - exact["nll_bits"]) < 1e-4, (
        full["nll_bits"], exact["nll_bits"])


def test_cli_platform_flag(wav_dir, tmp_path):
    """--platform cpu runs on the CPU; cuda (and auto) without a card
    exit naming --platform cpu before any file is written."""
    out = tmp_path / "emb"
    run("extract", "--dataset", wav_dir, "--out", out)
    assert sorted(out.glob("*.npy"))
    if torch.cuda.is_available():
        cli.main(["--platform", "cuda", "extract", "--dataset",
                  str(wav_dir), "--out", str(tmp_path / "emb2")])
        assert sorted((tmp_path / "emb2").glob("*.npy"))
        return
    for platform in ("cuda", "auto"):
        with pytest.raises(SystemExit, match="--platform cpu"):
            cli.main(["--platform", platform, "extract", "--dataset",
                      str(wav_dir), "--out", str(tmp_path / "emb2")])
        assert not (tmp_path / "emb2").exists()


def test_cli_serve_verb(plain, tmp_path):
    """Variable-length jobs through one StreamPool: one wav per job, a
    stats JSON, and greedy output equal to the generate verb's."""
    ref = tmp_path / "ref"
    run("generate", "--ckpt", plain, "--out", ref, "--n_seqs", 1,
        "--length", 128, "--temperature", 0)
    want, _ = read_wav(sorted(ref.glob("*.wav"))[0])
    manifest = tmp_path / "jobs.json"
    manifest.write_text(json.dumps([
        {"id": "alpha", "length": 128},
        {"length": 70},                       # id defaults to the index
        {"id": "tiny", "seconds": 70 / 16_000},
    ]))
    out = tmp_path / "served"
    run("serve", "--ckpt", plain, "--out", out, "--jobs", manifest,
        "--lanes", 2, "--chunk-ms", 4, "--temperature", 0)
    stats = json.loads((out / "serve_stats.json").read_text())
    assert stats["jobs"] == 3 and stats["lanes"] == 2
    assert 0 < stats["utilization"] <= 1.0
    a, sr = read_wav(out / "alpha.wav")
    assert sr == 16_000 and len(a) == 128
    np.testing.assert_allclose(a, want, atol=2e-4)   # == generate verb
    b, _ = read_wav(out / "job_001.wav")
    t, _ = read_wav(out / "tiny.wav")
    assert len(b) == 70 and len(t) == 70
    np.testing.assert_allclose(b, t, atol=1e-6)      # same greedy prefix


def test_cli_serve_n_jobs_and_validation(plain, tmp_path):
    out = tmp_path / "served"
    run("serve", "--ckpt", plain, "--out", out, "--n", 3, "--length", 64,
        "--lanes", 2, "--temperature", 0.9, "--seed", 1)
    wavs = sorted(out.glob("job_*.wav"))
    assert len(wavs) == 3
    assert all(len(read_wav(w)[0]) == 64 for w in wavs)
    # `seconds` rounds: 1001/16000 s * 16000 is 1000.9999999999999
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"id": "round", "seconds": 1001 / 16_000}]))
    out2 = tmp_path / "served2"
    run("serve", "--ckpt", plain, "--out", out2, "--jobs", bad, "--lanes", 1,
        "--chunk-ms", 64, "--temperature", 0)
    assert len(read_wav(out2 / "round.wav")[0]) == 1001
    # an int seed and a raw [2]-uint32 key both pin the job's audio
    # across pool layouts
    man = tmp_path / "keys.json"
    man.write_text(json.dumps([{"id": "k", "length": 64,
                                "stream_key": [3, 9]},
                               {"id": "s", "length": 64, "stream_key": 7}]))
    o3, o4 = tmp_path / "served3", tmp_path / "served4"
    run("serve", "--ckpt", plain, "--out", o3, "--jobs", man, "--lanes", 2,
        "--chunk-ms", 4, "--temperature", 0.9, "--seed", 1)
    run("serve", "--ckpt", plain, "--out", o4, "--jobs", man, "--lanes", 1,
        "--chunk-ms", 8, "--temperature", 0.9, "--seed", 2)
    for jid in ("k", "s"):
        np.testing.assert_array_equal(read_wav(o3 / f"{jid}.wav")[0],
                                      read_wav(o4 / f"{jid}.wav")[0])


# ----------------------------------------- every sys.exit of the verbs --

def _manifest(tmp_path, entries):
    p = tmp_path / "m.json"
    p.write_text(json.dumps(entries))
    return p


_NPY = {"bad": (4, 8), "ok": (8, 10)}

# (experiment, argv after the verb's --ckpt/--out, message): argv items
# "NPY:bad"/"NPY:ok" become .npy files of those shapes, "M:<json>" a
# manifest, "EMPTY" an empty directory
EXITS = [
    ("plain", ["generate", "--cond", "NPY:ok"], "require a model trained "
     "with conditioning"),
    ("cond_exp", ["generate", "--cond", "NPY:bad"],
     r"expected \[frames, 10\] embedding"),
    ("plain", ["generate", "--speaker", 0], "requires a model trained "
     "with n_speakers"),
    ("spk", ["generate", "--speaker", 2], r"out of range \[0, 2\)"),
    ("plain", ["stream", "--cond", "NPY:ok"], "require a model trained "
     "with conditioning"),
    ("cond_exp", ["stream", "--cond", "NPY:bad"],
     r"expected \[frames, 10\] embedding"),
    ("plain", ["stream", "--speaker", 0], "n_speakers"),
    ("spk", ["stream", "--speaker", -1], "out of range"),
    ("plain", ["serve"], "serve needs a job source"),
    ("plain", ["serve", "--jobs-dir", "EMPTY"], "has no cond_dim"),
    ("cond_exp", ["serve", "--jobs-dir", "EMPTY"], "no .npy embeddings"),
    ("plain", ["serve", "--jobs", 'M:{"id": 1}'], "must be a JSON list"),
    ("plain", ["serve", "--jobs", "M:[3]"], "entry 0 is not an object"),
    ("plain", ["serve", "--jobs", 'M:[{"id": "../escape", "length": 8}]'],
     "path separators"),
    ("plain", ["serve", "--jobs", 'M:[{"id": 1.5, "length": 8}]'],
     "id must be a string or integer"),
    ("plain", ["serve", "--jobs", 'M:[{"id": null, "length": 8}]'],
     "id must be a string or integer"),
    ("plain", ["serve", "--jobs", 'M:[{"id": "c", "cond": "NPY:ok"}]'],
     "trained without cond_dim"),
    ("cond_exp", ["serve", "--jobs", 'M:[{"id": "c", "cond": "NPY:bad"}]'],
     r"expected \[frames, 10\] embedding"),
    ("cond_exp", ["serve", "--jobs", 'M:[{"id": "c", "length": 8}]'],
     "every job needs cond/cond_wav"),
    ("spk", ["serve", "--jobs", 'M:[{"id": "s", "cond": "NPY:ok"}]'],
     "every job needs a speaker"),
    ("spk", ["serve", "--jobs", 'M:[{"cond": "NPY:ok", "speaker": 2}]'],
     "out of range"),
    ("plain", ["serve", "--jobs", 'M:[{"length": 8, "speaker": 0}]'],
     "trained without n_speakers"),
    ("plain", ["serve", "--temperature", 0.9, "--jobs",
               'M:[{"length": 8, "stream_key": [1, 2, 3]}]'],
     "raw \\[2\\]-uint32 key data"),
    ("plain", ["serve", "--temperature", 0.9, "--jobs",
               'M:[{"length": 8, "stream_key": "x"}]'],
     "must be an int seed"),
    ("plain", ["serve", "--temperature", 0.9, "--jobs",
               'M:[{"length": 8, "stream_key": 1.5}]'],
     "must be an int seed"),
    ("plain", ["serve", "--temperature", 0.9, "--jobs",
               'M:[{"length": 8, "stream_key": true}]'],
     "must be an int seed"),
    ("plain", ["serve", "--temperature", 0, "--jobs",
               'M:[{"id": "k", "length": 8, "stream_key": 7}]'],
     "greedy"),
    ("plain", ["extract"], "is not a --joint experiment checkpoint"),
    ("empty", ["generate"], "no checkpoint under"),
    ("empty", ["evaluate"], "no checkpoint under"),
    ("empty", ["stream"], "no checkpoint under"),
    ("empty", ["serve", "--n", 1], "no checkpoint under"),
]


@pytest.mark.parametrize("exp_name,argv,match", EXITS,
                         ids=[f"{i}-{e[1][0]}" for i, e in enumerate(EXITS)])
def test_cli_verbs_exit(exp_name, argv, match, request, tmp_path, wav_dir,
                        plain):
    """Each check of the reference's verbs exits with its message, before
    any output is written."""
    if exp_name == "empty":
        exp = tmp_path / "empty_exp"
        exp.mkdir()
        (exp / "config.json").write_text((plain / "config.json").read_text())
    else:
        exp = request.getfixturevalue(exp_name)

    def arg(a):
        a = str(a)
        if a.startswith("NPY:"):
            p = tmp_path / f"{a[4:]}.npy"
            np.save(p, np.zeros(_NPY[a[4:]], np.float32))
            return str(p)
        if a.startswith("M:"):
            text = a[2:]
            for k in _NPY:
                text = text.replace(f'"NPY:{k}"', json.dumps(arg(f"NPY:{k}")))
            return str(_manifest(tmp_path, json.loads(text)))
        if a == "EMPTY":
            (tmp_path / "none").mkdir(exist_ok=True)
            return str(tmp_path / "none")
        return a

    verb, rest = argv[0], [arg(a) for a in argv[1:]]
    out = tmp_path / ("out.wav" if verb == "stream" else "out")
    where = {"extract": ["--dataset", wav_dir, "--out", out],
             "evaluate": ["--dataset", wav_dir]}.get(
        verb, ["--out", out])
    with pytest.raises(SystemExit, match=match):
        run(verb, "--ckpt", exp, *where, *rest)
    assert not out.exists() or not list(out.glob("*.wav"))


# ------------------------------------------------- configs from flags --

ARGVS = {
    "config": ["--config", "TINY"],
    "preset": ["--preset", "c1_tiny_cpu"],
    "preset_dim_tracks_mlp": ["--preset", "c4_tts_conditioned",
                              "--dim", "32", "--embed_dim", "16",
                              "--batch_size", "4"],
    "default_dim": ["--dim", "64"],
    "rnn_layers_alias": ["--config", "TINY", "--rnn_layers", "2",
                         "--frame_sizes", "8", "2", "--rnn_type", "lstm",
                         "--dim", "24"],
    "train_flags": ["--config", "TINY", "--batch_size", "3", "--seq_len",
                    "128", "--lr", "0.002", "--lr_schedule", "cosine",
                    "--seed", "5", "--q_levels", "64", "--codec", "linear",
                    "--weight_norm", "--remat", "--cond_dim", "6",
                    "--cond_rate", "8", "--n_rnn", "2"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_cli_config_json_matches_reference(case, tmp_path, monkeypatch,
                                           wav_dir):
    """The config.json that the port's train writes is the reference's,
    byte for byte (same flags, aliases and precedence; --epochs 0 trains
    nothing)."""
    tiny = tmp_path / "tiny.json"
    tiny.write_text(C.to_json(C.ExperimentConfig(
        model=C.SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8,
                                compute_dtype="float32"),
        train=C.TrainConfig(batch_size=2, seq_len=64, epochs=1))))
    argv = ["train", "--dataset", str(wav_dir), "--exp-dir", "exp",
            "--epochs", "0"] + [str(tiny) if a == "TINY" else a
                                for a in ARGVS[case]]
    got = {}
    for name, main in (("ref", lambda: jcli.main(["--platform", "cpu",
                                                  *argv])),
                       ("port", lambda: cli.main(["--platform", "cpu",
                                                  *argv]))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        main()
        got[name] = (tmp_path / name / "exp" / "config.json").read_bytes()
    assert got["port"] == got["ref"]


# --------------------------------------------------- --stream-key words --

@pytest.mark.parametrize("n", [0, 1, 7, 2 ** 31, 2 ** 32 - 1, 2 ** 63])
def test_int_key_is_prngkey_words(n):
    """noise.int_key(N) is the [2] uint32 words of jax.random.PRNGKey(N),
    and raises where it raises."""
    try:
        want = np.asarray(jax.random.PRNGKey(n))
    except OverflowError:
        with pytest.raises(OverflowError):
            int_key(n)
        return
    got = int_key(n)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ utils.debug.checked --

def test_checked_passes_clean_fn():
    out = checked(lambda x: x * 2.0)(torch.ones(4))
    np.testing.assert_allclose(out.numpy(), 2.0)


def test_checked_raises_on_nan():
    with pytest.raises(ValueError, match="aten.log"):
        checked(torch.log)(torch.tensor([-1.0]))


def test_checked_masked_nan_matches_reference():
    """An intermediate NaN that a later where masks out of the result:
    the reference's checkify flags the log, and so does the port."""
    x = np.asarray([-1.0, 2.0], np.float32)
    with pytest.raises(Exception):
        jutils.checked(lambda v: jnp.where(v > 0, jnp.log(v), 0.0))(
            jnp.asarray(x))
    with pytest.raises(ValueError, match="aten.log"):
        checked(lambda v: torch.where(v > 0, torch.log(v),
                                      torch.zeros_like(v)))(
            torch.from_numpy(x))


def test_checked_leaves_results_and_gradients():
    """A clean function's outputs and gradients are the same under the
    wrapper."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 8)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 3)).astype(np.float32))

    def f(x, w):
        w = w.detach().requires_grad_(True)
        y = torch.tanh(x @ w).logsumexp(-1).sum()
        return y.detach(), torch.autograd.grad(y, w)[0]

    (y0, g0), (y1, g1) = f(x, w), checked(f)(x, w)
    assert torch.equal(y0, y1) and torch.equal(g0, g1)
