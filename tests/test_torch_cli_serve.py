"""The port's command line against the reference's on the same
experiments: three experiments trained by the reference's ``train``
(float32: a speaker model on cached rows, a ``--joint`` model with a
float32 encoder, an unconditioned model), each carried into a port
experiment with ``convert.experiment_from_jax``; then both CLIs run
``generate``, ``evaluate``, ``stream``, ``serve`` and ``extract`` on the
same inputs.  Greedy audio is held to the int16 PCM within 1 LSB (a
flipped mu-law level moves a sample by at least 5 LSB; the reference's
``expm1`` is up to 3 ulp off; measured on the CPU, no sample differs
in any case here), ``evaluate`` to every key equal and
``nll_bits`` within 1e-5, embeddings to a relative norm.  Sampled audio
cannot be the reference's (Philox against threefry), so the
``--stream-key`` properties are held within the port."""

import contextlib
import io
import json
import shutil
import wave

import jax
import numpy as np
import pytest
import torch

from samplernn_pase_tpu import cli as jcli
from samplernn_pase_tpu import config as JC
from samplernn_pase_tpu.models import pase as jpase
from samplernn_pase_tpu.train.checkpoint import CheckpointManager as JMgr
from samplernn_pase_tpu_torch import cli, convert
from samplernn_pase_tpu_torch import config as C
from samplernn_pase_tpu_torch.ops.audio_io import write_wav
from samplernn_pase_tpu_torch.ops.kernels.noise import int_key
from samplernn_pase_tpu_torch.train.checkpoint import CheckpointManager

from torch_threads import one_thread  # noqa: F401 (a fixture)

MODEL = dict(frame_sizes=(4, 2), dim=32, embed_dim=8,
             compute_dtype="float32")
PASE = dict(sinc_filters=8, sinc_kernel=33, blocks=((8, 5, 4), (12, 5, 4)),
            emb_dim=10, compute_dtype="float32")
TRAIN = dict(batch_size=2, seq_len=256, epochs=1)


# one intra-op thread in this process (torch_threads.py)
pytestmark = pytest.mark.usefixtures("one_thread")


def _main(which):
    return jcli.main if which == "ref" else cli.main


def run(which, *argv):
    _main(which)(["--platform", "cpu", *map(str, argv)])


def run_json(which, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(which, *argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def pcm(path) -> np.ndarray:
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()),
                             "<i2").astype(np.int32)


def assert_pcm_close(got, want):
    """int16 PCM within 1 LSB; returns how many samples differ."""
    a, b = pcm(got), pcm(want)
    assert a.shape == b.shape, (a.shape, b.shape)
    diff = np.abs(a - b)
    assert diff.max(initial=0) <= 1, (got, int(diff.max()),
                                      int((diff > 0).sum()))
    return int((diff > 0).sum())


def _corpus(d, lengths, seed, cond_dir):
    d.mkdir(parents=True)
    cond_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16_000
        x = 0.5 * np.sin(2 * np.pi * (150 + 55 * i) * t)
        x += 0.05 * rng.normal(size=n)
        write_wav(d / f"utt{i}.wav", np.clip(x, -1, 1), 16_000)
        np.save(cond_dir / f"utt{i}.npy", rng.normal(
            size=(-(-n // 16), 10)).astype(np.float32))
    return d, cond_dir


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The reference tests' corpus (3 utterances of 4,096 samples) and an
    imbalanced one, each with cached rows; two embedding files."""
    root = tmp_path_factory.mktemp("cli_x")
    wavs, cond = _corpus(root / "wavs", [4096] * 3, 0, root / "cond")
    imb, imb_cond = _corpus(root / "imb", [3000, 2100, 1200, 700], 7,
                            root / "imb_cond")
    rng = np.random.default_rng(3)
    np.save(root / "emb.npy", rng.normal(size=(40, 10)).astype(np.float32))
    np.save(root / "emb2.npy", rng.normal(size=(9, 10)).astype(np.float32))
    for spk in ("a", "b"):     # --jobs-dir walks the tree
        (root / "embs" / spk).mkdir(parents=True)
        shutil.copy(root / f"emb{'' if spk == 'a' else 2}.npy",
                    root / "embs" / spk / f"{spk}.npy")
    return dict(root=root, wavs=wavs, cond=cond, imb=imb, imb_cond=imb_cond,
                wav=sorted(wavs.glob("*.wav"))[0], embs=root / "embs",
                emb=root / "emb.npy", emb2=root / "emb2.npy")


def _carry(ref_dir, port_dir):
    """A reference experiment -> a port experiment dir: its config.json
    and its latest checkpoint through convert.experiment_from_jax."""
    mgr = JMgr(ref_dir / "ckpt")
    restored = mgr.restore()
    mgr.close()
    payload = convert.experiment_from_jax(restored)
    port_dir.mkdir()
    shutil.copy(ref_dir / "config.json", port_dir / "config.json")
    CheckpointManager(port_dir / "ckpt").save(payload["step"],
                                              payload["params"])


@pytest.fixture(scope="module")
def exps(data):
    """{name: {"ref": dir, "port": dir}} for "spk" (cond_dim 10,
    cond_rate 16, n_speakers 2, trained on cached rows), "joint" (trained
    with --joint, float32 encoder) and "uncond"."""
    root = data["root"]
    specs = {
        "spk": (JC.ExperimentConfig(
            model=JC.SampleRNNConfig(cond_dim=10, cond_rate=16,
                                     n_speakers=2, **MODEL),
            train=JC.TrainConfig(**TRAIN)), ["--cond-dir", data["cond"]]),
        "joint": (JC.ExperimentConfig(
            model=JC.SampleRNNConfig(cond_dim=10, cond_rate=16, **MODEL),
            pase=JC.PASEConfig(**PASE), train=JC.TrainConfig(**TRAIN)),
            ["--joint"]),
        "uncond": (JC.ExperimentConfig(
            model=JC.SampleRNNConfig(**MODEL),
            train=JC.TrainConfig(**TRAIN)), []),
    }
    out = {}
    for name, (exp, extra) in specs.items():
        cfg = root / f"{name}.json"
        cfg.write_text(JC.to_json(exp))
        ref = root / f"ref_{name}"
        run("ref", "train", "--config", cfg, "--dataset", data["wavs"],
            "--exp-dir", ref, *extra)
        _carry(ref, root / f"port_{name}")
        out[name] = {"ref": ref, "port": root / f"port_{name}"}
    return out


def test_experiment_from_jax_carries_the_checkpoint(exps):
    """The carried checkpoint holds the reference's step and every
    parameter (and, for the joint run, the encoder's BatchNorm state)."""
    from samplernn_pase_tpu_torch.tree import tree_leaves
    for name, dirs in exps.items():
        mgr = JMgr(dirs["ref"] / "ckpt")
        want = mgr.restore()
        mgr.close()
        got = CheckpointManager(dirs["port"] / "ckpt").restore()
        assert got["step"] == want["step"]
        a = sorted(float(np.abs(np.asarray(x, np.float64)).sum())
                   for x in tree_leaves(convert.to_numpy(got["params"])))
        b = sorted(float(np.abs(np.asarray(x, np.float64)).sum())
                   for x in jax.tree_util.tree_leaves(want["params"]))
        np.testing.assert_allclose(a, b, rtol=0, atol=0)


# ---------------------------------------------------------- generate --

GENERATE = {
    "none": ("uncond", []),
    "cond": ("spk", ["--cond", "EMB"]),
    "cond_wav": ("joint", ["--cond-wav", "WAV"]),
    "speaker": ("spk", ["--speaker", 1]),
    "seed_wav": ("joint", ["--cond-wav", "WAV", "--seed-wav", "WAV"]),
}


def _args(data, argv):
    sub = {"EMB": data["emb"], "EMB2": data["emb2"], "WAV": data["wav"],
           "COND": data["cond"], "IMB": data["imb"],
           "IMB_COND": data["imb_cond"], "EMBS": data["embs"]}
    return [sub.get(a, a) if isinstance(a, str) else a for a in argv]


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_generate_greedy_matches_reference(case, exps, data, tmp_path):
    """Greedy `generate` at n_seqs 2: the same PCM within 1 LSB."""
    name, extra = GENERATE[case]
    outs = {}
    for which in ("ref", "port"):
        outs[which] = tmp_path / which
        run(which, "generate", "--ckpt", exps[name][which], "--out",
            outs[which], "--n_seqs", 2, "--length", 256, "--temperature", 0,
            *_args(data, extra))
    for i in range(2):
        assert_pcm_close(outs["port"] / f"gen_{i:03d}.wav",
                         outs["ref"] / f"gen_{i:03d}.wav")
    if case == "seed_wav":   # one primed lane copied to both
        assert np.array_equal(pcm(outs["port"] / "gen_000.wav"),
                              pcm(outs["port"] / "gen_001.wav"))


# ---------------------------------------------------------- evaluate --

EVALUATE = {
    "val_speaker_only": ("spk", ["--split", "val"]),
    "test_fallback": ("spk", ["--split", "test", "--cond-dir", "COND"]),
    "train_batch1_cached": ("spk", ["--split", "train", "--batch_size", 1,
                                    "--cond-dir", "COND"]),
    "imbalanced_full_batch": ("spk", ["--dataset", "IMB", "--split",
                                      "train", "--cond-dir", "IMB_COND"]),
    "imbalanced_batch1": ("spk", ["--dataset", "IMB", "--split", "train",
                                  "--batch_size", 1, "--cond-dir",
                                  "IMB_COND"]),
    "joint_val": ("joint", ["--split", "val"]),
    "uncond_train": ("uncond", ["--split", "train"]),
}


@pytest.mark.parametrize("case", sorted(EVALUATE))
def test_evaluate_matches_reference(case, exps, data):
    """`evaluate`: every key equal, nll_bits within 1e-5."""
    name, extra = EVALUATE[case]
    extra = _args(data, extra)
    if "--dataset" not in extra:
        extra = ["--dataset", data["wavs"], *extra]
    got = {which: run_json(which, "evaluate", "--ckpt", exps[name][which],
                           *extra) for which in ("ref", "port")}
    assert abs(got["port"].pop("nll_bits") - got["ref"].pop("nll_bits")) \
        <= 1e-5
    assert got["port"] == got["ref"]
    assert got["port"]["coverage"] == 1.0


# ------------------------------------------------------------ stream --

STREAM = {
    "cond_8ms_ahead": ("spk", ["--chunk-ms", 8, "--cond", "EMB"]),
    "cond_16ms_blocked": ("spk", ["--chunk-ms", 16, "--cond", "EMB",
                                  "--blocked"]),
    "seed_wav_16ms": ("uncond", ["--chunk-ms", 16, "--seed-wav", "WAV"]),
    "joint_seed_lookahead": ("joint", ["--chunk-ms", 8, "--cond-wav", "WAV",
                                       "--seed-wav", "WAV",
                                       "--chunks-per-call", 2]),
}


@pytest.mark.parametrize("case", sorted(STREAM))
def test_stream_greedy_matches_reference(case, exps, data, tmp_path):
    """Greedy `stream`: the same PCM within 1 LSB."""
    name, extra = STREAM[case]
    for which in ("ref", "port"):
        run(which, "stream", "--ckpt", exps[name][which], "--out",
            tmp_path / f"{which}.wav", "--seconds", 0.03, "--temperature",
            0, *_args(data, extra))
    assert_pcm_close(tmp_path / "port.wav", tmp_path / "ref.wav")


# ------------------------------------------------------------- serve --

def _jobs(data, tmp_path):
    """A manifest beside relative and absolute paths: seconds, length,
    cond, cond_wav and seed_wav entries."""
    shutil.copy(data["emb2"], tmp_path / "rel.npy")
    shutil.copy(data["wav"], tmp_path / "seed.wav")
    m = tmp_path / "jobs.json"
    m.write_text(json.dumps([
        {"id": "sec", "seconds": 0.006, "cond": str(data["emb"])},
        {"id": "len", "length": 100, "cond": "rel.npy"},
        {"cond": "rel.npy"},                      # length = 9 rows * 16
        {"id": "wav", "length": 64, "cond_wav": "seed.wav",
         "seed_wav": "seed.wav"},
    ]))
    return m


SERVE = {
    "jobs": ("joint", ["--jobs", "JOBS"]),
    "jobs_dir": ("spk", ["--jobs-dir", "EMBS", "--speaker", 1]),
    "n": ("uncond", ["--n", 3, "--length", 72]),
}


@pytest.mark.parametrize("case", sorted(SERVE))
def test_serve_greedy_matches_reference(case, exps, data, tmp_path):
    """Greedy `serve`: one wav per job with the same PCM within 1 LSB, and
    serve_stats.json with the same keys and utilization."""
    name, extra = SERVE[case]
    extra = [str(_jobs(data, tmp_path)) if a == "JOBS" else a
             for a in _args(data, extra)]
    stats = {}
    for which in ("ref", "port"):
        out = tmp_path / f"out_{which}"
        run(which, "serve", "--ckpt", exps[name][which], "--out", out,
            "--lanes", 2, "--chunk-ms", 4, "--temperature", 0, *extra)
        stats[which] = json.loads((out / "serve_stats.json").read_text())
    names = sorted(p.name for p in (tmp_path / "out_ref").glob("*.wav"))
    assert names == sorted(p.name for p in
                           (tmp_path / "out_port").glob("*.wav"))
    assert len(names) == stats["ref"]["jobs"]
    for n in names:
        assert_pcm_close(tmp_path / "out_port" / n, tmp_path / "out_ref" / n)
    assert set(stats["port"]) == set(stats["ref"])
    for k in ("jobs", "chunks", "chunk", "lanes", "generated", "dispatched",
              "utilization", "sample_rate"):
        assert stats["port"][k] == stats["ref"][k], k


# ----------------------------------------------------------- extract --

def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("source,bound", [("pase_ckpt", 1e-2),
                                          ("joint_ckpt", 2e-4)])
def test_extract_matches_reference(source, bound, exps, data, tmp_path):
    """`extract` with a --pase-ckpt file written by the reference's
    export_torch_pase (the default encoder, bf16) and with --ckpt on the
    joint experiment (float32): each embedding within ``bound`` in
    relative norm (measured on the CPU: at most 4.9e-3 and 6.7e-7)."""
    if source == "pase_ckpt":
        params, bn = jpase.init_pase(jax.random.PRNGKey(3), JC.PASEConfig())
        jpase.export_torch_pase(params, bn, tmp_path / "pase.pt")
        src = {w: ["--pase-ckpt", tmp_path / "pase.pt"]
               for w in ("ref", "port")}
    else:
        src = {w: ["--ckpt", exps["joint"][w]] for w in ("ref", "port")}
    for which in ("ref", "port"):
        run(which, "extract", "--dataset", data["wavs"], "--out",
            tmp_path / which, "--batch_size", 2, *src[which])
    files = sorted(p.name for p in (tmp_path / "ref").glob("*.npy"))
    assert len(files) == 3
    for f in files:
        a, b = np.load(tmp_path / "port" / f), np.load(tmp_path / "ref" / f)
        assert a.shape == b.shape and a.dtype == np.float32
        assert _rel(a, b) <= bound, (f, _rel(a, b))


# ------------------------------------------- --stream-key, port only --

def test_stream_key_is_invariant_and_equals_a_pool_lane(exps, data,
                                                        tmp_path):
    """`stream --stream-key 7` (sampled) is the same audio at any
    --chunk-ms and --chunks-per-call, and equals a StreamPool lane
    started with int_key(7) beside other lanes."""
    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.serve import StreamPool

    exp = exps["spk"]["port"]
    for tag, extra in (("a", ["--chunk-ms", 8]), ("b", ["--chunk-ms", 16]),
                       ("c", ["--chunk-ms", 8, "--chunks-per-call", 3])):
        run("port", "stream", "--ckpt", exp, "--out", tmp_path / f"{tag}.wav",
            "--seconds", 0.032, "--temperature", 0.9, "--stream-key", 7,
            "--cond", data["emb"], "--speaker", 1, *extra)
    a = pcm(tmp_path / "a.wav")
    assert len(a) == 512 and len(np.unique(a)) > 8
    assert np.array_equal(a, pcm(tmp_path / "b.wav"))
    assert np.array_equal(a, pcm(tmp_path / "c.wav"))
    ecfg = C.load_config(exp / "config.json")
    params = CheckpointManager(exp / "ckpt").restore()["params"]
    pool = StreamPool(params, ecfg.model, n_lanes=3, temperature=0.9, seed=5,
                      device="cpu")
    emb = np.load(data["emb"])
    pool.start(cond=emb[::-1].copy(), speaker=0)
    lane = pool.start(cond=emb, speaker=1, stream_key=int_key(7))
    levels = torch.cat([pool.emit(128)[lane] for _ in range(4)])
    write_wav(tmp_path / "pool.wav",
              gen.decode_waveform(levels, ecfg.model).numpy(), 16_000)
    assert np.array_equal(a, pcm(tmp_path / "pool.wav"))


def test_serve_int_stream_key_equals_the_stream(exps, data, tmp_path):
    """A `serve` job with stream_key 7 is `stream --stream-key 7` over its
    length, whatever the pool's lanes and chunk."""
    exp = exps["spk"]["port"]
    run("port", "stream", "--ckpt", exp, "--out", tmp_path / "s.wav",
        "--seconds", 0.016, "--chunk-ms", 8, "--temperature", 0.9,
        "--stream-key", 7, "--cond", data["emb"], "--speaker", 1)
    m = tmp_path / "jobs.json"
    m.write_text(json.dumps([
        {"id": "other", "length": 200, "cond": str(data["emb2"])},
        {"id": "keyed", "length": 256, "cond": str(data["emb"]),
         "stream_key": 7}]))
    run("port", "serve", "--ckpt", exp, "--out", tmp_path / "out", "--jobs",
        m, "--lanes", 2, "--chunk-ms", 4, "--temperature", 0.9, "--seed", 3,
        "--speaker", 1)
    assert np.array_equal(pcm(tmp_path / "out" / "keyed.wav"),
                          pcm(tmp_path / "s.wav"))
