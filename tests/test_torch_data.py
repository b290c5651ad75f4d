"""The port's data path against the JAX package, on the CPU: the TBPTT
chunker and ``StreamBatcher`` (every field of every batch, array for
array, and a hypothesis fuzz over corpus shapes), ``WavCorpus`` (splits,
``from_folder`` on a folder of wavs with cached conditioning, resampling),
the native library's bindings against their numpy fallbacks, and
``audio_io`` against scipy, its oracle (the tests may import scipy; the
port may not).  Inputs come from a seed with numpy; the batcher and the
corpus must equal the reference bit for bit, ``resample`` within 1e-6."""

import shutil
import warnings
import wave

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from scipy.io import wavfile
from scipy.signal import resample_poly

from samplernn_pase_tpu.data import dataset as jds
from samplernn_pase_tpu.data import native_loader as jnl
from samplernn_pase_tpu.ops import audio_io as jaio
from samplernn_pase_tpu.ops import framing as jfr
from samplernn_pase_tpu_torch.data import dataset as tds
from samplernn_pase_tpu_torch.data import native_loader as tnl
from samplernn_pase_tpu_torch.ops import audio_io as taio
from samplernn_pase_tpu_torch.ops import framing as tfr
from samplernn_pase_tpu_torch.ops import init as tinit
from samplernn_pase_tpu_torch.utils import profiling


def _same_item(a, b):
    """Two batcher items (a TBPTTChunk, or (chunk, cond)) field for
    field: the same arrays, dtypes and Nones."""
    if isinstance(a, tuple) and not hasattr(a, "_fields"):
        assert isinstance(b, tuple) and not hasattr(b, "_fields")
        _same_item(a[0], b[0])
        assert a[1].dtype == b[1].dtype
        np.testing.assert_array_equal(a[1], b[1])
        return
    assert type(a).__name__ == type(b).__name__ == "TBPTTChunk"
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def _same_batcher(tb, jb):
    assert len(tb) == len(jb)
    assert tb.coverage == jb.coverage
    assert tb.total_chunks == jb.total_chunks
    titems, jitems = list(tb), list(jb)
    assert len(titems) == len(jitems) == len(jb)
    for a, b in zip(titems, jitems):
        _same_item(a, b)
    for lane in range(jb.batch_size):
        ta, ja = list(tb.lane_tail(lane)), list(jb.lane_tail(lane))
        assert len(ta) == len(ja)
        for a, b in zip(ta, ja):
            _same_item(a, b)


def _utts(rng, n, lo, hi):
    return [rng.integers(0, 256, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("seq_len,overlap", [(256, 64), (32, 8), (7, 3)])
def test_chunk_for_tbptt_matches(seq_len, overlap):
    stream = np.random.default_rng(seq_len).integers(0, 256, 1000)
    got = tfr.chunk_for_tbptt(stream, seq_len, overlap)
    want = jfr.chunk_for_tbptt(stream, seq_len, overlap)
    assert len(got) == len(want) > 0
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)


# (batch, seq_len, overlap, n_utts, length range, cond_rate, speakers,
#  shuffle seed)
BATCHER_CASES = {
    "even": (2, 32, 8, 4, (64, 65), None, False, None),
    "ragged": (3, 32, 8, 7, (5, 150), None, False, None),
    "shuffle": (3, 32, 8, 9, (20, 200), None, False, 11),
    "cond": (2, 32, 8, 5, (40, 160), 8, False, None),
    "speakers": (4, 48, 4, 9, (10, 200), None, True, 3),
    "cond_speakers_shuffle": (3, 64, 16, 8, (30, 300), 16, True, 5),
}


@pytest.mark.parametrize("case", sorted(BATCHER_CASES))
def test_batcher_matches_reference(case):
    b, seq_len, overlap, n, (lo, hi), rate, spk, seed = BATCHER_CASES[case]
    rng = np.random.default_rng(len(case))
    utts = _utts(rng, n, lo, hi)
    kw = dict(q_zero=128, shuffle_seed=seed)
    if rate:
        # cond rows a little short of, or past, each utterance's frames
        kw["conditioning"] = [
            rng.normal(size=(max(1, len(u) // rate + int(rng.integers(
                -1, 3))), 3)).astype(np.float32) for u in utts]
        kw["cond_rate"] = rate
    if spk:
        kw["speaker_ids"] = [int(v) for v in rng.integers(0, 3, n)]
    _same_batcher(tfr.StreamBatcher(utts, b, seq_len, overlap, **kw),
                  jfr.StreamBatcher(utts, b, seq_len, overlap, **kw))


def test_batcher_rejects_what_the_reference_rejects():
    utts = [np.zeros(64, np.int32)] * 2
    cond = [np.zeros((8, 2), np.float32)] * 2
    for kw in (dict(conditioning=cond[:1], cond_rate=8),
               dict(conditioning=cond),
               dict(conditioning=cond, cond_rate=24),
               dict(speaker_ids=[0])):
        for mod in (tfr, jfr):
            with pytest.raises(ValueError):
                mod.StreamBatcher(utts, 2, 32, 8, q_zero=0, **kw)


@settings(max_examples=25, deadline=None)
@given(b=st.integers(1, 4), seq_len=st.sampled_from([16, 32, 48]),
       overlap=st.sampled_from([4, 8]), data=st.data())
def test_batcher_fuzz_matches_reference(b, seq_len, overlap, data):
    """tests/test_framing.py::test_batcher_invariants_fuzz, run against
    both packages: the port's batches equal the reference's, and the
    invariants hold on the port's (resets exactly at utterance starts,
    left context equal to the previous chunk's tail, coverage)."""
    seed = data.draw(st.integers(0, 2 ** 16))
    rng = np.random.default_rng(seed)
    n_utts = int(rng.integers(b, b * 4 + 1))
    utts = _utts(rng, n_utts, 1, 4 * seq_len)
    shuffle = data.draw(st.none() | st.integers(0, 100))
    sb = tfr.StreamBatcher(utts, b, seq_len, overlap, q_zero=0,
                           shuffle_seed=shuffle)
    _same_batcher(sb, jfr.StreamBatcher(utts, b, seq_len, overlap,
                                        q_zero=0, shuffle_seed=shuffle))
    chunks = list(sb)
    assert sb.coverage == (len(sb) * b / sb.total_chunks
                           if sb.total_chunks else 1.0)
    for lane in range(b):
        prev_tail = None
        for chunk in chunks:
            window = chunk.inputs[lane]
            if chunk.resets[lane]:
                assert np.all(window[:overlap] == 0)
            elif prev_tail is not None:
                np.testing.assert_array_equal(window[:overlap], prev_tail)
            prev_tail = window[-overlap:]
        n_resets = sum(bool(c.resets[lane]) for c in chunks)
        assert n_resets == sum(1 for w, t, first, *_ in
                               sb.lanes[lane][:len(sb)] if first)


@pytest.mark.parametrize("val_frac,test_frac,n", [
    (0.1, 0.0, 40), (0.3, 0.2, 25), (0.0, 0.0, 6), (0.1, 0.0, 2)])
def test_corpus_splits_and_batchers_match(val_frac, test_frac, n):
    rng = np.random.default_rng(n)
    utts = _utts(rng, n, 50, 400)
    conds = [rng.normal(size=(len(u) // 8 + 1, 2)).astype(np.float32)
             for u in utts]
    spk = [i % 3 for i in range(n)]
    kw = dict(val_frac=val_frac, test_frac=test_frac, conditioning=conds,
              speakers=spk)
    tc, jc = tds.WavCorpus(utts, **kw), jds.WavCorpus(utts, **kw)
    assert (tc.train_idx, tc.val_idx, tc.test_idx) == (
        jc.train_idx, jc.val_idx, jc.test_idx)
    assert tc.has_val == jc.has_val and tc.names == jc.names
    for split in ("train", "val", "test"):
        fallback = not getattr(jc, f"{split}_idx")
        for seed in (None, 7):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tb = tc.batcher(split, 3, 32, 8, cond_rate=8,
                                shuffle_seed=seed)
                jb = jc.batcher(split, 3, 32, 8, cond_rate=8,
                                shuffle_seed=seed)
            # both warn that a held-out split fell back to train data
            assert len(caught) == 2 * fallback, [str(w.message)
                                                 for w in caught]
            _same_batcher(tb, jb)


def test_synthetic_corpus_matches():
    tc = tds.synthetic_corpus(n_utts=5, length=3000, seed=4)
    jc = jds.synthetic_corpus(n_utts=5, length=3000, seed=4)
    assert tc.names == jc.names and tc.train_idx == jc.train_idx
    for a, b in zip(tc.utterances, jc.utterances):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("codec", ["mulaw", "linear"])
def test_from_folder_matches(tmp_path, codec):
    """A speaker/utt.wav tree with duplicate stems across speakers, one
    file at another rate (resampled to the first file's rate), and cached
    conditioning paired by relative path."""
    rng = np.random.default_rng(3)
    root, cond_dir = tmp_path / "wavs", tmp_path / "cond"
    for spk in ("alice", "bob"):
        (root / spk).mkdir(parents=True)
        (cond_dir / spk).mkdir(parents=True)
        for i in range(6):
            sr = 8_000 if (spk, i) == ("bob", 3) else 16_000
            x = (rng.uniform(-0.9, 0.9, int(rng.integers(300, 900)))
                 * 32767).astype(np.int16)
            wavfile.write(root / spk / f"utt{i}.wav", sr, x)
            np.save(cond_dir / spk / f"utt{i}.npy",
                    rng.normal(size=(len(x) // 80 + 1, 4)).astype(
                        np.float32))
    tc = tds.WavCorpus.from_folder(root, val_frac=0.3, cond_dir=cond_dir,
                                   codec=codec)
    jc = jds.WavCorpus.from_folder(root, val_frac=0.3, cond_dir=cond_dir,
                                   codec=codec)
    assert tc.names == jc.names and tc.speakers == jc.speakers
    assert tc.sample_rate == jc.sample_rate == 16_000
    assert (tc.train_idx, tc.val_idx) == (jc.train_idx, jc.val_idx)
    assert tc.val_idx, "the split should hold out some files"
    for a, b in zip(tc.utterances, jc.utterances):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tc.conditioning, jc.conditioning):
        np.testing.assert_array_equal(a, b)
    _same_batcher(tc.batcher("train", 2, 64, 16, cond_rate=16),
                  jc.batcher("train", 2, 64, 16, cond_rate=16))
    with pytest.raises(ValueError, match="resample=False"):
        tds.WavCorpus.from_folder(root, resample=False)
    with pytest.raises(FileNotFoundError):
        tds.WavCorpus.from_folder(tmp_path / "cond")


def test_native_builds_and_routes(tmp_path, monkeypatch):
    """The port binds the same native library as the reference; a fresh
    build is written under its own name and renamed into place."""
    assert tnl.available() and tnl.route() == "native"
    native = tmp_path / "native"
    shutil.copytree(tnl._NATIVE_DIR / "src", native / "src")
    shutil.copy(tnl._NATIVE_DIR / "Makefile", native / "Makefile")
    monkeypatch.setattr(tnl, "_NATIVE_DIR", native)
    monkeypatch.setattr(tnl, "_LIB_PATH", native / "libsrnn_native.so")
    assert tnl._build()
    assert sorted(p.name for p in native.iterdir()) == [
        "Makefile", "libsrnn_native.so", "src"]


def test_native_matches_numpy_and_reference(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.3, 1.3, 50_000).astype(np.float32)
    tnl.reset_routes()
    got = tnl.mulaw_encode(x)
    want = tds._quantize_host(x, 256)
    # float32 native against the float64 numpy oracle: boundary wiggle
    assert np.mean(got == want) > 0.999 and np.max(np.abs(got - want)) <= 1
    np.testing.assert_array_equal(got, jnl.mulaw_encode(x))
    lv = np.arange(256, dtype=np.int32)
    np.testing.assert_array_equal(tnl.mulaw_decode(lv), jnl.mulaw_decode(lv))
    np.testing.assert_array_equal(tnl.mulaw_encode(tnl.mulaw_decode(lv)), lv)
    p = tmp_path / "t.wav"
    wavfile.write(p, 16_000, (rng.uniform(-0.8, 0.8, (4000, 2))
                              * 32767).astype(np.int16))
    w_nat, sr = tnl.read_wav(p)
    w_np, sr_np = taio.read_wav(p)
    assert sr == sr_np == 16_000
    np.testing.assert_allclose(w_nat, w_np, atol=2e-5)
    lq, sr = tnl.load_quantized(p)
    assert sr == 16_000 and np.max(np.abs(lq - tds._quantize_host(
        w_np, 256))) <= 1
    np.testing.assert_array_equal(lq, jnl.load_quantized(p)[0])
    assert tnl.ROUTES == {"native": 6, "numpy": 0}
    # an 8-bit file is left to the numpy reader, and counted so
    wavfile.write(p, 8_000, rng.integers(0, 256, 100).astype(np.uint8))
    np.testing.assert_array_equal(tnl.read_wav(p)[0], jaio.read_wav(p)[0])
    assert tnl.ROUTES["numpy"] == 1
    # the batcher's gather: one native call per step, equal to np.stack
    utts = _utts(rng, 4, 100, 300)
    tnl.reset_routes()
    sb = tfr.StreamBatcher(utts, 2, 32, 8, q_zero=128)
    items = list(sb)
    assert tnl.ROUTES == {"native": len(sb), "numpy": 0}
    for k, item in enumerate(items):
        np.testing.assert_array_equal(item.inputs, np.stack(
            [sb.lanes[b][k][0] for b in range(2)]))


def test_native_fallback_is_numpy(monkeypatch):
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_tried", True)
    assert not tnl.available() and tnl.route() == "numpy"
    x = np.random.default_rng(1).uniform(-1, 1, 1000).astype(np.float32)
    np.testing.assert_array_equal(tnl.mulaw_encode(x),
                                  tds._quantize_host(x, 256))
    assert tnl.gather_windows(np.zeros(1, np.int64), 4) is None
    utts = [np.arange(100, dtype=np.int32)] * 2
    tnl.reset_routes()
    items = list(tfr.StreamBatcher(utts, 2, 32, 8, q_zero=0))
    assert tnl.ROUTES == {"native": 0, "numpy": len(items)}


def _wav_bytes(tag, channels, rate, bits, payload, extensible=False):
    import struct
    align = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else tag, channels,
                      rate, rate * align, align, bits)
    if extensible:
        # cbSize, valid bits, channel mask, then the sub-format GUID: the
        # format tag and the KSDATAFORMAT suffix
        fmt += struct.pack("<HHIH14s", 22, bits, 0, tag,
                           b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa"
                           b"\x00\x38\x9b\x71")
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"LIST" + struct.pack("<I", 3) + b"abc\x00"
            + b"data" + struct.pack("<I", len(payload)) + payload)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("kind", [
    "int16", "int16_stereo", "uint8", "int32_3ch", "float32",
    "float32_stereo", "float64", "int24", "int16_extensible"])
def test_read_wav_matches_scipy(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    p = tmp_path / f"{kind}.wav"
    data = {
        "int16": lambda: (rng.uniform(-1, 1, 999) * 32767).astype(np.int16),
        "int16_stereo": lambda: (rng.uniform(-1, 1, (500, 2))
                                 * 32767).astype(np.int16),
        "uint8": lambda: rng.integers(0, 256, 700).astype(np.uint8),
        "int32_3ch": lambda: rng.integers(-2 ** 31, 2 ** 31 - 1,
                                          (400, 3)).astype(np.int32),
        "float32": lambda: rng.uniform(-1.3, 1.3, 600).astype(np.float32),
        "float32_stereo": lambda: rng.uniform(-1, 1, (300, 2)).astype(
            np.float32),
        "float64": lambda: rng.uniform(-1, 1, 300),
    }
    if kind in data:
        wavfile.write(p, 22_050, data[kind]())
    elif kind == "int24":
        raw = rng.integers(0, 256, 3 * 2 * 250, dtype=np.uint8).tobytes()
        p.write_bytes(_wav_bytes(1, 2, 44_100, 24, raw))
    else:
        raw = (rng.uniform(-1, 1, 301) * 32767).astype("<i2").tobytes()
        p.write_bytes(_wav_bytes(1, 1, 16_000, 16, raw, extensible=True))
    got, sr = taio.read_wav(p)
    want, sr_w = jaio.read_wav(p)
    assert sr == sr_w and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr_in,sr_out", [
    (22_050, 16_000), (8_000, 16_000), (48_000, 16_000), (44_100, 16_000),
    (16_000, 22_050), (16_000, 8_000), (11_025, 16_000), (16_000, 16_000)])
def test_resample_matches_scipy(sr_in, sr_out):
    x = np.random.default_rng(sr_in).uniform(-0.95, 0.95, 4321)
    got = taio.resample(x, sr_in, sr_out)
    from math import gcd
    g = gcd(sr_in, sr_out)
    want = (x if sr_in == sr_out else resample_poly(
        x, sr_out // g, sr_in // g))
    want = np.clip(want, -1, 1).astype(np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, jaio.resample(x, sr_in, sr_out),
                               atol=1e-6, rtol=0)


def test_write_wav_matches_reference(tmp_path):
    x = np.random.default_rng(2).uniform(-1.2, 1.2, 2000).astype(np.float32)
    x[:3] = [0.5 / 32767, -1.5 / 32767, 2.5 / 32767]   # halves: np.round
    taio.write_wav(tmp_path / "t.wav", x, 8_000)
    jaio.write_wav(tmp_path / "j.wav", x, 8_000)
    sr_t, got = wavfile.read(tmp_path / "t.wav")
    sr_j, want = wavfile.read(tmp_path / "j.wav")
    assert sr_t == sr_j == 8_000 and got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    with wave.open(str(tmp_path / "t.wav")) as w:
        assert (w.getnchannels(), w.getsampwidth()) == (1, 2)


def test_device_put_batch_and_zeros(monkeypatch):
    sb = tfr.StreamBatcher([np.arange(80, dtype=np.int32)] * 2, 2, 32, 8,
                           q_zero=0, conditioning=[np.ones((10, 3),
                                                           np.float32)] * 2,
                           cond_rate=8, speaker_ids=[0, 1])
    chunk, cond = next(iter(sb))
    tchunk, tcond = tds.device_put_batch((chunk, cond), "cpu")
    assert type(tchunk).__name__ == "TBPTTChunk"
    for name in chunk._fields:
        np.testing.assert_array_equal(getattr(tchunk, name).numpy(),
                                      getattr(chunk, name))
    assert tcond.dtype == torch.float32 and tcond.shape == (2, 4, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.device_put_batch(chunk)
    z = tinit.zeros((2, 3))
    assert z.dtype == torch.float32 and not z.any()
    assert tinit.zeros([4], torch.int32).dtype == torch.int32


def test_profiling_trace(tmp_path):
    with profiling.trace(tmp_path / "prof") as t:
        torch.ones(64).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert t.wall_s > 0
