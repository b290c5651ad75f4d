"""Folder-of-wavs corpus, as ``samplernn_pase_tpu.data.dataset``.

Scans a directory for .wav files, mu-law-quantizes each utterance on the
host, splits train/val/test by the MD5 hash of each file's bare stem, and
hands utterance streams to ``StreamBatcher`` for the TBPTT batch layout.
Optional per-utterance conditioning (cached embeddings, one ``.npy`` per
wav) rides along.  Everything here is host numpy and gives the
reference's arrays bit for bit; ``device_put_batch`` copies a batch to
the device.

``synthetic_corpus`` builds a deterministic mixture-of-sines corpus, so
the whole path runs without audio assets.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from samplernn_pase_tpu_torch.device import resolve_device
from samplernn_pase_tpu_torch.ops.audio_io import read_wav
from samplernn_pase_tpu_torch.ops.framing import StreamBatcher
from samplernn_pase_tpu_torch.ops.mulaw import quantize_zero


def _quantize_host(x: np.ndarray, q_levels: int,
                   codec: str = "mulaw") -> np.ndarray:
    # host-side numpy mirror of ops.mulaw (same frozen contract)
    x = np.clip(x.astype(np.float64), -1.0, 1.0)
    if codec == "linear":
        lv = np.floor((x + 1.0) * 0.5 * (q_levels - 1) + 0.5)
        return np.clip(lv, 0, q_levels - 1).astype(np.int32)
    mu = float(q_levels - 1)
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    lv = np.floor((y + 1.0) * 0.5 * mu + 0.5)
    return np.clip(lv, 0, q_levels - 1).astype(np.int32)


class WavCorpus:
    """A set of quantized utterances with deterministic train/val split."""

    def __init__(self, utterances: Sequence[np.ndarray], q_levels: int = 256,
                 sample_rate: int = 16_000, names: Sequence[str] | None = None,
                 val_frac: float = 0.1,
                 conditioning: Sequence[np.ndarray] | None = None,
                 speakers: Sequence[int] | None = None,
                 test_frac: float = 0.0,
                 split_keys: Sequence[str] | None = None):
        self.q_levels = q_levels
        self.sample_rate = sample_rate
        self.utterances = [np.asarray(u, np.int32) for u in utterances]
        self.names = list(names) if names else [
            f"utt{i:05d}" for i in range(len(utterances))]
        self.conditioning = conditioning
        self.speakers = list(speakers) if speakers is not None else None
        # deterministic train/val/test split by key hash (stable across
        # runs/machines; C3's three-way corpus split). split_keys lets
        # from_folder hash the bare file stem even though names are
        # relative paths, so an utterance's split does not depend on
        # the folder layout (flat vs speaker/utt.wav)
        split_keys = (list(split_keys) if split_keys is not None
                      else self.names)
        self.val_idx, self.test_idx, self.train_idx = [], [], []
        v_cut = val_frac * 1000
        t_cut = v_cut + test_frac * 1000
        for i, n in enumerate(split_keys):
            h = int(hashlib.md5(n.encode()).hexdigest(), 16) % 1000
            if h < v_cut:
                self.val_idx.append(i)
            elif h < t_cut:
                self.test_idx.append(i)
            else:
                self.train_idx.append(i)
        if not self.train_idx:  # tiny corpora: train on everything —
            # and the "held-out" splits are then train data, so clear
            # them (has_val must not report a real split; the batcher's
            # explicit train-fallback warning fires instead)
            self.train_idx = list(range(len(self.names)))
            self.val_idx, self.test_idx = [], []

    @classmethod
    def from_folder(cls, path, q_levels: int = 256, val_frac: float = 0.1,
                    cond_dir=None, codec: str = "mulaw",
                    sample_rate: int | None = None, resample: bool = True):
        """Scan `path` for .wav files; optionally pair cached PASE
        embeddings from `cond_dir` (one .npy per wav, keyed by the wav's
        path relative to `path` — duplicate stems across speaker dirs
        stay distinct).

        Rate safety (C19): with ``sample_rate`` given, every file is
        polyphase-resampled to it; with ``sample_rate=None`` the first
        file's rate becomes the corpus rate and differing files are
        resampled to match.  ``resample=False`` turns mismatches into a
        hard error instead — a mixed-rate corpus never trains silently
        at the wrong rate.

        Uses the native C++ fused wav->levels loader when the shared
        library is available (data/native_loader.py), else numpy.
        """
        from samplernn_pase_tpu_torch.data import native_loader
        from samplernn_pase_tpu_torch.ops.audio_io import resample as _resample

        root = Path(path)
        files = sorted(root.glob("**/*.wav"))
        if not files:
            raise FileNotFoundError(f"no .wav files under {path}")
        use_native = codec == "mulaw" and native_loader.available()
        utts, names, conds = [], [], []
        target_rate = sample_rate
        # speaker id from parent directory name (speaker/utt.wav layout);
        # flat corpora get a single speaker 0
        dir_names = sorted({f.parent.name for f in files})
        spk_of = {d: i for i, d in enumerate(dir_names)}
        speakers = []
        split_keys = []
        for f in files:
            if use_native:
                lv, sr = native_loader.load_quantized(f, q_levels)
                x = None
            else:
                native_loader.ROUTES["numpy"] += 1
                x, sr = read_wav(f)
                lv = None
            if target_rate is None:
                target_rate = sr
            if sr != target_rate:
                if not resample:
                    raise ValueError(
                        f"{f}: sample rate {sr} != corpus rate "
                        f"{target_rate} and resample=False")
                if x is None:   # native path skipped the float decode
                    x, _ = read_wav(f)
                x = _resample(x, sr, target_rate)
                lv = _quantize_host(x, q_levels, codec)
            elif lv is None:
                lv = _quantize_host(x, q_levels, codec)
            rel = f.relative_to(root).with_suffix("")
            utts.append(lv)
            names.append(rel.as_posix())
            split_keys.append(f.stem)   # split independent of layout
            speakers.append(spk_of[f.parent.name])
            if cond_dir is not None:
                cand = Path(cond_dir) / rel.parent / f"{f.stem}.npy"
                if not cand.exists():   # legacy flat layout: bare stem
                    cand = Path(cond_dir) / f"{f.stem}.npy"
                conds.append(np.load(cand))
        return cls(utts, q_levels, target_rate or 16_000, names, val_frac,
                   conds if cond_dir is not None else None,
                   speakers=speakers, split_keys=split_keys)

    @property
    def has_val(self) -> bool:
        """True when a real held-out val split exists (hygiene: callers
        must not treat the train-split fallback NLL as held-out)."""
        return bool(self.val_idx)

    def _subset(self, idx):
        utts = [self.utterances[i] for i in idx]
        conds = ([self.conditioning[i] for i in idx]
                 if self.conditioning is not None else None)
        spks = ([self.speakers[i] for i in idx]
                if self.speakers is not None else None)
        return utts, conds, spks

    def batcher(self, split: str, batch_size: int, seq_len: int,
                overlap: int, cond_rate: int | None = None,
                shuffle_seed: int | None = None) -> StreamBatcher:
        """shuffle_seed varies the data order per epoch (the TBPTT
        analogue of the reference DataLoader's shuffle): it permutes
        the utterance list (which sets length-balanced lane assignment
        tie-breaks) AND the order of each lane's utterances inside
        StreamBatcher; chunk order within an utterance stays sequential
        for state carry."""
        idx = {"train": self.train_idx, "val": self.val_idx,
               "test": self.test_idx}[split]
        if not idx:
            if split != "train":
                import warnings
                warnings.warn(
                    f"corpus has no '{split}' split; falling back to the "
                    "train split — metrics on it are NOT held-out",
                    stacklevel=2)
            idx = self.train_idx
        if shuffle_seed is not None:
            rng = np.random.default_rng(shuffle_seed)
            idx = [idx[i] for i in rng.permutation(len(idx))]
        if len(idx) < batch_size:
            # recycle utterances so every batch lane has a stream
            idx = (idx * (-(-batch_size // len(idx))))[:max(
                batch_size, len(idx))]
        utts, conds, spks = self._subset(idx)
        return StreamBatcher(
            utts, batch_size, seq_len, overlap,
            q_zero=quantize_zero(self.q_levels),
            conditioning=conds, cond_rate=cond_rate, speaker_ids=spks,
            shuffle_seed=shuffle_seed)


def synthetic_corpus(n_utts: int = 8, length: int = 32_768,
                     q_levels: int = 256, sample_rate: int = 16_000,
                     seed: int = 0) -> WavCorpus:
    """Deterministic mixture-of-sines corpus (no audio assets needed)."""
    rng = np.random.default_rng(seed)
    utts = []
    t = np.arange(length) / sample_rate
    for _ in range(n_utts):
        f0 = rng.uniform(80, 400)
        x = sum(rng.uniform(0.1, 0.5) * np.sin(2 * np.pi * f0 * (k + 1) * t
                                               + rng.uniform(0, 2 * np.pi))
                for k in range(4))
        x = 0.8 * x / np.max(np.abs(x))
        utts.append(_quantize_host(x.astype(np.float32), q_levels))
    return WavCorpus(utts, q_levels, sample_rate)


def _to_device(a, dev: torch.device):
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    # a pinned staging copy per call: the caching host allocator does not
    # hand its block out again before the copy that reads it has finished
    return t.pin_memory().to(dev, non_blocking=True)


def device_put_batch(chunk, device=None):
    """A host batch (an ndarray, a ``TBPTTChunk``, or a tuple of them such
    as ``(chunk, cond)``) -> the same structure of tensors on ``device``
    (default CUDA, which must be present).  On CUDA each array goes
    through pinned memory and is copied without blocking the host."""
    dev = resolve_device(device)
    if isinstance(chunk, tuple):
        parts = [device_put_batch(c, dev) if c is not None else None
                 for c in chunk]
        return type(chunk)(*parts) if hasattr(chunk, "_fields") else tuple(
            parts)
    return _to_device(chunk, dev)
