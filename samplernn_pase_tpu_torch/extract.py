"""PASE embedding extraction, as ``samplernn_pase_tpu.extract``: wavs
bucketed by length, right-padded to a common length per batch, run
through the encoder in eval mode and trimmed back to each utterance's own
frame count.  The batches are the reference's arrays: sorted by length
(``np.argsort``), padded to a multiple of ``decimation * 8``, each row
trimmed to ``max(len // decimation, 1)`` frames.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from samplernn_pase_tpu_torch.config import PASEConfig
from samplernn_pase_tpu_torch.device import resolve_device
from samplernn_pase_tpu_torch.models import pase as pase_mod
from samplernn_pase_tpu_torch.tree import tree_map


def make_extractor(cfg: PASEConfig, device=None):
    """(params, bn_state, wav [B, T]) -> emb [B, T // decimation, D]: the
    encoder in eval mode under ``torch.inference_mode()`` on ``device``
    (default CUDA, which must be present); params, state and wav are moved
    there."""
    dev = resolve_device(device)

    def fn(params, bn_state, wav):
        with torch.inference_mode():
            params, bn_state = tree_map(lambda t: t.to(dev),
                                        (params, bn_state))
            emb, _ = pase_mod.pase_apply(params, bn_state,
                                         torch.as_tensor(wav).to(dev), cfg,
                                         train=False)
        return emb

    return fn


def extract_embeddings(params, bn_state, cfg: PASEConfig, wavs,
                       batch_size: int = 16, pad_multiple: int | None = None,
                       device=None) -> list[np.ndarray]:
    """wavs: list of 1-D float arrays -> list of [frames_i, D] float32
    arrays, in the input's order."""
    pad_multiple = pad_multiple or (cfg.decimation * 8)
    fn = make_extractor(cfg, device)
    order = np.argsort([len(w) for w in wavs])  # bucket by length
    results: dict[int, np.ndarray] = {}
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        batch = [np.asarray(wavs[i], np.float32) for i in idx]
        max_len = max(len(w) for w in batch)
        padded_len = -(-max_len // pad_multiple) * pad_multiple
        x = np.zeros((len(batch), padded_len), np.float32)
        for row, w in enumerate(batch):
            x[row, :len(w)] = w
        emb = fn(params, bn_state, torch.from_numpy(x)).cpu().numpy()
        for row, i in enumerate(idx):
            n_frames = len(batch[row]) // cfg.decimation
            results[int(i)] = emb[row, :max(n_frames, 1)]
    return [results[i] for i in range(len(wavs))]


def extract_to_dir(params, bn_state, cfg: PASEConfig, wav_dir, out_dir,
                   batch_size: int = 16, device=None) -> list[Path]:
    """A folder of wavs -> one ``.npy`` of [frames, D] per utterance under
    ``out_dir``, mirroring the input tree (keyed by the wav's path relative
    to ``wav_dir``, so duplicate stems in speaker folders never collide and
    ``WavCorpus.from_folder(cond_dir=...)`` pairs the right arrays).  Each
    wav is resampled to ``cfg.sample_rate`` first, so a mixed-rate corpus
    gets one embedding rate.  Returns the written paths, sorted as the
    wavs."""
    from samplernn_pase_tpu_torch.ops.audio_io import read_wav, resample

    wav_dir, out_dir = Path(wav_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(wav_dir.glob("**/*.wav"))
    if not files:
        raise FileNotFoundError(f"no .wav files under {wav_dir}")
    wavs = []
    for f in files:
        x, sr = read_wav(f)
        wavs.append(resample(x, sr, cfg.sample_rate))
    embs = extract_embeddings(params, bn_state, cfg, wavs, batch_size,
                              device=device)
    outs = [out_dir / f.relative_to(wav_dir).with_suffix(".npy")
            for f in files]
    for o, e in zip(outs, embs):
        o.parent.mkdir(parents=True, exist_ok=True)
        np.save(o, e)
    return outs
