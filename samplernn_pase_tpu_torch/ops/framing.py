"""Framing and TBPTT chunking, as ``samplernn_pase_tpu.ops.framing``.

Two halves:

* device side: ``frame_signal``, a reshape of a sample stream into
  non-overlapping frames, used by the frame tiers;
* host side: ``chunk_for_tbptt`` and ``StreamBatcher``, which split
  utterances into ``seq_len``-sample training chunks, each carrying
  ``overlap`` (the model's lookback) samples of left context, and lay
  batches out so that lane ``b`` always sees consecutive chunks of the
  same utterance stream: the invariant that lets each tier's hidden state
  carry across TBPTT steps.  ``reset[b]`` is 1 exactly when lane ``b``
  starts a new utterance.

The host half is numpy, copied from the reference (whose module imports
``jax.numpy``) and held to give the same arrays bit for bit; the trainer
copies its batches to the device (``data.dataset.device_put_batch``).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch


def frame_signal(x: torch.Tensor, frame_size: int) -> torch.Tensor:
    """[..., T] -> [..., T // frame_size, frame_size]; T must divide evenly."""
    t = x.shape[-1]
    if t % frame_size != 0:
        raise ValueError(f"length {t} not divisible by frame_size {frame_size}")
    return x.reshape(*x.shape[:-1], t // frame_size, frame_size)


class TBPTTChunk(NamedTuple):
    """One training batch for one TBPTT step.

    inputs:  int32 [B, overlap + seq_len] — quantized levels; the first
             ``overlap`` samples are left context (lookback).
    targets: int32 [B, seq_len]           — inputs shifted by one, i.e.
             the levels at positions [overlap, overlap + seq_len).
    resets:  bool  [B]                    — lane starts a fresh stream; the
             trainer zeros that lane's hidden state.
    speakers: int32 [B] or None           — per-lane speaker id of the
             current utterance (multi-speaker corpora, C12).
    valid:   int32 [B] or None            — number of REAL target samples
             in each lane's window (the rest is q_zero right-tail padding
             up to a whole chunk). The loss masks positions >= valid so
             padded silence is never scored — the reference's
             drop-incomplete-tail semantics expressed as a mask (SURVEY.md
             §2 C2/C13). None (hand-built chunks) = all positions valid.
    """

    inputs: np.ndarray
    targets: np.ndarray
    resets: np.ndarray
    speakers: np.ndarray | None = None
    valid: np.ndarray | None = None


def chunk_for_tbptt(
    stream: np.ndarray, seq_len: int, overlap: int
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Split one quantized utterance stream into (input, target) chunks.

    The stream is prepended with ``overlap`` silence-level samples is NOT
    done here — callers pad (see StreamBatcher, which seeds each stream
    with q_zero context, matching the reference's q_zero seeding).
    Trailing samples that do not fill a chunk are dropped.
    """
    chunks = []
    n = (len(stream) - overlap) // seq_len
    for i in range(n):
        start = i * seq_len
        window = stream[start : start + overlap + seq_len]
        chunks.append((window, window[overlap:]))
    return chunks


class StreamBatcher:
    """Batch-of-streams TBPTT iterator (C2 + the batch-layout part of C3).

    Concatenates utterances into ``batch_size`` independent streams,
    then yields aligned TBPTT chunks: step k of the iterator is chunk k
    of every lane.  reset[b] is True on the first chunk of each
    utterance assigned to lane b, so hidden state is zeroed exactly at
    utterance boundaries while carrying across chunks inside an utterance.

    Utterance->lane assignment is LENGTH-BALANCED (greedy bin-packing:
    longest-first, each onto the currently-shortest lane) because an
    epoch ends when the shortest lane runs dry — round-robin assignment
    on an uneven corpus starves every other lane behind one long
    utterance and silently drops their tails.  For equal-length
    utterances this reduces exactly to round-robin (the stable sort
    keeps input order and the min-lane cycles 0..B-1).  Chunk order
    *within* an utterance stays sequential — the TBPTT state-carry
    invariant.  ``shuffle_seed`` permutes the order of each lane's
    utterances (the longest-first packing is otherwise deterministic on
    uneven corpora, so an input-order shuffle alone would be absorbed
    by the sort): data order varies per epoch, balance is unchanged.

    Each utterance is padded on the left with ``overlap`` q_zero samples
    (generation seeds the same way, SURVEY.md §3.2) and on the right up to
    a whole number of seq_len chunks with q_zero; the chunk's ``valid``
    counts exclude that right-tail padding so the masked loss scores
    exactly the samples the reference's drop-incomplete-tail chunking
    would have scored (C2/C13 parity) while keeping shapes static.
    """

    def __init__(
        self,
        utterances: Sequence[np.ndarray],
        batch_size: int,
        seq_len: int,
        overlap: int,
        q_zero: int,
        conditioning: Sequence[np.ndarray] | None = None,
        cond_rate: int | None = None,
        speaker_ids: Sequence[int] | None = None,
        shuffle_seed: int | None = None,
    ):
        if conditioning is not None and len(conditioning) != len(utterances):
            raise ValueError("one conditioning array per utterance required")
        if conditioning is not None and cond_rate is None:
            raise ValueError("conditioning requires cond_rate")
        if conditioning is not None and seq_len % cond_rate:
            import math
            step = math.lcm(cond_rate, max(overlap, 1))
            raise ValueError(
                f"cond_rate must divide seq_len: seq_len={seq_len}, "
                f"cond_rate={cond_rate} — pick a multiple of "
                f"lcm(cond_rate, lookback)={step}, e.g. "
                f"{-(-seq_len // step) * step}")
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.overlap = overlap
        self.q_zero = q_zero
        self.cond_rate = cond_rate
        self.cond_dim = conditioning[0].shape[-1] if conditioning is not None else 0

        if speaker_ids is not None and len(speaker_ids) != len(utterances):
            raise ValueError("one speaker id per utterance required")
        self.has_speakers = speaker_ids is not None

        # lane -> list of (inputs, targets, is_first, cond_chunk, speaker)
        self.lanes: list[list] = [[] for _ in range(batch_size)]
        # phase 1 — greedy bin-packing assignment: longest-first
        # (stable), onto the lane with the fewest chunks so far (ties ->
        # lowest lane index)
        counts = [max(1, int(np.ceil(len(np.asarray(u)) / seq_len)))
                  for u in utterances]
        order = sorted(range(len(utterances)), key=lambda u: -counts[u])
        lane_tot = np.zeros(batch_size, np.int64)
        self.total_chunks = int(sum(counts))
        lane_utts: list[list] = [[] for _ in range(batch_size)]
        for u in order:
            lane = int(np.argmin(lane_tot))
            lane_tot[lane] += counts[u]
            lane_utts[lane].append(u)
        # phase 2 — epoch stochasticity under the balanced assignment:
        # the longest-first sort makes the packing deterministic on
        # uneven corpora (a pre-shuffle of the input list only permutes
        # equal-length ties), so the per-epoch shuffle instead permutes
        # the ORDER of each lane's utterances — data order varies every
        # epoch while chunk order within an utterance stays sequential
        # (the TBPTT invariant) and the balance is untouched
        if shuffle_seed is not None:
            rng = np.random.default_rng(shuffle_seed)
            for lane in range(batch_size):
                lane_utts[lane] = [
                    lane_utts[lane][j]
                    for j in rng.permutation(len(lane_utts[lane]))]
        # phase 3 — materialize chunks lane by lane
        for lane in range(batch_size):
          for u in lane_utts[lane]:
            utt = utterances[u]
            spk = speaker_ids[u] if speaker_ids is not None else 0
            utt = np.asarray(utt)
            n_chunks = counts[u]
            padded = np.full(overlap + n_chunks * seq_len, q_zero, utt.dtype)
            padded[overlap : overlap + len(utt)] = utt
            cond_frames = None
            if conditioning is not None:
                per_chunk = seq_len // cond_rate
                cond_frames = np.zeros(
                    (n_chunks * per_chunk, self.cond_dim), np.float32
                )
                c = np.asarray(conditioning[u], np.float32)
                cond_frames[: min(len(c), len(cond_frames))] = c[: len(cond_frames)]
            for k in range(n_chunks):
                window = padded[k * seq_len : k * seq_len + overlap + seq_len]
                cond_k = None
                if cond_frames is not None:
                    per_chunk = seq_len // cond_rate
                    cond_k = cond_frames[k * per_chunk : (k + 1) * per_chunk]
                # real (non-padding) target samples in this chunk — the
                # tail chunk of an utterance carries len(utt) % seq_len
                valid = int(np.clip(len(utt) - k * seq_len, 0, seq_len))
                self.lanes[lane].append(
                    (window, window[overlap:], k == 0, cond_k, spk, valid))

    def __len__(self) -> int:
        return min(len(lane) for lane in self.lanes) if self.batch_size else 0

    @property
    def coverage(self) -> float:
        """Fraction of the corpus's chunks consumed per epoch: the epoch
        stops when the shortest lane runs dry, so longer lanes' tails
        are dropped. Balanced assignment keeps this near 1.0."""
        if not self.total_chunks:
            return 1.0
        return len(self) * self.batch_size / self.total_chunks

    def lane_tail(self, lane: int) -> Iterator:
        """One lane's chunks BEYOND the aligned-epoch horizon, as 1-wide
        batches.  ``__iter__`` stops at the shortest lane (min over lane
        chunk counts) — the chunks it leaves unconsumed on longer lanes
        are exactly ``self.lanes[lane][len(self):]``.  Evaluation scores
        them with a second 1-wide pass per lane, continuing from that
        lane's carried hidden state, so full-batch NLL covers every real
        sample of the split (SURVEY.md §2 C2/C13 exactness at any batch
        size).  Yields the same item shape as ``__iter__`` with B=1.
        """
        for k in range(len(self), len(self.lanes[lane])):
            window, _target, first, cond_k, spk, valid = self.lanes[lane][k]
            inputs = np.asarray(window, np.int32)[None]
            chunk = TBPTTChunk(
                inputs, inputs[:, self.overlap:],
                np.array([first], bool),
                np.array([spk], np.int32) if self.has_speakers else None,
                np.array([valid], np.int32))
            if self.cond_dim:
                yield chunk, np.asarray(cond_k, np.float32)[None]
            else:
                yield chunk

    def _window_addrs(self, n_steps: int) -> np.ndarray | None:
        """Pre-resolve every (step, lane) window's host address for the
        native batched gather — valid only when all windows are
        contiguous int32 views (they are whenever the utterances came in
        as int32, the WavCorpus contract)."""
        addrs = np.empty((n_steps, self.batch_size), np.int64)
        for b in range(self.batch_size):
            lane = self.lanes[b]
            for k in range(n_steps):
                win = lane[k][0]
                if win.dtype != np.int32 or not win.flags["C_CONTIGUOUS"]:
                    return None
                addrs[k, b] = win.ctypes.data
        return addrs

    def __iter__(self) -> Iterator[TBPTTChunk]:
        from samplernn_pase_tpu_torch.data import native_loader

        n_steps = len(self)
        w = self.overlap + self.seq_len
        # hot path: one native memcpy-gather per step instead of a
        # 128-lane Python np.stack; targets are a zero-copy view of the
        # gathered inputs (they are inputs shifted by `overlap`)
        # build=False: use the native gather when the .so is already
        # there, but never block the first batch on a `make` subprocess
        # (corpora that never touched the native decoder, e.g. synthetic)
        addrs = (self._window_addrs(n_steps)
                 if n_steps and native_loader.available(build=False)
                 else None)
        for k in range(n_steps):
            if addrs is not None:
                inputs = native_loader.gather_windows(addrs[k], w)
            if addrs is None or inputs is None:
                native_loader.ROUTES["numpy"] += 1
                inputs = np.stack(
                    [self.lanes[b][k][0] for b in range(self.batch_size)]
                ).astype(np.int32)
            targets = inputs[:, self.overlap:]
            resets = np.array(
                [self.lanes[b][k][2] for b in range(self.batch_size)], bool
            )
            speakers = None
            if self.has_speakers:
                speakers = np.array(
                    [self.lanes[b][k][4] for b in range(self.batch_size)],
                    np.int32)
            valid = np.array(
                [self.lanes[b][k][5] for b in range(self.batch_size)],
                np.int32)
            chunk = TBPTTChunk(inputs, targets, resets, speakers, valid)
            if self.cond_dim:
                cond = np.stack(
                    [self.lanes[b][k][3] for b in range(self.batch_size)]
                )
                yield chunk, cond
            else:
                yield chunk
