"""The one traffic generator: every mix is a data file of parameters under
``traffic/``, read here.  A seed changes the order of the work and the
values drawn (conditioning rows, noise keys, audio), never the amount: each
seed gets the same set of lengths and of gaps between arrivals, so runs
with different seeds do the same work.

Keys a traffic file may give (each driver reads the ones it needs):

* ``lengths``: a table of utterance durations, ``{"n": 64, "min_s": 1.1,
  "max_s": 10.1, "mean_s": 6.6}``: the quantiles ``min + (max - min) *
  u**p`` at ``u = (i + 0.5) / n``, with ``p`` set so that their mean is
  ``mean_s`` (LJSpeech's clips: 13,100 of 1.1-10.1 s, mean 6.6 s);
* ``rate_per_s``: Poisson arrivals at that rate, as the quantiles of the
  exponential gaps, shuffled;
* ``sample_rate``: samples per second of audio.
"""

from __future__ import annotations

import math

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per use of the seed."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def durations(spec: dict) -> np.ndarray:
    """The length table in seconds (the same for every seed)."""
    n, lo, hi, mean = spec["n"], spec["min_s"], spec["max_s"], spec["mean_s"]
    frac = (mean - lo) / (hi - lo)
    p = 1.0 / frac - 1.0                 # E[u**p] = 1 / (p + 1)
    u = (np.arange(n) + 0.5) / n
    return lo + (hi - lo) * u ** p


def rows_per_request(spec: dict, cond_rate: int, sample_rate: int):
    """Conditioning rows of each entry of the length table."""
    return np.ceil(durations(spec) * sample_rate / cond_rate).astype(int)


def arrivals(rate: float, seconds: float, rng) -> np.ndarray:
    """Arrival offsets in seconds of ``ceil(rate * seconds)`` requests: the
    gaps are the quantiles of an exponential of mean ``1 / rate``, in an
    order drawn from ``rng``."""
    n = max(1, math.ceil(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q) / rate)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def lane_keys(n: int, rng) -> np.ndarray:
    """[n, 2] uint32 noise keys, one per request."""
    return rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32)


def cond_rows(total: int, dim: int, seed: int, device):
    """``total`` conditioning rows of width ``dim`` (standard normal, the
    scale of PASE's batch-normalised embeddings) drawn on the device in one
    call and copied to the host once: float32 numpy [total, dim]."""
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    rows = torch.randn((total, dim), generator=gen, device=device)
    return rows.cpu().numpy()
