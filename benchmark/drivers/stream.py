"""Streaming TTS: an open loop of conditioned requests into one serving pool.

Requests arrive as a Poisson process at ``rate_per_s`` for the window's
``--seconds`` (``generator.arrivals``); each carries conditioning rows drawn
from the seed, as many as its duration from the length table needs at
``cond_rate`` samples a row, and its own noise key.  One
``serve.StreamPool`` of ``lanes`` lanes emits ``chunk``-sample chunks for
every lane; at each chunk boundary the requests that are due join free
lanes (``StreamPool.start``), in arrival order, and a request stops once
the chunks launched for it cover its rows.  Chunks are drained
enqueue-ahead, as ``serve.run_jobs`` drains them: chunk t+1 is launched
before chunk t is read, each copied to pinned host memory behind its own
launch (``serve.host_copy``/``host_wait``).

Time to first audio is taken from a request's scheduled arrival to the
host holding its first chunk; a chunk gap is the time between the host
receiving one chunk of a stream and its next.  The window runs from the
first arrival until every request due in it has been served, and a request
not served within 60 s of the last arrival counts as failed.

Checked: ``check_requests`` finished requests drawn from the seed, the
longest among them; their served levels are replayed through the reference
with their rows and noise keys (``token_gap``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generator, harness
from benchmark.reference import check as rcheck
from benchmark.weights import make_params

GRACE_S = 60.0


def make_requests(run, n_requests: int, stream: int):
    """Rows, lengths and noise keys of ``n_requests`` requests: the length
    table's entries in an order drawn from the seed, cycled."""
    tr, cfg = run.traffic, run.cfg
    rng = generator.rng_for(run.seed, stream)
    table = generator.rows_per_request(tr["lengths"], cfg.cond_rate,
                                     tr["sample_rate"])
    order = np.concatenate([rng.permutation(len(table)) for _ in range(
        -(-n_requests // len(table)))])[:n_requests]
    rows = table[order]
    allrows = generator.cond_rows(int(rows.sum()), cfg.cond_dim,
                                run.seed + stream, run.device)
    starts = np.concatenate([[0], np.cumsum(rows)[:-1]])
    conds = [allrows[s:s + r] for s, r in zip(starts, rows)]
    keys = generator.lane_keys(n_requests, rng)
    return {"cond": conds, "keys": keys, "samples": rows * cfg.cond_rate}


def setup(run):
    from samplernn_pase_tpu_torch import serve

    tr = run.traffic
    params = make_params(run.model, run.seed, run.device)
    rng = generator.rng_for(run.seed, 3)
    offsets = generator.arrivals(tr["rate_per_s"], run.seconds, rng)
    reqs = make_requests(run, len(offsets), 4)
    pool = serve.StreamPool(params, run.cfg, n_lanes=tr["lanes"],
                            temperature=tr["temperature"], seed=run.seed,
                            max_cond_frames=tr["max_cond_frames"],
                            device=run.device)
    # warm-up: joins, emits, the drain and stops at the window's shapes
    warm = [pool.start(cond=reqs["cond"][i % len(offsets)],
                       stream_key=reqs["keys"][i % len(offsets)])
            for i in range(tr["warm_lanes"])]
    inflight = [serve.host_copy(pool.emit(tr["chunk"])) for _ in range(3)]
    for c in inflight:
        serve.host_wait(c)
    for lane in warm:
        pool.stop(lane)
    run.sync()
    return {"params": params, "pool": pool, "offsets": offsets,
            "reqs": reqs}


def window(run, state):
    from samplernn_pase_tpu_torch import serve

    tr = run.traffic
    pool, reqs, offsets = state["pool"], state["reqs"], state["offsets"]
    chunk = tr["chunk"]
    n = len(offsets)
    first = np.full(n, np.nan)
    recv = [[] for _ in range(n)]
    pieces = [[] for _ in range(n)]
    launched = np.zeros(n, np.int64)
    active: dict = {}                 # lane -> request
    inflight: list = []
    nxt = 0                           # next request to join
    chunks = 0

    def drain(entry):
        copy, snapshot = entry
        with run.span("drain"):
            arr = serve.host_wait(copy)
        now = time.perf_counter()
        for lane, i in snapshot.items():
            pieces[i].append(arr[lane].copy())
            recv[i].append(now)
            if np.isnan(first[i]):
                first[i] = now

    run.start_window()
    t0 = run.window_t0
    deadline = t0 + offsets[-1] + GRACE_S
    while nxt < n or active or inflight:
        run.tick()
        now = time.perf_counter()
        if now > deadline:
            break
        while (nxt < n and t0 + offsets[nxt] <= now
               and len(pool.active) < pool.n):
            with run.span("join"):
                lane = pool.start(cond=reqs["cond"][nxt],
                                  stream_key=reqs["keys"][nxt])
            active[lane] = nxt
            nxt += 1
        if active:
            snapshot = dict(active)
            with run.span("emit"):
                copy = serve.host_copy(pool.emit(chunk))
            chunks += 1
            for lane, i in list(active.items()):
                launched[i] += chunk
                if launched[i] >= reqs["samples"][i]:
                    pool.stop(lane)
                    del active[lane]
            inflight.append((copy, snapshot))
            while len(inflight) > 1:
                drain(inflight.pop(0))
        else:
            while inflight:
                drain(inflight.pop(0))
            if nxt < n:
                with run.span("idle"):
                    time.sleep(max(0.0, t0 + offsets[nxt]
                                   - time.perf_counter()))
    run.end_window()
    served = [i for i in range(n) if len(recv[i]) * chunk
              >= reqs["samples"][i]]
    ttfa = [(first[i] - (t0 + offsets[i])) * 1e3 for i in range(n)
            if not np.isnan(first[i])]
    gaps = [(b - a) * 1e3 for i in range(n) for a, b in zip(recv[i],
                                                            recv[i][1:])]
    run.attempted, run.failed = n, n - len(served)
    run.e2e["ttfa_p95_ms"] = float(np.percentile(ttfa, 95))
    run.e2e["chunk_gap_p95_ms"] = float(np.percentile(gaps, 95))
    run.counters.update(
        chunks=chunks, lanes=pool.n, requests=n,
        computed_samples=chunks * pool.n * chunk, ttfa_ms=ttfa,
        gaps_ms=gaps)
    state.update(served=served, pieces=pieces)


def replay(run, params, items):
    """token_gaps over served requests: ``items`` holds, per request, its
    served levels (the first ``len(rows) * cond_rate`` are checked), its
    rows and its noise key."""
    rate = run.cfg.cond_rate
    lengths = [len(rows) * rate for _, rows, _ in items]
    served = torch.zeros((len(items), max(lengths)), dtype=torch.int64)
    cond = torch.zeros((len(items), max(len(r) for _, r, _ in items),
                        run.cfg.cond_dim))
    for j, (levels, rows, _) in enumerate(items):
        served[j, :lengths[j]] = torch.as_tensor(
            np.asarray(levels[:lengths[j]], np.int64))
        c = torch.as_tensor(rows)
        cond[j, :len(c)] = c
        cond[j, len(c):] = c[-1]          # past its end a lane keeps its
                                          # last row
    keys = torch.as_tensor(np.stack([k for _, _, k in items]).astype(
        np.int64))
    return rcheck.token_gaps(
        params, run.model, served.to(run.device), lengths, ("keys", keys),
        run.traffic["temperature"], cond.to(run.device),
        control=run.control)


def pick(run, ids: list, length) -> list:
    """``check_requests`` of ``ids`` drawn from the seed, the longest
    (by ``length(id)``) among them."""
    rng = generator.rng_for(run.seed, 5)
    longest = max(ids, key=length)
    rest = [i for i in ids if i != longest]
    k = min(len(rest), run.traffic["check_requests"] - 1)
    return sorted([longest] + list(rng.choice(rest, k, replace=False)))


def check(run, state):
    state["pool"] = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    reqs = state["reqs"]
    ids = pick(run, state["served"], lambda i: reqs["samples"][i])
    out = replay(run, state["params"], [
        (np.concatenate(state["pieces"][i]), reqs["cond"][i],
         reqs["keys"][i]) for i in ids])
    run.readings = {"token_gap": out["gap"], "tokens": out["tokens"]}
    control = None
    if "control_gap" in out:
        control = {"token_gap": out["control_gap"]}
        run.readings["control_token_gap"] = out["control_gap"]
    return harness.compared(run, {"token_gap": out["gap"]}, control)
