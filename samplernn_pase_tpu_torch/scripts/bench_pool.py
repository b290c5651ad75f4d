"""Multi-stream serving latency of the port, the GPU twin of the repo's
``scripts/bench_pool.py``: ``serve.StreamPool`` on the flagship
conditioned TTS model (2-tier GRU, frame_sizes (16, 4), dim 1024, embed
256, cond 256 at 160 samples a row, bf16) with random weights and rows
from seed 0.

    python -m samplernn_pase_tpu_torch.scripts.bench_pool [--smoke --device cpu]

Rows, one JSON line each, as the reference prints them:

* the solo B=1 stream (``generate.StreamingGenerator``), unconditioned
  and conditioned (``set_cond``): 30 chunks of 1,024 samples at T=0.95,
  keys ``metric``, ``median_ms_per_chunk``, ``worst_ms``, ``realtime_x``;
* conditioned pools of 8, 32 and 128 lanes at 1,280- and 1,024-sample
  chunks: 24 chunks at T=0.95 with a stop and a timed join halfway, keys
  ``metric``, ``median_ms_per_chunk``, ``worst_ms``, ``join_ms``,
  ``per_stream_realtime_x``, ``aggregate_realtime_x``.

Every loop runs enqueue-ahead, as ``serve.run_jobs`` drains: chunk i is
launched, copied to pinned host memory behind its launch
(``serve.host_copy``), then chunk i-1 is read (``serve.host_wait``); an
iteration's time is that launch plus that read, steady state from the
second.  ``join_ms`` is one ``start()`` of a conditioned lane, queued
behind nothing (the pool is drained first) and waited for.  Without a
CUDA device the script prints ``utils.device_guard.skip_marker()`` and
exits 0; ``--smoke`` shrinks the model, the pools and the chunk counts
and runs only on the device it is given (its lines carry ``"smoke":
true``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SOLO_CHUNK, SOLO_CHUNKS = 1024, 30
POOL_CHUNKS = 24
LANES = (8, 32, 128)
POOL_CHUNK_SIZES = (1280, 1024)
TEMPERATURE = 0.95
SAMPLE_RATE = 16_000


def _model(smoke: bool, conditioned: bool):
    import dataclasses

    from samplernn_pase_tpu_torch.bench import flagship, smoke_model
    cfg = smoke_model() if smoke else flagship()
    if conditioned:
        cfg = dataclasses.replace(cfg, cond_dim=8 if smoke else 256,
                                  cond_rate=8 if smoke else 160)
    return cfg


def _loop(emit, n_chunks: int) -> list[float]:
    """Enqueue-ahead: per iteration, launch a chunk and read the one
    before; the seconds of each iteration."""
    from samplernn_pase_tpu_torch.serve import host_copy, host_wait
    times, prev = [], None
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        cur = host_copy(emit())
        if prev is not None:
            host_wait(prev)
        prev = cur
        times.append(time.perf_counter() - t0)
    host_wait(prev)
    return times


def _stats(times, chunk: int) -> dict:
    import numpy as np
    ms = np.asarray(times[1:]) * 1e3       # steady state
    med = float(np.median(ms))
    return {"median_ms_per_chunk": round(med, 2),
            "worst_ms": round(float(ms.max()), 2),
            "chunk_ms": chunk / SAMPLE_RATE * 1e3}


def run_solo(dev, smoke: bool, conditioned: bool) -> dict:
    import numpy as np
    import torch

    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.models import samplernn
    cfg = _model(smoke, conditioned)
    chunk, n_chunks = (cfg.lookback * 2, 4) if smoke else (SOLO_CHUNK,
                                                           SOLO_CHUNKS)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    sg = gen.StreamingGenerator(params, cfg, 1, temperature=TEMPERATURE,
                                device=dev)
    if conditioned:
        rng = np.random.default_rng(0)
        sg.set_cond(rng.normal(size=((n_chunks + 2) * chunk // cfg.cond_rate,
                                     cfg.cond_dim)).astype(np.float32))
    _loop(lambda: sg.emit(chunk), 1)        # build, prepare, warm
    sg.reset()
    st = _stats(_loop(lambda: sg.emit(chunk), n_chunks), chunk)
    return {"metric": f"solo_{'conditioned' if conditioned else 'plain'}"
                      f"_b1_chunk{chunk}",
            "median_ms_per_chunk": st["median_ms_per_chunk"],
            "worst_ms": st["worst_ms"],
            "realtime_x": round(st["chunk_ms"] / st["median_ms_per_chunk"],
                                2)}


def run_pool(dev, params, cfg, n_lanes: int, chunk: int, n_chunks: int,
             rng) -> dict:
    import numpy as np

    from samplernn_pase_tpu_torch.bench import sync
    from samplernn_pase_tpu_torch.serve import (
        StreamPool, host_copy, host_wait)
    n_rows = -(-(n_chunks + 2) * chunk // cfg.cond_rate)
    conds = [rng.normal(size=(n_rows, cfg.cond_dim)).astype(np.float32)
             for _ in range(n_lanes + 1)]
    pool = StreamPool(params, cfg, n_lanes, temperature=TEMPERATURE,
                      device=dev)
    lanes = [pool.start(cond=c) for c in conds[:n_lanes]]
    host_wait(host_copy(pool.emit(chunk)))      # build, prepare, warm
    for lane in lanes:
        pool.stop(lane)
    lanes = [pool.start(cond=c) for c in conds[:n_lanes]]
    join_ms, launched = None, 0

    def emit():
        nonlocal join_ms, launched
        if launched == n_chunks // 2:          # lifecycle churn mid-run
            pool.stop(lanes[-1])
            sync(dev)
            t0 = time.perf_counter()
            lanes[-1] = pool.start(cond=conds[n_lanes])
            sync(dev)
            join_ms = (time.perf_counter() - t0) * 1e3
        launched += 1
        return pool.emit(chunk)

    st = _stats(_loop(emit, n_chunks), chunk)
    med = st["median_ms_per_chunk"]
    return {"metric": f"pool_serving_n{n_lanes}_chunk{chunk}",
            "median_ms_per_chunk": med, "worst_ms": st["worst_ms"],
            "join_ms": round(join_ms, 2),
            "per_stream_realtime_x": round(st["chunk_ms"] / med, 2),
            "aggregate_realtime_x": round(n_lanes * st["chunk_ms"] / med, 1)}


def run(device=None, smoke: bool = False) -> list[dict]:
    """The benchmark's rows on ``device`` (default CUDA, which must be
    present)."""
    import numpy as np
    import torch

    from samplernn_pase_tpu_torch.device import resolve_device
    from samplernn_pase_tpu_torch.models import samplernn
    dev = resolve_device(device)
    rows = [run_solo(dev, smoke, False), run_solo(dev, smoke, True)]
    cfg = _model(smoke, True)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    rng = np.random.default_rng(0)
    lanes, sizes, n_chunks = ((2, 3), (cfg.lookback * 2, cfg.lookback), 4) \
        if smoke else (LANES, POOL_CHUNK_SIZES, POOL_CHUNKS)
    for chunk in sizes:
        for n in lanes:
            rows.append(run_pool(dev, params, cfg, n, chunk, n_chunks, rng))
    if smoke:
        for r in rows:
            r["smoke"] = True
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny model, pools and runs (for the CPU tests)")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch

    from samplernn_pase_tpu_torch.utils.device_guard import skip_marker
    if args.device is None and not torch.cuda.is_available():
        print(skip_marker())
        return 0
    for row in run(args.device, args.smoke):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
