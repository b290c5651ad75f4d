"""The arrival-rate sweep behind a streaming cell's fixed rate: runs the cell
at each rate given, in one process, and prints per rate the time to first
audio (median, 95th percentile, and the mean over the first and the last
third of the arrivals: a backlog that grows shows as a last third far above
the first), the chunk gaps' 95th percentile and the requests not served.

    python -m benchmark.sweep --workload tts-stream-b128 --seconds 20 \\
        --seed 5 --rates 30 40 50

Needs the card.  The cell's own traffic file is left as it is: the rate is
replaced in memory for each run.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from benchmark.run import ROOT, _cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    _cache_dirs()
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("benchmark.sweep: no CUDA card", file=sys.stderr)
        return 1
    for rate in args.rates:
        runs = []

        def patch(run):
            run.traffic = dict(run.traffic, rate_per_s=rate)
            runs.append(run)

        result = harness.execute(ROOT, args.workload, args.seed,
                                 args.seconds, False, "cuda", patch=patch)
        c = runs[0].counters
        ttfa = np.asarray(c["ttfa_ms"])
        third = max(1, len(ttfa) // 3)
        print(json.dumps({
            "rate_per_s": rate, "requests": c["requests"],
            "failed": result["failed"], "correct": result["correct"],
            "ttfa_p50_ms": float(np.percentile(ttfa, 50)),
            "ttfa_p95_ms": float(np.percentile(ttfa, 95)),
            "ttfa_first_third_ms": float(ttfa[:third].mean()),
            "ttfa_last_third_ms": float(ttfa[-third:].mean()),
            "chunk_gap_p95_ms": float(np.percentile(c["gaps_ms"], 95)),
            "window_s": runs[0].window_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
