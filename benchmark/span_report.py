"""Where a cell's idle card time goes by the port's own spans, and what a
span costs.

    python -m benchmark.span_report --workload NAME --seed N --seconds S
    python -m benchmark.span_report --cost

The first runs the cell as ``python -m benchmark.run ... --trace 1`` does
(pinned the same way) and prints one JSON line: the result (``correct``,
metrics, breakdown), the traced tail's idle seconds by the innermost
program span open at each gap (``program_spans.idle_by_span``), each
span name's count and host seconds, and the clock map's error: each
``megagen.run`` and ``pool.emit`` span's ``e0`` against the start of its
own ``record_function`` event in the same trace (median and maximum, us),
the harness's spans over the same tail (the twins of the pool's span
metrics, read where the port's spans are) and the largest idle gaps with
the spans around them.
``--cost`` prints the host's cost of a span in us: with no profiler
running over 10^5 spans (the loop's own cost taken out; bare, with two
attrs, a ``spanned`` function's call against the plain function's, a
``note``), and under ``torch.profiler`` (with CUDA activity on a card)
over 10^4.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAPPED = ("megagen.run", "pool.emit")


def _per_span_us(body, n: int) -> float:
    t0 = time.perf_counter_ns()
    body(n)
    return (time.perf_counter_ns() - t0) / n / 1e3


def cost() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from samplernn_pase_tpu_torch.utils import profiling

    def empty(n):
        for _ in range(n):
            pass

    def bare(n):
        for _ in range(n):
            with profiling.span("cost.span"):
                pass

    def attrs(n):
        for _ in range(n):
            with profiling.span("cost.span", lanes=128, chunk=n):
                pass

    def best(body):
        body(1000)
        return min(_per_span_us(body, 100_000) for _ in range(5))

    def plain(n):
        for _ in range(n):
            f(n)

    def wrapped(n):
        for _ in range(n):
            g(n)

    def notes(n):
        for _ in range(n):
            profiling.note(lanes=128)

    def f(n):
        return n

    g = profiling.spanned("cost.fn")(f)
    loop = best(empty)
    out = {"off_us": best(bare) - loop, "off_attrs_us": best(attrs) - loop,
           "spanned_off_us": best(wrapped) - best(plain),
           "note_off_us": best(notes) - loop, "loop_us": loop}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        out["on_us"] = _per_span_us(bare, 10_000)
        out["on_attrs_us"] = _per_span_us(attrs, 10_000)
    profiling.clear()
    out.update(python=sys.version.split()[0], torch=torch.__version__)
    return out


def clock_map_us(spans, events) -> dict:
    """For each name of ``MAPPED``: |e0 - start of the nearest event of
    the same name| over its spans, median and maximum in us."""
    out = {}
    for name in MAPPED:
        starts = sorted(t for n, t in events if n == name)
        errs = []
        for s in spans:
            if s.name != name or not starts:
                continue
            i = bisect.bisect_left(starts, s.e0)
            near = [starts[j] for j in (i - 1, i) if 0 <= j < len(starts)]
            errs.append(min(abs(s.e0 - t) for t in near) / 1e3)
        if errs:
            out[name] = {"median_us": statistics.median(errs),
                         "max_us": max(errs), "n": len(errs)}
    return out


def harness_in_tail(run) -> dict:
    """The harness's ``join`` median and (``emit`` + ``drain``) per ``emit``
    over the traced tail, in ms."""
    hi = run.window_t0 + run.window_s
    lo = hi - run.trace["window_s"]
    spans = [(n, t1 - t0) for n, t0, t1 in run.spans if lo <= t0 and t1 <= hi]
    joins = [d for n, d in spans if n == "join"]
    emits = [d for n, d in spans if n == "emit"]
    out = {}
    if joins:
        out["join_ms"] = 1e3 * statistics.median(joins)
    if emits:
        out["emit_ms"] = 1e3 * (sum(emits) + sum(
            d for n, d in spans if n == "drain")) / len(emits)
    return out


def largest_gaps(run, spans, n: int = 8) -> list:
    """The ``n`` longest idle gaps: [ms, offset in the trace s, the spans
    open at its midpoint (outermost first), the last span to end before
    it and the first to start after it]."""
    from benchmark import program_spans

    gaps = sorted(program_spans.idle_gaps(run.trace),
                  key=lambda g: g[0] - g[1])
    lo = run.trace["bounds_ns"][0]
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) / 2
        inside = sorted((s for s in spans
                         if s.e0 <= mid <= program_spans.end_ns(s)),
                        key=lambda s: s.e0)
        before = [s for s in spans if program_spans.end_ns(s) <= a]
        after = [s for s in spans if s.e0 >= b]
        out.append([(b - a) / 1e6, (a - lo) / 1e9,
                    [s.name for s in inside],
                    max(before, key=program_spans.end_ns).name
                    if before else None,
                    min(after, key=lambda s: s.e0).name if after else None])
    return out


def report(workload: str, seed: int, seconds: float) -> dict:
    from benchmark import harness, program_spans
    from benchmark.run import _cache_dirs, steady_host

    _cache_dirs()
    t_start = harness.process_start()
    steady_host()
    runs, events = [], []

    def patch(run):
        end = run.end_window

        def end_window():
            prof = run._prof
            end()
            if prof is not None:
                events.extend(
                    (e.name(), e.start_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() in MAPPED and "CUDA" not in str(
                        e.device_type()))

        run.end_window = end_window
        runs.append(run)

    result = harness.execute(ROOT, workload, seed, seconds, True, "cuda",
                             t_start, patch=patch)
    run = runs[0]
    spans = program_spans.tail(run) or []
    by_name: dict = {}
    for s in spans:
        n, secs = by_name.get(s.name, (0, 0.0))
        by_name[s.name] = (n + 1, secs + (s.t1 - s.t0) / 1e9)
    return {"workload": workload, "seed": seed, "correct": result["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "device": result["device"], "breakdown": result.get("breakdown"),
            "idle_by_span": program_spans.idle_by_span(run),
            "spans": by_name, "clock_map": clock_map_us(spans, events),
            "harness_in_tail": harness_in_tail(run),
            "largest_gaps": largest_gaps(run, spans)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    if args.cost:
        out = cost()
    elif args.workload:
        out = report(args.workload, args.seed, args.seconds)
    else:
        ap.error("give --workload or --cost")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
