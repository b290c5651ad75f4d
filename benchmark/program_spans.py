"""What the per-layer metrics read from the port's own spans
(``samplernn_pase_tpu_torch/utils/profiling.py``): the spans of the traced
tail, and the card's idle time put on the program span the host was in.

A span records while a profiler runs, so a run with ``--trace 1`` holds
the spans of its traced tail: ``[window_t0 + window_s - trace["window_s"],
window_t0 + window_s]`` on ``perf_counter``.  A span lies on the device
trace at ``[e0, e0 + t1 - t0]`` (``e0`` is read on the profiler's clock).
The idle gaps are those of ``harness.breakdown``: the traced bounds less
the union of the device operations.  Each function returns None where it
finds nothing to read: no trace, no device operation (the CPU), a port
that records no spans (an older tree) or no span of the names asked
for."""

from __future__ import annotations

import heapq
import statistics


def recorded():
    """The port's recorded spans, or None where it records none."""
    try:
        from samplernn_pase_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def tail(run):
    """The spans that opened and closed inside the traced tail, or None."""
    got = recorded()
    if not got or run.trace is None or run.window_s is None:
        return None
    hi = run.window_t0 + run.window_s
    lo, hi = 1e9 * (hi - run.trace["window_s"]), 1e9 * hi
    inside = [s for s in got if s.t1 is not None and lo <= s.t0
              and s.t1 <= hi]
    return inside or None


def end_ns(s) -> int:
    """A span's end on the profiler's clock."""
    return s.e0 + s.t1 - s.t0


def idle_gaps(trace) -> list:
    """[(start_ns, end_ns)] of the traced bounds with no device operation,
    built as ``harness.breakdown`` builds them."""
    lo, hi = trace["bounds_ns"]
    gaps, prev = [], lo
    for a, b in trace["busy_intervals"]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi is not None and prev is not None and hi > prev:
        gaps.append((prev, hi))
    return gaps


def _device_ran(run) -> bool:
    return run.trace is not None and run.trace["busy_s"] > 0


def idle_by_span(run):
    """{program span name: idle seconds}: each idle gap on the innermost
    span of the traced tail open at its midpoint (the one opened last),
    "outside" where none is; None without device operations or spans."""
    spans = tail(run)
    if spans is None or not _device_ran(run):
        return None
    order = sorted(spans, key=lambda s: (s.e0, s.index))
    heap: list = []                  # (-e0, -index, end, name): open spans
    i, out = 0, {}
    for a, b in idle_gaps(run.trace):          # in order of start
        mid = (a + b) / 2
        while i < len(order) and order[i].e0 <= mid:
            s = order[i]
            heapq.heappush(heap, (-s.e0, -s.index, end_ns(s), s.name))
            i += 1
        while heap and heap[0][2] < mid:
            heapq.heappop(heap)
        name = heap[0][3] if heap else "outside"
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def idle_inside_percent(run, names):
    """The share of the traced window in which the card was idle while the
    host was inside a span named in ``names``: the idle gaps intersected
    with the union of those spans."""
    spans = tail(run)
    if spans is None or not _device_ran(run):
        return None
    ivs = sorted((s.e0, end_ns(s)) for s in spans if s.name in names)
    if not ivs:
        return None
    merged = [list(ivs[0])]
    for a, b in ivs[1:]:
        if a > merged[-1][1]:
            merged.append([a, b])
        else:
            merged[-1][1] = max(merged[-1][1], b)
    idle, j = 0, 0
    for a, b in idle_gaps(run.trace):
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < b:
            idle += min(b, merged[k][1]) - max(a, merged[k][0])
            k += 1
    return 100.0 * idle / 1e9 / run.trace["window_s"]


def named(run, name: str):
    """The traced tail's spans named ``name``, or None."""
    spans = tail(run)
    got = [s for s in spans or () if s.name == name]
    return got or None


def ms(s) -> float:
    return (s.t1 - s.t0) / 1e6


def host_ms_per_top_frame(run):
    """``megagen.run``'s host time over the top frames it launched."""
    runs = named(run, "megagen.run")
    if runs is None:
        return None
    return sum(ms(s) for s in runs) / sum(s.attrs["top_frames"]
                                          for s in runs)


def median_ms(run, name: str):
    got = named(run, name)
    return None if got is None else statistics.median(ms(s) for s in got)


def mean_ms(run, name: str):
    got = named(run, name)
    return None if got is None else statistics.fmean(ms(s) for s in got)


def outermost_ms(run, names, per: str):
    """The summed time of the spans named in ``names`` that lie inside no
    other of them, per span named ``per``."""
    spans = tail(run)
    count = len(named(run, per) or ())
    if not count:
        return None
    by_index = {s.index: s for s in spans}

    def nested(s):
        p = by_index.get(s.parent)
        while p is not None:
            if p.name in names:
                return True
            p = by_index.get(p.parent)
        return False

    return sum(ms(s) for s in spans
               if s.name in names and not nested(s)) / count


def mean_less_ms(run, name: str, less: str):
    """The mean time of the spans named ``name``, less the time of their
    descendants named ``less``."""
    spans = tail(run)
    outer = named(run, name)
    if outer is None:
        return None
    by_index = {s.index: s for s in spans}
    total = {s.index: ms(s) for s in outer}
    for s in spans:
        if s.name != less:
            continue
        p = by_index.get(s.parent)
        while p is not None and p.index not in total:
            p = by_index.get(p.parent)
        if p is not None:
            total[p.index] -= ms(s)
    return statistics.fmean(total.values())

