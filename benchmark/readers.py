"""What the per-layer metrics' readers (``metrics/<name>.py``) share: the
kernels of the traced window, the device's idle share, the whole step's
share of the peak.  Each returns None when the run has nothing to read,
and the harness then leaves the metric out; a share of a roofline or of a
peak is never made up as 0."""

from __future__ import annotations

import statistics

from benchmark import flops
from benchmark.harness import kernel_totals


def kernels(run, *parts: str):
    """(seconds, launches) of the traced kernels whose short name holds any
    of ``parts``, or None without a trace or without such a kernel."""
    if run.trace is None:
        return None
    secs, count = 0.0, 0
    for name, (s, c) in kernel_totals(run.trace).items():
        if any(p in name for p in parts):
            secs += s
            count += c
    return (secs, count) if count else None


def idle_percent(run):
    """The share of the traced window in which no operation ran on the
    device."""
    tr = run.trace
    if tr is None or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def k1_roofline(run):
    """K1's bound per launch at the cell's lanes over its traced time."""
    got = kernels(run, "frame_decode")
    if got is None:
        return None
    secs, count = got
    per, _ = flops.k1_bound(run.model, run.counters["lanes"])
    return 100.0 * per * count / secs


def mfu(run, samples_key: str, train: bool = False):
    """Model FLOPs at ``counters[samples_key]`` over the window, as a share
    of the bf16 peak."""
    n = run.counters.get(samples_key)
    if not n or not run.window_s:
        return None
    return flops.mfu_percent(run.model, n / run.window_s, train)


def median_ms(run, span: str):
    times = run.span_times(span)
    return 1e3 * statistics.median(times) if times else None
