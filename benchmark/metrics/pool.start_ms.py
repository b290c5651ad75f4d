"""Median host time of a join from inside the port: its ``pool.start``
span (``StreamPool.start``), in the traced tail; the twin of
``pool.join_ms``, which the harness times around the call."""

from benchmark import program_spans


def read(run):
    return program_spans.median_ms(run, "pool.start")
