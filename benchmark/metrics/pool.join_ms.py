"""Median host time of a join (``StreamPool.start``), from the harness's
span around it."""

from benchmark import readers


def read(run):
    return readers.median_ms(run, "join")
