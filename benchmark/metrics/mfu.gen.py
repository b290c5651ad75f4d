"""The whole generation's share of the bf16 peak: model FLOPs of the
samples delivered in the window over its wall time."""

from benchmark import readers


def read(run):
    return readers.mfu(run, "samples")
