"""The serving pool's share of the bf16 peak: model FLOPs of every sample
the pool computed (all lanes of every chunk) over the window."""

from benchmark import readers


def read(run):
    return readers.mfu(run, "computed_samples")
