"""Training's share of the bf16 peak: three times the model's forward
FLOPs of every sample trained on in the window, over its wall time."""

from benchmark import readers


def read(run):
    return readers.mfu(run, "train_samples", train=True)
