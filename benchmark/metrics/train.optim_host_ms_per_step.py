"""The host's time in a train step's optimizer (the ``train.optim`` span:
Adam's update, the clip and the parameters' update), per step, in the
traced tail."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_ms(run, "train.optim")
