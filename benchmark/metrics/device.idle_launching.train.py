"""The share of the traced window in which no operation ran on the card
while the host was inside a train step's ``train.forward``,
``train.backward`` or ``train.optim`` (launching its kernels);
``device.idle.train`` less it is the idle while the host did anything
else (data, staging, the sync, plugins)."""

from benchmark import program_spans

STEP = {"train.forward", "train.backward", "train.optim"}


def read(run):
    return program_spans.idle_inside_percent(run, STEP)
