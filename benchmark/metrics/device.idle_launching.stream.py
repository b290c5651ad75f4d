"""The share of the traced window in which no operation ran on the card
while the host was inside ``megagen.run`` (launching the generation
loop's kernels); ``device.idle`` less it is the idle while the host did
anything else."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_inside_percent(run, {"megagen.run"})
