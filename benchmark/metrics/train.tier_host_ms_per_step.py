"""The host's time launching the frame tiers' forward pass (the
``samplernn.tier`` spans directly inside a ``train.forward`` span), per
``train.forward`` span, in the traced tail."""

from benchmark import program_spans


def read(run):
    steps = program_spans.named(run, "train.forward")
    tiers = program_spans.named(run, "samplernn.tier")
    if steps is None or tiers is None:
        return None
    inside = {s.index for s in steps}
    got = [program_spans.ms(s) for s in tiers if s.parent in inside]
    return sum(got) / len(steps) if got else None
