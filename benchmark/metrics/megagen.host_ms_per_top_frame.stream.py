"""The host's time in ``megagen.run`` (the port's span around one call of
the whole-generation loop: its launches) over the top frames those calls
launched, in the traced tail."""

from benchmark import program_spans


def read(run):
    return program_spans.host_ms_per_top_frame(run)
