"""Host time of the emit path per chunk from inside the port: the
``pool.emit``, ``serve.host_copy`` and ``serve.host_wait`` spans of the
traced tail, summed, per ``pool.emit``; the twin of ``pool.emit_ms``,
which the harness times around the calls."""

from benchmark import program_spans

PATH = {"pool.emit", "serve.host_copy", "serve.host_wait"}


def read(run):
    return program_spans.outermost_ms(run, PATH, "pool.emit")
