"""``run_jobs``' host work per chunk: the mean ``jobs.chunk`` span (one
pass of its loop: claims, the emit, stops, the copy, drains) of the
traced tail, less the time its ``serve.host_wait`` spans waited for the
card."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_less_ms(run, "jobs.chunk", "serve.host_wait")
