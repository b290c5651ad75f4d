"""Host time per chunk in the pool's emit path: the spans around
``StreamPool.emit`` with ``host_copy`` and around ``host_wait``, summed
over the window, per chunk."""


def read(run):
    n = run.counters.get("chunks")
    if not n:
        return None
    return 1e3 * (sum(run.span_times("emit"))
                  + sum(run.span_times("drain"))) / n
