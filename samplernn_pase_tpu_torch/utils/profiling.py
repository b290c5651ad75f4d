"""Spans inside the program, and whole traces written to a directory.

``span(name, **attrs)`` marks a region of the program's host work.  It
records only while a ``torch.profiler`` session runs on the calling thread
(``torch.autograd._profiler_enabled()``): the region's name, its start
and end on ``time.perf_counter_ns()`` (``t0``, ``t1``), its start on
``time.time_ns()`` (``e0``: the profiler's clock, so the region lies at
``[e0, e0 + t1 - t0]`` on the device trace), the index of the recorded
span it opened inside (``parent``, -1 at the top) and its attrs, into a
buffer of the newest ``LIMIT`` spans.  It also enters
``torch.profiler.record_function(name)``, so a Chrome trace shows the
region beside the kernels.  With no profiler running ``span`` returns one
shared no-op object: one C call, no clock read, nothing recorded.
``spanned(name)`` puts a span around every call of a function,
``note(**attrs)`` adds attrs to the innermost recorded span, ``spans()``
returns the buffer and ``clear()`` empties it.

``timed(name, into, key)`` is a span that always reads the clock and adds
its seconds to ``into[key]`` (the Trainer's ``host_s``), recording as a
span does while a profiler runs: one pair of clock reads feeds both.

``Trace``/``trace`` write a ``torch.profiler`` trace of a region to a
directory as a Chrome trace (chrome://tracing, Perfetto)."""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from pathlib import Path

import torch

LIMIT = 1 << 20                     # spans kept; the oldest are dropped

_enabled = torch.autograd._profiler_enabled
_buf: collections.deque = collections.deque(maxlen=LIMIT)
_count = itertools.count()          # the next recorded span's index
_local = threading.local()          # .stack: this thread's open spans


class Span:
    """One recorded span (times in ns; see the module docstring)."""

    __slots__ = ("index", "name", "t0", "t1", "e0", "parent", "attrs")

    def __init__(self, index, name, parent, attrs):
        self.index, self.name, self.parent = index, name, parent
        self.attrs = attrs
        self.t0 = self.t1 = self.e0 = None


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """An open span: records while a profiler runs, and with ``into``
    adds its seconds to ``into[key]`` whether one runs or not."""

    __slots__ = ("name", "attrs", "into", "key", "rec", "rf", "t0", "t1")

    def __init__(self, name, attrs, into=None, key=None):
        self.name, self.attrs, self.into, self.key = name, attrs, into, key
        self.rec = None

    def __enter__(self):
        if _enabled():
            stack = _stack()
            rec = Span(next(_count), self.name,
                       stack[-1].index if stack else -1, self.attrs)
            _buf.append(rec)
            stack.append(rec)
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
            rec.e0 = time.time_ns()
            self.rec = rec
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.into is not None:
            self.into[self.key] += (self.t1 - self.t0) / 1e9
        rec = self.rec
        if rec is not None:
            rec.t0, rec.t1 = self.t0, self.t1
            self.rf.__exit__(*exc)
            _stack().pop()
        return False


class _Off:
    """The span of a call with no profiler running.  Entering and leaving
    it call C functions only (``"".format`` returns "", so an exception
    goes on), which halves its cost against Python methods."""

    __slots__ = ()
    __enter__ = __exit__ = staticmethod("".format)


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager around host work named ``name``; the shared no-op
    unless a profiler runs."""
    if not _enabled():
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def note(**attrs) -> None:
    """Add ``attrs`` to this thread's innermost recorded span (values known
    only inside it, such as the lane a join claimed)."""
    if _enabled():
        stack = _stack()
        if stack:
            stack[-1].attrs.update(attrs)


def timed(name: str, into: dict, key: str) -> _Span:
    """A span that always adds its seconds to ``into[key]``; its ``t0``
    and ``t1`` (``perf_counter_ns``) stay readable after it closes."""
    return _Span(name, {}, into, key)


def spans() -> list[Span]:
    """The recorded spans, oldest first (a span still open has ``t1``
    None)."""
    return list(_buf)


def dropped() -> int:
    """Spans recorded since the last ``clear()`` that the buffer no longer
    holds."""
    return _buf[-1].index + 1 - len(_buf) if _buf else 0


def clear() -> None:
    global _count
    _buf.clear()
    _count = itertools.count()


class Trace:
    """A ``torch.profiler`` trace started and stopped by hand (the Trainer
    opens it at one step and closes it at another).  ``stop`` writes
    ``trace.json`` under ``log_dir`` and returns the profiler, whose
    ``key_averages()`` hold the device times; ``wall_s`` is the traced
    span on the host clock."""

    def __init__(self, log_dir):
        self.dir = Path(log_dir)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.wall_s = 0.0
        self._t0 = None

    def start(self):
        self.prof.start()
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.dir / "trace.json"))
        return self.prof


@contextlib.contextmanager
def trace(log_dir):
    """Profile a region: ``with trace('/tmp/prof'): step(...)``."""
    t = Trace(log_dir).start()
    try:
        yield t
    finally:
        t.stop()
