"""Tracing and throughput, as ``samplernn_pase_tpu.utils.profiling``:
``trace`` wraps a region in a ``torch.profiler`` trace written to a
directory as a Chrome trace (chrome://tracing, Perfetto), and
``StepTimer`` gives the throughput the metrics writer logs."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


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


class StepTimer:
    """Wall-clock throughput over a window of steps.  ``tick(out)`` with a
    step's output tensor first waits for its device (a CUDA event recorded
    after the step), so the time includes the device's work."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t = []

    def tick(self, out=None):
        if isinstance(out, torch.Tensor) and out.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(out.device))
            ev.synchronize()
        self._t.append(time.perf_counter())
        if len(self._t) > self.window + 1:
            self._t.pop(0)

    def steps_per_sec(self) -> float:
        if len(self._t) < 2:
            return 0.0
        return (len(self._t) - 1) / (self._t[-1] - self._t[0])

    def throughput(self, units_per_step: float) -> float:
        return self.steps_per_sec() * units_per_step

    @staticmethod
    def realtime_factor(samples_per_sec: float,
                        sample_rate: int = 16_000) -> float:
        return samples_per_sec / sample_rate
