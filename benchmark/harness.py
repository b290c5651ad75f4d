"""The harness: finds a cell by name in ``BENCHMARK.json``, runs its driver,
reads its metrics and prints the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by name:

* ``configs/<config>.json``: the model as it is run (``model``), its
  source, what was reduced and what was assumed;
* ``traffic/<traffic>.json``: the traffic mix, a data file of parameters
  for the driver named by its ``driver`` key;
* ``drivers/<driver>.py``: ``setup(run)``, ``window(run, state)`` and
  ``check(run, state)``;
* ``metrics/<metric>.py``: ``read(run)``, a per-layer metric from the
  spans, counters and trace of the run, or None when it finds nothing;
* ``limits/<cell>.json``: the limit of each number the cell compares.

A run: set-up (weights from the seed on the device, warm-up of the cell's
own shapes), a window of ``--seconds`` with the end-to-end metrics taken
on the host clock, the peak memory read, the program's state freed, then
the reference's comparison.  With ``--trace 1`` the last
``trace_seconds`` of the window (a traffic key) run under torch.profiler,
and the per-layer metrics are printed instead of the end-to-end ones.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "samplernn_pase_tpu")


class HarnessError(Exception):
    """The cell cannot run: the run exits non-zero and prints no result."""


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (Linux:
    /proc/self/stat's start time against the uptime); the harness's own
    import time where that cannot be read."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_module(path: Path, name: str):
    """A module of the benchmark's folder loaded from its file (a metric's
    file name may hold dots)."""
    if not path.is_file():
        raise HarnessError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    if not path.is_file():
        raise HarnessError(f"no file {path}")
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell as ``BENCHMARK.json`` names it, with its files read."""

    def __init__(self, root: Path, name: str):
        self.root = root
        spec = read_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise HarnessError(f"unknown workload {name!r}; the cells are "
                               + ", ".join(sorted(cells)))
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = read_json(root / configs[self.entry["config"]]["file"])
        bench = root / spec["paths"][0]
        self.dir = bench
        self.traffic = read_json(bench / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = read_json(bench / "limits" / f"{name}.json")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]
        self.chips = int(self.entry["chips"])


class Run:
    """One run of a cell: its inputs, spans, counters, trace and result."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        import torch

        from samplernn_pase_tpu_torch.config import SampleRNNConfig

        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace_on = bool(trace)
        self.device = torch.device(device)
        self.t_start = t_start
        self.model = dict(cell.config["model"])
        self.cfg = SampleRNNConfig(**self.model)
        self.traffic = cell.traffic
        self.spans: list = []          # (name, t0, t1) on the host clock
        self.counters: dict = {}
        self.e2e: dict = {}
        self.attempted = 0
        self.failed = 0
        self.control = False           # the control in the program's place
        self.readings: dict = {}       # what the check read, for the tools
        self.setup_s = None
        self.window_t0 = None
        self.window_s = None
        self.trace = None
        self._prof = None
        self._prof_t0 = None
        self._open: list = []          # spans open now, outermost first
        self._open_at_trace: list = []
        self._last_tick = None

    # -- the window ------------------------------------------------------
    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_window(self):
        """Set-up ends here: the first timed unit starts now."""
        self.sync()
        self.window_t0 = time.perf_counter()
        self.setup_s = self.window_t0 - self.t_start

    def elapsed(self) -> float:
        return time.perf_counter() - self.window_t0

    def tick(self):
        """At a unit boundary: start the profiler once the traced tail of the
        window begins (``--trace 1`` only).  The tail is reckoned with the
        last unit's length, so that the window's last units are traced
        even where a unit lasts longer than ``trace_seconds``."""
        now = time.perf_counter()
        unit = now - (self._last_tick or now)
        self._last_tick = now
        if (self.trace_on and self._prof is None and self.trace is None
                and self.elapsed() + unit >= self.seconds - float(
                    self.traffic.get("trace_seconds", 2.0))):
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.sync()
            self._prof = profile(activities=acts)
            self._prof.start()
            self._prof_t0 = time.perf_counter()
            self._open_at_trace = list(self._open)

    def end_window(self):
        """The window closes now: its wall time, and the trace if one ran."""
        self.sync()
        self.window_s = time.perf_counter() - self.window_t0
        if self._prof is not None:
            traced_s = time.perf_counter() - self._prof_t0
            self._prof.stop()
            self.trace = digest_trace(self._prof, traced_s,
                                      {n for n, _, _ in self.spans})
            # host time outside every traced span is in the spans that were
            # already open when the profiler started
            self.trace["outside"] = (self._open_at_trace[-1]
                                     if self._open_at_trace else "outside")
            self._prof = None

    @contextmanager
    def span(self, name: str):
        """A span of the harness's own call into the program; under the
        profiler also an annotation in the trace."""
        ctx = nullcontext()
        if self._prof is not None:
            from torch.profiler import record_function
            ctx = record_function(name)
        t0 = time.perf_counter()
        self._open.append(name)
        try:
            with ctx:
                yield
        finally:
            self._open.pop()
        self.spans.append((name, t0, time.perf_counter()))

    def span_times(self, name: str) -> list[float]:
        return [t1 - t0 for n, t0, t1 in self.spans if n == name]


def _event_fields(e):
    dev = str(e.device_type())
    act = e.activity_type() if hasattr(e, "activity_type") else ""
    ann = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
           else False)
    return e.name(), dev, str(act), bool(ann), e.start_ns(), e.duration_ns()


def digest_trace(prof, traced_s: float, span_names: set) -> dict:
    """Device operations and host annotations of a profile: the kernels,
    copies and sets that ran on the device ([name, start_ns, dur_ns]), the
    harness's spans, the busy seconds (the union of the device
    operations' intervals) and the traced window's length."""
    kernels, notes = [], []
    t_lo, t_hi = None, None
    for e in prof.profiler.kineto_results.events():
        name, dev, act, ann, start, dur = _event_fields(e)
        t_lo = start if t_lo is None else min(t_lo, start)
        t_hi = start + dur if t_hi is None else max(t_hi, start + dur)
        if "CUDA" in dev:
            if ann or "annotation" in act or name in span_names:
                continue
            kernels.append((name, start, dur))
        elif name in span_names:
            notes.append((name, start, start + dur))
    kernels.sort(key=lambda k: k[1])
    merged = []
    for _, s, d in kernels:
        if not merged or s > merged[-1][1]:
            merged.append([s, s + d])
        else:
            merged[-1][1] = max(merged[-1][1], s + d)
    busy = sum(b - a for a, b in merged)
    return {"kernels": kernels, "busy_intervals": merged, "notes": notes,
            "busy_s": busy / 1e9, "window_s": traced_s,
            "bounds_ns": (t_lo, t_hi)}


def kernel_totals(trace: dict) -> dict:
    """{short kernel name: [seconds, count]} over the trace."""
    out: dict = {}
    for name, _, dur in trace["kernels"]:
        key = short_name(name)
        acc = out.setdefault(key, [0.0, 0])
        acc[0] += dur / 1e9
        acc[1] += 1
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces or arguments."""
    base = name.replace("(anonymous namespace)::", "")
    base = base.split("(")[0].split("<")[0].strip()
    if base.startswith("void "):
        base = base[5:]
    return base.split("::")[-1][:80] or name[:80]


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time, and the device's idle
    time inside the trace by the harness span the host was in."""
    ops = sorted(kernel_totals(trace).items(), key=lambda kv: -kv[1][0])
    busy = trace["busy_intervals"]
    lo, hi = trace["bounds_ns"]
    gaps = []
    prev = lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi is not None and prev is not None and hi > prev:
        gaps.append((prev, hi))
    idle: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        inside = [n for n in trace["notes"] if n[1] <= mid <= n[2]]
        what = (max(inside, key=lambda n: n[1])[0] if inside
                else trace.get("outside", "outside"))
        idle[what] = idle.get(what, 0.0) + (b - a) / 1e9
    return {"device_ops": [[k, v[0]] for k, v in ops[:10]],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}


def warm_profiler(run: Run) -> None:
    """Start and stop the profiler once before the window, so that its own
    start-up (CUPTI's, on the card) does not fall inside the traced part."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.ones(1, device=run.device).add_(1)
        run.sync()


def device_info(run: Run, peak: int) -> dict:
    import torch
    if run.device.type == "cuda":
        kind = torch.cuda.get_device_name(run.device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    info = {"platform": platform, "kind": kind, "count": run.cell.chips,
            "memory_peak_bytes": int(peak)}
    if run.trace_on:
        tr = run.trace or {"busy_s": 0.0, "window_s": 0.0}
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
    return info


def read_metrics(run: Run) -> dict:
    """The cell's metrics: end-to-end ones with ``--trace 0``, per-layer
    ones (each from its reader; those that find nothing left out) with
    ``--trace 1``."""
    out = {}
    if not run.trace_on:
        for m in run.cell.end_to_end:
            name = m["name"]
            value = run.setup_s if name == "setup_s" else run.e2e.get(name)
            if value is None or not math.isfinite(value):
                raise HarnessError(f"the driver measured no {name}")
            out[name] = {"value": value, "unit": m["unit"]}
        return out
    for m in run.cell.per_layer:
        reader = load_module(run.cell.dir / "metrics" / f"{m['name']}.py",
                             f"benchmark_metric_{len(out)}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device="cuda", t_start: float | None = None,
            patch=None) -> dict:
    """Run one cell and return its result object (with ``checks``, the
    numbers compared beside their limits).  ``patch(run)``, for the tests,
    runs after the cell is read and before set-up."""
    import torch

    t_start = process_start() if t_start is None else t_start
    cell = Cell(Path(root), workload)
    run = Run(cell, seed, seconds, trace, device, t_start)
    if patch is not None:
        patch(run)
    driver = load_module(cell.dir / "drivers" / f"{cell.traffic['driver']}.py",
                         "benchmark_driver")
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    state = driver.setup(run)
    if run.trace_on:
        warm_profiler(run)
    driver.window(run, state)
    if run.window_s is None:
        raise HarnessError("the driver closed no window")
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    metrics = read_metrics(run)
    checks = driver.check(run, state)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": device_info(run, peak)}
    if run.trace_on and run.trace is not None:
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    return result


def limit(run: Run, name: str, value: float) -> dict:
    """A compared number beside its limit from ``limits/<cell>.json``."""
    return {"value": float(value), "limit": float(run.cell.limits[name])}


def compared(run: Run, program: dict, control: dict | None = None) -> dict:
    """Each number of ``limits/<cell>.json`` beside its limit: the
    program's, or with ``run.control`` set (``benchmark.control``, the
    tests) the control's, computed in the program's place, so that the
    control is judged by the same comparison and the same ``correct``."""
    values = control if run.control else program
    return {k: limit(run, k, values[k]) for k in run.cell.limits}


def report(result: dict) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
