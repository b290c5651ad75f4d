"""Run one cell of the benchmark of ``samplernn_pase_tpu_torch`` on the card.

    python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object with ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and with ``--trace 1`` ``breakdown``), and ``checks`` last: each
number compared beside its limit, which are also the last lines of
standard error.  Exits non-zero with no result when there is no CUDA card
(or fewer than the cell asks for), when the workload is unknown or its
files are missing, or when a module of JAX, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs():
    """Build and kernel caches inside the checkout, at fixed paths."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def steady_host() -> None:
    """One intra-op thread, and the calling thread (and every thread it
    starts from now on) pinned to one core, the last it may use, so that
    the window's host-paced loops are not moved from core to core."""
    import torch
    torch.set_num_threads(1)
    try:
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    except (AttributeError, OSError):
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    from benchmark import harness
    t_start = harness.process_start()
    try:
        cell = harness.Cell(ROOT, args.workload)
    except (harness.HarnessError, KeyError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    steady_host()
    try:
        result = harness.execute(ROOT, args.workload, args.seed,
                                 args.seconds, bool(args.trace), "cuda",
                                 t_start)
    except harness.HarnessError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print("benchmark: loaded in the measuring process: "
              + ", ".join(found), file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
