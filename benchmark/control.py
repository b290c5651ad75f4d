"""Readings behind the limits of ``correct``: runs a cell on several seeds in
one process and prints, per seed, the numbers its check compares.

With ``--stand-in control`` (the default) the control, the reference in a
lower precision, is put in the program's place: the check hands its
numbers to the harness's comparison, and the run's ``correct`` is the
control's, which has to come out false; the program's own numbers, read in
the same run, and the other readings (float8 and half the batch for the
training cell) are printed beside it.  With ``--stand-in program`` the
program's numbers alone are read and judged.

    python -m benchmark.control --workload NAME --seconds S --seeds A B C \\
        [--stand-in control|program]

Needs the card, as ``benchmark.run`` does.  Exits non-zero when a control
comes out correct or the program does not.  The benchmark's own runs do
not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import ROOT, _cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--stand-in", choices=("control", "program"),
                    default="control")
    args = ap.parse_args(argv)
    _cache_dirs()
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 1
    control = args.stand_in == "control"
    wrong = 0
    for seed in args.seeds:
        runs = []

        def patch(run):
            run.control = control
            runs.append(run)

        result = harness.execute(ROOT, args.workload, seed, args.seconds,
                                 bool(args.trace), "cuda", patch=patch)
        wrong += result["correct"] == control
        print(json.dumps({"seed": seed, "stand_in": args.stand_in,
                          "correct": result["correct"],
                          "readings": runs[0].readings,
                          "metrics": result["metrics"],
                          "checks": result["checks"]}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
