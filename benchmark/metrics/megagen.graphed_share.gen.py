"""The share of the top frames that ``megagen.run`` replayed as a CUDA
graph (its span's ``graphed`` attr) among those of its calls, in the
traced tail; None where no ``megagen.run`` span carries ``graphed`` (a
port without the graph route)."""

from benchmark import program_spans


def read(run):
    runs = [s for s in program_spans.named(run, "megagen.run") or ()
            if "graphed" in s.attrs]
    if not runs:
        return None
    return 100.0 * (sum(s.attrs["graphed"] for s in runs)
                    / sum(s.attrs["top_frames"] for s in runs))
