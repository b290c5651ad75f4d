"""K1 (``csrc/frame_decode.cu``) in the serving pool (per-lane keys, mode
3): its bound at the cell's lanes times its traced launches, over its
traced device time."""

from benchmark import readers


def read(run):
    return readers.k1_roofline(run)
