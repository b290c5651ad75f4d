"""K1 (``csrc/frame_decode.cu``) in generation: its bound at the cell's
lanes times its traced launches, over its traced device time."""

from benchmark import readers


def read(run):
    return readers.k1_roofline(run)
