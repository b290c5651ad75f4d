"""Decode-kernel launches (K1, K2, K3, K6 in ``decode.LAUNCHES``) per top
frame generated, over the window (none counted: the plain versions on
the CPU launch nothing)."""


def read(run):
    c = run.counters
    if not c.get("top_frames") or not c.get("launches"):
        return None
    return c["launches"] / c["top_frames"]
