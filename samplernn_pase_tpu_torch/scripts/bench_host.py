"""Host-side data-pipeline benchmark, the GPU twin of the repo's
``scripts/bench_host.py``: the ``StreamBatcher``'s batch assembly at the
flagship's training shape ([128, 1088] int32 a step) with the native
window gather and with the numpy route, against the rate at which the
card consumes batches.

    python -m samplernn_pase_tpu_torch.scripts.bench_host [--smoke --device cpu]

``device_consumption`` (steps/s) is measured in the same run: the
flagship train step of ``scripts.bench_train`` (B=128, seq_len 1024) on
the card, not a constant.  Prints one JSON line with the reference's keys
(``metric``, ``native_gather``, ``python_stack``, ``device_consumption``,
``headroom_native_x``) plus ``train_step_ms`` and ``route``, and exits 1
when the native rate is not 4x the card's (host batching would bound
training), as the reference asserts; without a CUDA device it prints
``utils.device_guard.skip_marker()`` with exit code 0.  ``--smoke`` times
the device side on a tiny model on the device it is given (the CPU for
the tests), skips the 4x check, and marks its line ``"smoke": true``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BATCH, SEQ_LEN, OVERLAP, N_STEPS = 128, 1024, 64, 40


def batches_per_sec(force_numpy: bool, batch: int = BATCH,
                    seq_len: int = SEQ_LEN, overlap: int = OVERLAP,
                    n_steps: int = N_STEPS) -> float:
    """Batches a second the batcher yields over one long utterance per
    lane (every lane gives ``n_steps`` chunks), after one warm batch."""
    import numpy as np

    from samplernn_pase_tpu_torch.data import native_loader
    from samplernn_pase_tpu_torch.ops.framing import StreamBatcher

    if force_numpy:
        real = native_loader.available
        native_loader.available = lambda build=True: False
    try:
        rng = np.random.default_rng(0)
        utts = [rng.integers(0, 256, seq_len * n_steps, dtype=np.int32)
                for _ in range(batch)]
        it = iter(StreamBatcher(utts, batch, seq_len, overlap, q_zero=128))
        next(it)                      # warm (address precompute)
        t0 = time.perf_counter()
        n = 1
        for _ in it:
            n += 1
        return (n - 1) / (time.perf_counter() - t0)
    finally:
        if force_numpy:
            native_loader.available = real


def run(device=None, smoke: bool = False) -> dict:
    from samplernn_pase_tpu_torch.data import native_loader
    from samplernn_pase_tpu_torch.scripts import bench_train

    route = native_loader.route()         # builds the library if it can
    native = batches_per_sec(False)
    numpy_rate = batches_per_sec(True)
    step_ms = bench_train.run(device, smoke)["step_ms"]
    device_rate = 1000.0 / step_ms
    out = {
        "metric": "host_batches_per_sec_b128_seq1024",
        "native_gather": round(native, 1),
        "python_stack": round(numpy_rate, 1),
        "device_consumption": round(device_rate, 1),
        "headroom_native_x": round(native / device_rate, 1),
        "train_step_ms": step_ms,
        "route": route,
    }
    if smoke:
        out["smoke"] = True
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny model for the device side (CPU tests)")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch

    from samplernn_pase_tpu_torch.utils.device_guard import skip_marker
    if args.device is None and not torch.cuda.is_available():
        print(skip_marker())
        return 0
    rec = run(args.device, args.smoke)
    print(json.dumps(rec))
    if not args.smoke and rec["headroom_native_x"] <= 4:
        print("host batching would bottleneck the card", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
