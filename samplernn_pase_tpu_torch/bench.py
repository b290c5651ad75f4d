"""Headline benchmark of the port, the GPU twin of the repo's ``bench.py``:
generated audio samples/s per card at 16 kHz, batch 128, on the flagship
2-tier SampleRNN (GRU, frame_sizes (16, 4), dim 1024, embed 256, bf16),
with random weights from seed 0.

    python -m samplernn_pase_tpu_torch.bench [--smoke --device cpu]

The metric is bench.py's: requests of 16,384 samples at temperature 0.95
built by ``generate.make_generator``; two warm-up requests, then the best
of 2 batches of 4 requests, each batch ending in one
``torch.cuda.synchronize``.  ``vs_baseline`` is against bench.py's target
of 1,024,000 samples/s (64x realtime).  Prints one JSON line with
``metric``, ``value``, ``unit`` and ``vs_baseline``, or, without a CUDA
device, ``{"skipped": true, ...}`` with exit code 0.  ``--smoke`` shrinks
the model and the request (a run of the plain versions on the CPU for the
tests); it runs only on the device it is given, never as a fallback, and
its line carries ``"smoke": true``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BATCH = 128
LENGTH = 16_384           # about 1.02 s of 16 kHz audio per lane
TARGET = 1_024_000.0      # samples/s per card (64x realtime aggregate)
TEMPERATURE = 0.95
N_REP = 4                 # requests per timed batch
N_BATCHES = 2


def flagship():
    from samplernn_pase_tpu_torch.config import SampleRNNConfig
    return SampleRNNConfig(frame_sizes=(16, 4), dim=1024, embed_dim=256,
                           rnn_type="gru", compute_dtype="bfloat16")


def smoke_model():
    from samplernn_pase_tpu_torch.config import SampleRNNConfig
    return SampleRNNConfig(frame_sizes=(4, 2), dim=32, embed_dim=16,
                           compute_dtype="float32")


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device=None, smoke: bool = False) -> dict:
    """The benchmark's JSON record on ``device`` (default CUDA, which must
    be present)."""
    import torch

    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.device import resolve_device
    from samplernn_pase_tpu_torch.models import samplernn

    dev = resolve_device(device)
    cfg = smoke_model() if smoke else flagship()
    b, length = (4, 64) if smoke else (BATCH, LENGTH)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    fn = gen.make_generator(cfg, b, length, temperature=TEMPERATURE,
                            device=dev)
    for seed in (1, 99):               # compile/warm-up, settle clocks
        fn(params, seed)
        sync(dev)
    dt = float("inf")
    for k in range(N_BATCHES):
        t0 = time.perf_counter()
        outs = [fn(params, 2 + N_REP * k + i) for i in range(N_REP)]
        sync(dev)
        dt = min(dt, (time.perf_counter() - t0) / N_REP)
        if any(o.shape != (b, length) for o in outs):
            raise RuntimeError(f"request shape {tuple(outs[0].shape)}, "
                               f"expected {(b, length)}")
    sps = b * length / dt
    out = {
        "metric": "generated_samples_per_sec_per_chip_b128_16khz",
        "value": round(sps, 1),
        "unit": "samples/sec/chip",
        "vs_baseline": round(sps / TARGET, 4),
    }
    if smoke:
        out["smoke"] = True
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny model and request (for the CPU tests)")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch

    from samplernn_pase_tpu_torch.utils.device_guard import skip_marker
    if args.device is None and not torch.cuda.is_available():
        print(skip_marker())
        return 0
    print(json.dumps(run(args.device, args.smoke)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
