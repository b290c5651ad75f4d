"""Training throughput of the port, the GPU twin of the repo's
``scripts/bench_train.py``: the flagship (2-tier GRU, frame_sizes
(16, 4), dim 1024, embed 256, bf16) at B=128, TBPTT seq_len 1024, through
``train.trainer.make_train_step`` and ``make_optimizer(1e-3, 1.0)`` on
random levels from a seed.

    python -m samplernn_pase_tpu_torch.scripts.bench_train [--smoke --device cpu]

One warm step, then 8 steps timed with one sync at the end.  Prints one
JSON line (``metric`` train_bottom_frames_per_sec_b128_seq1024,
``value``, ``unit``, ``samples_per_sec``, ``step_ms``), or, without a
CUDA device, ``{"skipped": true, ...}`` with exit code 0.  ``--smoke``
shrinks the model and the batch and runs only on the device it is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BATCH = 128
SEQ_LEN = 1024
N_REP = 8


def run(device=None, smoke: bool = False) -> dict:
    """The benchmark's JSON record on ``device`` (default CUDA, which must
    be present)."""
    import numpy as np
    import torch

    from samplernn_pase_tpu_torch.bench import flagship, smoke_model, sync
    from samplernn_pase_tpu_torch.device import resolve_device
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    from samplernn_pase_tpu_torch.train.trainer import make_train_step

    dev = resolve_device(device)
    cfg = smoke_model() if smoke else flagship()
    b, t = (2, 64) if smoke else (BATCH, SEQ_LEN)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    tx = make_optimizer(1e-3, 1.0)
    opt = tx.init(params)
    hid = samplernn.initial_state(params, cfg, b)
    step = make_train_step(cfg, tx)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, cfg.q_levels,
                                      (b, cfg.lookback + t),
                                      np.int32)).to(dev)
    y = x[:, cfg.lookback:]
    r = torch.zeros(b, device=dev)
    params, opt, hid, nll = step(params, opt, hid, x, y, r)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(N_REP):
        params, opt, hid, nll = step(params, opt, hid, x, y, r)
    sync(dev)
    dt = (time.perf_counter() - t0) / N_REP
    if not torch.isfinite(nll).item():
        raise RuntimeError(f"non-finite NLL {nll.item()}")
    out = {
        "metric": "train_bottom_frames_per_sec_b128_seq1024",
        "value": round(b * t / cfg.frame_sizes[0] / dt, 1),
        "unit": "frames/sec",
        "samples_per_sec": round(b * t / dt, 1),
        "step_ms": round(dt * 1e3, 2),
    }
    if smoke:
        out["smoke"] = True
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny model and batch (for the CPU tests)")
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
