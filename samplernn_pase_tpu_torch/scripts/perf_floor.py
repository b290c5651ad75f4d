"""Performance floors on the card, the GPU twin of the repo's
``scripts/perf_floor.py``: the reference's six metrics, each held against
a floor (rates) or a ceiling (step times) set from what ``PERF.md``
records for that path at that shape on the NVIDIA H100 80GB HBM3 at
700.00 W.

    python -m samplernn_pase_tpu_torch.scripts.perf_floor [--metric NAME ...]
        [--smoke --device cpu]

Metrics (the reference's names and shapes):

- ``gen_flagship_2tier_gru``, ``gen_3tier_lstm`` (config 2's model),
  ``gen_conditioned_tts`` (config 4's): samples/s of ``make_generator``
  requests at B=128, 16,384 samples, T=0.95; one warm request, then 3
  back to back and one sync;
- ``train_step_ms_b128_seq1024`` (the flagship), ``train_lstm3_step_ms_
  b64_seq1024`` (config 2), ``train_joint_step_ms_b32_seq1280`` (config
  4's joint PASE + SampleRNN step): ms a step, 3 warm steps, then 8 and
  one sync.

A rate's floor is half the lowest value ``PERF.md`` records for the path
at the shape, a time's ceiling twice the highest (host-paced paths move
by up to 1.5x between runs of one tree on one card).  Prints one JSON line
per metric measured (all six, or those named by ``--metric``): ``metric``,
``value``, ``floor``, ``direction``, ``ok``, ``card`` as measured,
``floor_card`` the card the floors are from; exits 1 when one does not
hold, else 0; without a CUDA device it prints ``utils.device_guard.
skip_marker()`` with exit code 0.  ``--smoke`` measures tiny models on
the device it is given, holds nothing and marks its lines ``"smoke":
true``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BATCH = 128
LENGTH = 16_384
FLOOR_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

# metric -> floor (samples/s) or ceiling (ms), from PERF.md's readings on
# FLOOR_CARD: half the lowest rate, twice the highest time
FLOORS = {
    # 4,312,011.21-7,122,961.95 samples/s recorded at this shape (the bench
    # twin and this script)
    "gen_flagship_2tier_gru": 2_156_005.0,
    # 3,693,893.8-6,666,051.54 (this script, four runs on the card)
    "gen_3tier_lstm": 1_846_946.0,
    # 4,666,561.75-6,462,631.97 (the same runs)
    "gen_conditioned_tts": 2_333_280.0,
    # chip_smoke phase 4's wall a step, 29.01-29.06 ms (this script
    # 28.55-29.02)
    "train_step_ms_b128_seq1024": 58.12,
    # chip_smoke phase 6's wall a step, 19.42-24.93 ms (this script
    # 19.17-20.83)
    "train_lstm3_step_ms_b64_seq1024": 49.86,
    # config 4's joint step: up to 60.0 ms a logged step through the CLI
    # and 59.71 through JointTrainer.run (chip_smoke phases 19 and 16);
    # this script 35.54-57.04
    "train_joint_step_ms_b32_seq1280": 120.0,
}


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _models(smoke: bool):
    """name -> model config of the three generation paths and the two
    plain train steps (the flagship, config 2's 3-tier LSTM, config 4)."""
    from samplernn_pase_tpu_torch.config import SampleRNNConfig
    if smoke:
        base = dict(frame_sizes=(4, 2), dim=32, embed_dim=16,
                    compute_dtype="float32")
        return {"flagship": SampleRNNConfig(**base),
                "lstm3": SampleRNNConfig(**dict(base, frame_sizes=(4, 2, 2),
                                                rnn_type="lstm")),
                "cond": SampleRNNConfig(**base, cond_dim=16, cond_rate=16)}
    big = dict(dim=1024, embed_dim=256, compute_dtype="bfloat16")
    return {"flagship": SampleRNNConfig(frame_sizes=(16, 4), **big),
            "lstm3": SampleRNNConfig(frame_sizes=(16, 4, 4),
                                     rnn_type="lstm", **big),
            "cond": SampleRNNConfig(frame_sizes=(16, 4), cond_dim=256,
                                    cond_rate=160, **big)}


def measure_generation(cfg, dev, b: int, length: int, n_rep: int = 3):
    """Steady samples/s: one warm request, then ``n_rep`` back to back
    with one sync at the end."""
    import numpy as np
    import torch

    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.models import samplernn

    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    cond = None
    if cfg.cond_dim:
        rng = np.random.default_rng(7)
        cond = torch.from_numpy(rng.normal(size=(
            b, -(-length // cfg.cond_rate), cfg.cond_dim)).astype(
                np.float32)).to(dev)
    fn = gen.make_generator(cfg, b, length, temperature=0.95,
                            conditioned=cond is not None, device=dev)

    def call(seed):
        return fn(params, seed) if cond is None else fn(params, seed, cond)
    call(1)
    _sync(dev)
    t0 = time.perf_counter()
    outs = [call(2 + i) for i in range(n_rep)]
    _sync(dev)
    dt = (time.perf_counter() - t0) / n_rep
    if any(o.shape != (b, length) for o in outs):
        raise RuntimeError(f"request shape {tuple(outs[0].shape)}")
    return b * length / dt


def _time_steps(step, state, dev, n_warm=3, n_rep=8):
    for _ in range(n_warm):
        state = step(state)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_rep):
        state = step(state)
    _sync(dev)
    return (time.perf_counter() - t0) / n_rep * 1e3


def measure_train_step(cfg, dev, b: int, t: int) -> float:
    """ms a ``make_train_step`` step (make_optimizer(1e-3, 1.0))."""
    import numpy as np
    import torch

    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    from samplernn_pase_tpu_torch.train.trainer import make_train_step

    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    tx = make_optimizer(1e-3, 1.0)
    step = make_train_step(cfg, tx)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (b, cfg.lookback + t),
                                      np.int32)).to(dev)
    r = torch.zeros(b, device=dev)

    def one(s):
        p, opt, hid = s
        p, opt, hid, _ = step(p, opt, hid, x, x[:, cfg.lookback:], r)
        return p, opt, hid
    state = (params, tx.init(params), samplernn.initial_state(params, cfg,
                                                              b))
    return _time_steps(one, state, dev)


def measure_joint_step(cfg, dev, b: int, t: int, smoke: bool) -> float:
    """ms a joint PASE + SampleRNN step (config 4's encoder in the
    step)."""
    import dataclasses

    import numpy as np
    import torch

    from samplernn_pase_tpu_torch.config import PASEConfig
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.train import joint
    from samplernn_pase_tpu_torch.train.optim import make_optimizer

    pcfg = (PASEConfig(sinc_filters=8, sinc_kernel=33,
                       blocks=((8, 5, 4), (16, 5, 4)), emb_dim=16,
                       compute_dtype="float32") if smoke else PASEConfig())
    cfg = dataclasses.replace(cfg, cond_dim=pcfg.emb_dim,
                              cond_rate=pcfg.decimation)
    params, bn = joint.init_joint(torch.Generator().manual_seed(0), cfg,
                                  pcfg, device=dev)
    tx = make_optimizer(1e-3, 1.0)
    step = joint.make_joint_train_step(cfg, pcfg, tx)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (b, cfg.lookback + t),
                                      np.int32)).to(dev)
    r = torch.zeros(b, device=dev)

    def one(s):
        p, opt, bs, hid = s
        p, opt, bs, hid, _ = step(p, opt, bs, hid, x, x[:, cfg.lookback:], r)
        return p, opt, bs, hid
    state = (params, tx.init(params), bn,
             samplernn.initial_state(params["srnn"], cfg, b))
    return _time_steps(one, state, dev)


def measure(dev, smoke: bool = False, names=None) -> dict:
    """metric -> measured value on ``dev``, for ``names`` (default every
    metric, in FLOORS' order)."""
    m = _models(smoke)
    gb, gl = (4, 256) if smoke else (BATCH, LENGTH)
    t = 64 if smoke else 1024
    runs = {
        "gen_flagship_2tier_gru": lambda: measure_generation(
            m["flagship"], dev, gb, gl),
        "gen_3tier_lstm": lambda: measure_generation(m["lstm3"], dev, gb, gl),
        "gen_conditioned_tts": lambda: measure_generation(m["cond"], dev, gb,
                                                          gl),
        "train_step_ms_b128_seq1024": lambda: measure_train_step(
            m["flagship"], dev, 4 if smoke else 128, t),
        "train_lstm3_step_ms_b64_seq1024": lambda: measure_train_step(
            m["lstm3"], dev, 4 if smoke else 64, t),
        "train_joint_step_ms_b32_seq1280": lambda: measure_joint_step(
            m["flagship"], dev, 4 if smoke else 32, 64 if smoke else 1280,
            smoke)}
    return {name: runs[name]() for name in FLOORS
            if names is None or name in names}


def card_name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny models, no floors held (the CPU tests)")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    ap.add_argument("--metric", action="append", choices=list(FLOORS),
                    help="measure this metric only (repeatable; default "
                         "all six)")
    args = ap.parse_args(argv)
    import torch

    from samplernn_pase_tpu_torch.device import resolve_device
    from samplernn_pase_tpu_torch.ops.kernels.decode import plain_numerics
    from samplernn_pase_tpu_torch.utils.device_guard import skip_marker
    if args.device is None and not torch.cuda.is_available():
        print(skip_marker())
        return 0
    dev = resolve_device(args.device)
    plain_numerics()
    failures = []
    for name, value in measure(dev, args.smoke, args.metric).items():
        rec = {"metric": name, "value": round(value, 2),
               "direction": "max" if name.startswith("train") else "min",
               "card": card_name(dev)}
        if args.smoke:
            rec["smoke"] = True
        else:
            floor = FLOORS[name]
            ok = (value <= floor if rec["direction"] == "max"
                  else value >= floor)
            rec.update(floor=floor, ok=ok, floor_card=FLOOR_CARD)
            if not ok:
                failures.append(name)
        print(json.dumps(rec))
    if failures:
        print(f"PERF REGRESSION: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
