"""Where K4's and K5's time goes on the card, launch by launch, and the
train steps they carry.

    python -m samplernn_pase_tpu_torch.scripts.seq_split [--root DIR]
                                                         [--no-train]

K4 (``gru_sequence``) and K5 (``lstm_sequence``) each run as a few
launches: forward, the input product and the serial chain; backward, the
chain, then the dX, dWih and dWhh products.  At every tier of the main
paths (the flagship's GRU at N = 64 and 16, B = 128; config 2's LSTM at
N = 64, 16 and 4, B = 64; H = 1024, bf16) this script prints each
launch's device time (torch.profiler, mean over ``REPS`` calls), the
chain's microseconds per step, and cuDNN's GRU or LSTM on the same inputs
as the yardstick (the port never calls it): its forward, its forward +
backward, and the backward share (the difference).  Then, unless
``--no-train``, the flagship's, the stacked flagship's and config 2's
train steps on the kernel route: ms per step and the idle share of the
device over one profiled step.

``--root DIR`` measures the port in another checkout (``DIR`` holds
``samplernn_pase_tpu_torch``), so that two trees can be compared in one
call on one card.  The last line is one JSON object with every number.
It needs the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

REPS = 5
TIERS = {"gru": (128, (64, 16)), "lstm": (64, (64, 16, 4))}   # B, N
H = 1024
FWD_ROLES = ("input", "chain")
BWD_ROLES = ("chain", "dx", "dwih", "dwhh")


def kernel_events(torch, fn, reps: int = REPS):
    """The device kernels of ``reps`` calls of fn() after one warm call:
    [(name, us)] of one call in launch order, each the mean over the
    calls (every call launches the same kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if evs and len(evs) % reps == 0:
            per = len(evs) // reps
            out = []
            for i in range(per):
                us = [evs[c * per + i].time_range.elapsed_us()
                      for c in range(reps)]
                out.append((evs[i].name, sum(us) / reps))
            return out
    raise RuntimeError("torch.profiler gave no per-call kernel trace")


def split(events, roles):
    """{role: us} for the sequence kernel's own launches (names with
    'chain' are the chain, the others with 'gemm' the products in launch
    order), and 'other' for the rest (casts, flag resets)."""
    out = {r: 0.0 for r in roles}
    out["other"] = 0.0
    products = [r for r in roles if r != "chain"]
    for name, us in events:
        low = name.lower()
        if "chain" in low:
            out["chain"] += us
        elif "gemm" in low and products:
            out[products.pop(0)] += us
        else:
            out["other"] += us
    return out


def sequence_split(torch, dev, rt, cell: str, n: int, b: int, h: int):
    gen = torch.Generator().manual_seed(11 + n)
    g = 3 if cell == "gru" else 4

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    bf = torch.bfloat16
    x, h0, c0 = rnd(n, b, h).to(bf), rnd(b, h, scale=0.5), rnd(b, h,
                                                               scale=0.5)
    wih, bih = rnd(h, g * h, scale=h ** -0.5).to(bf), rnd(g * h, scale=0.1)
    whh, bhh = rnd(h, g * h, scale=h ** -0.5).to(bf), rnd(g * h, scale=0.1)
    dhs, dhf, dcf = rnd(n, b, h).to(bf), rnd(b, h), rnd(b, h)
    if cell == "gru":
        fargs = (x, h0, wih, bih, whh, bhh, "bfloat16")
        hbuf, _, xg, hg = rt.gru_sequence_fwd(*fargs)
        bargs = (x, h0, wih, whh, hbuf, xg, hg, dhs, dhf, "bfloat16")
        fwd, bwd = rt.gru_sequence_fwd, rt.gru_sequence_bwd
    else:
        fargs = (x, h0, c0, wih, bih, whh, bhh, "bfloat16")
        hbuf, c_seq, _, _, g4 = rt.lstm_sequence_fwd(*fargs)
        bargs = (x, c0, wih, whh, hbuf, c_seq, g4, dhs, dhf, dcf,
                 "bfloat16")
        fwd, bwd = rt.lstm_sequence_fwd, rt.lstm_sequence_bwd
    fs = split(kernel_events(torch, lambda: fwd(*fargs)), FWD_ROLES)
    bs = split(kernel_events(torch, lambda: bwd(*bargs)), BWD_ROLES)
    # cuDNN on the same inputs, bf16
    lib = (torch.nn.GRU if cell == "gru" else torch.nn.LSTM)(h, h).to(dev, bf)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(wih.T)
        lib.weight_hh_l0.copy_(whh.T)
        lib.bias_ih_l0.copy_(bih)
        lib.bias_hh_l0.copy_(bhh)
    lib.flatten_parameters()
    xl = x.detach().clone().requires_grad_(True)
    s0 = h0.to(bf)[None]
    if cell == "lstm":
        s0 = (s0, c0.to(bf)[None])
    douts = [dhs, dhf.to(bf)[None]] + ([dcf.to(bf)[None]]
                                       if cell == "lstm" else [])

    def lib_fwd():
        with torch.no_grad():
            lib(xl, s0)

    def lib_fwd_bwd():
        seq, fin = lib(xl, s0)
        outs = [seq] + (list(fin) if cell == "lstm" else [fin])
        torch.autograd.backward(outs, douts)

    lf = sum(us for _, us in kernel_events(torch, lib_fwd))
    lfb = sum(us for _, us in kernel_events(torch, lib_fwd_bwd))
    return {"cell": cell, "n": n, "b": b, "h": h,
            "fwd": fs, "fwd_us": sum(fs.values()),
            "bwd": bs, "bwd_us": sum(bs.values()),
            "chain_us_per_step": {"fwd": fs["chain"] / n,
                                  "bwd": bs["chain"] / n},
            "cudnn_us": {"forward": lf, "forward_backward": lfb,
                         "backward_share": lfb - lf}}


def train_steps(torch, dev):
    """ms per step and the device's idle share over one profiled step of
    the flagship, the stacked flagship and config 2 on the kernel route."""
    import dataclasses
    from pathlib import Path

    from samplernn_pase_tpu_torch.config import (
        SampleRNNConfig, load_config, preset)
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    from samplernn_pase_tpu_torch.train.trainer import (
        make_multi_train_step, make_train_step)
    from torch.profiler import ProfilerActivity, profile

    root = Path(samplernn.__file__).resolve().parents[2]
    flagship = SampleRNNConfig(frame_sizes=(16, 4), dim=1024, embed_dim=256,
                               q_levels=256, n_rnn=1, rnn_type="gru",
                               compute_dtype="bfloat16")
    stacked = dataclasses.replace(
        load_config(root / "configs" / "c5_gen_b128.json").model, n_rnn=2,
        weight_norm=True)
    exp2 = load_config(root / "configs" / "c2_3tier_lstm.json")
    c2 = preset("c2_3tier_lstm").model
    out = {}
    for name, cfg, b, k in (("flagship", flagship, 128, 1),
                            ("stacked", stacked, 128, 1),
                            ("c2", c2, exp2.train.batch_size,
                             exp2.train.steps_per_call)):
        params = samplernn.init_params(torch.Generator().manual_seed(3), cfg,
                                       dev)
        gen = torch.Generator().manual_seed(7)
        t = 1024
        xs = torch.randint(0, cfg.q_levels, (k, b, cfg.lookback + t),
                           generator=gen, dtype=torch.int32).to(dev)
        ys, rs = xs[:, :, cfg.lookback:], torch.zeros(k, b, device=dev)
        tx = make_optimizer(1e-3, 1.0)
        multi = make_multi_train_step(cfg, tx)
        one = make_train_step(cfg, tx)
        p, opt = params, tx.init(params)
        hid = samplernn.initial_state(params, cfg, b)
        for _ in range(2):
            p, opt, hid, _ = multi(p, opt, hid, xs, ys, rs)
        torch.cuda.synchronize()
        calls = max(1, 5 // k)
        t0 = time.perf_counter()
        for _ in range(calls):
            p, opt, hid, _ = multi(p, opt, hid, xs, ys, rs)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (calls * k) * 1e3
        one(p, opt, hid, xs[0], ys[0], rs[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one(p, opt, hid, xs[0], ys[0], rs[0])
            torch.cuda.synchronize()
        busy = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            busy += max(us if us is not None else e.self_cuda_time_total, 0)
        busy_ms = busy / 1e3
        out[name] = {"step_ms": step_ms, "device_ms": busy_ms,
                     "idle_share": 1 - busy_ms / step_ms}
        print(f"{name} train step: {step_ms:.2f} ms, device busy "
              f"{busy_ms:.2f} ms, idle share {1 - busy_ms / step_ms:.3f}",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose samplernn_pase_tpu_torch to measure")
    ap.add_argument("--no-train", action="store_true")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        print("seq_split: no CUDA device", file=sys.stderr)
        return 1
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    kdec.plain_numerics()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; port at {rt.__file__}", flush=True)
    dev = torch.device("cuda")
    rows = []
    for cell, (b, tiers) in TIERS.items():
        for n in tiers:
            r = sequence_split(torch, dev, rt, cell, n, b, H)
            rows.append(r)
            print(f"{cell} N={n} B={b}: forward {r['fwd_us']:.1f} us ("
                  + ", ".join(f"{k} {v:.1f}" for k, v in r["fwd"].items())
                  + f"), chain {r['chain_us_per_step']['fwd']:.2f} us/step; "
                  f"backward {r['bwd_us']:.1f} us ("
                  + ", ".join(f"{k} {v:.1f}" for k, v in r["bwd"].items())
                  + f"), chain {r['chain_us_per_step']['bwd']:.2f} us/step; "
                  f"cuDNN forward {r['cudnn_us']['forward']:.1f}, forward + "
                  f"backward {r['cudnn_us']['forward_backward']:.1f}, "
                  f"backward share {r['cudnn_us']['backward_share']:.1f} us",
                  flush=True)
    means = {}
    for cell in TIERS:
        rs = [r for r in rows if r["cell"] == cell]
        means[cell] = {k: sum(r[k] for r in rs) / len(rs)
                       for k in ("fwd_us", "bwd_us")}
        for k in ("forward", "backward_share"):
            means[cell][f"cudnn_{k}_us"] = sum(
                r["cudnn_us"][k] for r in rs) / len(rs)
        print(f"{cell} mean over tiers: forward {means[cell]['fwd_us']:.1f} "
              f"us (cuDNN {means[cell]['cudnn_forward_us']:.1f}), backward "
              f"{means[cell]['bwd_us']:.1f} us (cuDNN backward share "
              f"{means[cell]['cudnn_backward_share_us']:.1f})", flush=True)
    train = {} if args.no_train else train_steps(torch, dev)
    print(json.dumps({"card": card, "tiers": rows, "means": means,
                      "train": train}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
