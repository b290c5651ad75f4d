"""Where a step of K4's and K5's bf16 chains goes, phase by phase, on the
card; and the chains' time under other plans.

    python -m samplernn_pase_tpu_torch.scripts.seq_trace [--sweep]

With the library's trace buffer set (``srnn_gru_seq_trace``,
``srnn_lstm_seq_trace``), block 0 of a chain writes ``clock64()`` at each
phase of its first 32 steps (``csrc/seq_common.cuh``, ``tc::trace``).  At
the flagship's GRU (B=128) and config 2's LSTM (B=64), H=1024, N=64,
bf16, this prints the mean over steps 2..30 of each phase in us (cycles
over the SM clock, read from ``%globaltimer`` beside ``clock64`` at the
block's start and end):

forward: ``wait`` (step start to the first slot landed: the owners'
flags, the copy), ``product`` (the first slot to the last wgmma
retired), ``gates`` (the gate math and stores), ``publish`` (the fences
and the flag), ``step`` (step start to the next); the producer's
``seen`` (this block's own publish of the step before to the owners of
the first slot seen) and ``copy`` (that slot issued to landed); each
slot of step 8, landed and issued; ``setup`` (the kernel's entry to its
first step).  backward: ``gates`` (the gate gradients), ``publish``,
``wait``, ``product``, ``step``, ``setup``.

With ``--sweep`` it also times the chains (device us per call,
torch.profiler) and checks them against the plain versions under every
plan of 8- or 16-unit blocks that fits.  The last line is one JSON object.
It needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from samplernn_pase_tpu_torch.ops.kernels import _build
from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
from samplernn_pase_tpu_torch.scripts import seq_split

H, N = 1024, 64
SHAPES = {"gru": 128, "lstm": 64}          # batch
TRACE_STEPS = 32
FWD = {"wait": (0, 1), "product": (1, 2), "gates": (2, 3),
       "publish": (3, 4)}
BWD = {"gates": (0, 5), "publish": (5, 4), "wait": (4, 1),
       "product": (1, 2)}


def inputs(cell, b, seed=5):
    gen = torch.Generator().manual_seed(seed)
    g = rt.GATES[cell]

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    bf = torch.bfloat16
    x, h0, c0 = rnd(N, b, H).to(bf), rnd(b, H, scale=0.5), rnd(b, H,
                                                               scale=0.5)
    wih, bih = rnd(H, g * H, scale=H ** -0.5).to(bf), rnd(g * H, scale=0.1)
    whh, bhh = rnd(H, g * H, scale=H ** -0.5).to(bf), rnd(g * H, scale=0.1)
    dhs, dhf, dcf = rnd(N, b, H).to(bf), rnd(b, H), rnd(b, H)
    if cell == "gru":
        fargs = (x, h0, wih, bih, whh, bhh, "bfloat16")
        hbuf, _, xg, hg = rt.gru_sequence_fwd_plain(*fargs)
        bargs = (x, h0, wih, whh, hbuf, xg, hg, dhs, dhf, "bfloat16")
    else:
        fargs = (x, h0, c0, wih, bih, whh, bhh, "bfloat16")
        hbuf, c_seq, _, _, g4 = rt.lstm_sequence_fwd_plain(*fargs)
        bargs = (x, c0, wih, whh, hbuf, c_seq, g4, dhs, dhf, dcf,
                 "bfloat16")
    return fargs, bargs


def traced(cell, fn):
    """fn() with block 0's phase trace on: int64 [TRACE_STEPS * 16 + 134]."""
    setter = _build.function(f"{cell}_sequence", f"srnn_{cell}_seq_trace",
                             [ctypes.c_void_p])
    buf = torch.zeros(TRACE_STEPS * 16 + 6 + 2 * 64, dtype=torch.int64,
                      device="cuda")
    setter(buf.data_ptr())
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        setter(None)
    return buf.cpu().tolist()


def phases(tr, spans, producer):
    """Mean us of each span over steps 2..30, with the step's own."""
    base = TRACE_STEPS * 16
    ghz = (tr[base + 2] - tr[base]) / max(1, tr[base + 3] - tr[base + 1])
    steps = range(2, TRACE_STEPS - 2)

    def mean(f):
        return sum(f(s) for s in steps) / len(steps) / ghz / 1e3

    out = {k: mean(lambda s, a=a, b=b: tr[s * 16 + b] - tr[s * 16 + a])
           for k, (a, b) in spans.items()}
    out["step"] = mean(lambda s: tr[(s + 1) * 16] - tr[s * 16])
    if producer:
        out["seen"] = mean(lambda s: tr[s * 16 + 8] - tr[(s - 1) * 16 + 4])
        out["copy"] = mean(lambda s: tr[s * 16 + 1] - tr[s * 16 + 9])
    out["ghz"] = ghz
    # the kernel's set-up (the Whh slice into shared memory, the barriers)
    out["setup"] = (tr[base] - tr[base + 4]) / ghz / 1e3
    # step 8, slot by slot: landed and issued (us after the step's start)
    b0 = base + 6
    st = tr[8 * 16]
    out["slots"] = [[round((tr[b0 + i] - st) / ghz / 1e3, 2),
                     round((tr[b0 + 64 + i] - st) / ghz / 1e3, 2)]
                    for i in range(64) if tr[b0 + i] or tr[b0 + 64 + i]]
    return out


def chain_us(fn):
    ev = seq_split.kernel_events(torch, fn)
    return sum(us for name, us in ev if "chain" in name.lower())


def rel_err(got, want):
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max().clamp_min(1e-30)).item()
               for g, w in zip(got, want))


def plans(cell, b):
    """Every plan of 8- or 16-unit blocks, one or two warpgroups, one row
    group or 64-row groups, slots of 1 or 8 chunks, whose blocks fit one
    per SM."""
    out = []
    for units in (8, 16):
        for wg in (1, 2):
            for rows in sorted({-(-b // (64 * wg)) * 64 * wg, 64 * wg}):
                blocks = H // units * -(-b // rows)
                for chunks, least in ((1, rt.MIN_STAGES), (8, 2)):
                    fixed = rt._chain_smem(cell, H, units, wg, 0, chunks)
                    stages = min(rt.MAX_STAGES, (rt.SMEM_MAX - fixed)
                                 // (chunks * wg * rt.BOX))
                    if blocks <= rt.SMS and stages >= least:
                        out.append(rt.ChainPlan(
                            units, wg, rows, stages, chunks,
                            rt._chain_smem(cell, H, units, wg, stages,
                                           chunks), blocks))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("seq_trace: no CUDA device", file=sys.stderr)
        return 1
    kdec.plain_numerics()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "trace": {}, "sweep": []}
    for cell, b in SHAPES.items():
        fargs, bargs = inputs(cell, b)
        fwd = getattr(rt, f"{cell}_sequence_fwd")
        bwd = getattr(rt, f"{cell}_sequence_bwd")
        fwd(*fargs)
        bwd(*bargs)
        ft = phases(traced(cell, lambda: fwd(*fargs)), FWD, True)
        bt = phases(traced(cell, lambda: bwd(*bargs)), BWD, False)
        result["trace"][cell] = {"fwd": ft, "bwd": bt,
                                 "plan": list(rt.chain_plan(cell, H, b))}
        for d, t in (("forward", ft), ("backward", bt)):
            print(f"{cell} B={b} {d} us per step: " + ", ".join(
                f"{k} {v:.2f}" for k, v in t.items() if k != "slots"),
                flush=True)
            print(f"  slots of step 8 (landed, issued us): "
                  f"{t['slots']}", flush=True)
        if not args.sweep:
            continue
        fw = getattr(rt, f"{cell}_sequence_fwd_plain")(*fargs)
        bw = getattr(rt, f"{cell}_sequence_bwd_plain")(*bargs)
        for plan in plans(cell, b):
            f_us = chain_us(lambda: fwd(*fargs, plan=plan))
            b_us = chain_us(lambda: bwd(*bargs, plan=plan))
            err = max(rel_err(fwd(*fargs, plan=plan), fw),
                      rel_err(bwd(*bargs, plan=plan), bw))
            row = {"cell": cell, "plan": list(plan), "fwd_chain_us": f_us,
                   "bwd_chain_us": b_us, "max_rel_err": err}
            result["sweep"].append(row)
            print(f"  {cell} plan {tuple(plan[:5])}: forward chain "
                  f"{f_us:.1f} us ({f_us / N:.2f}/step), backward chain "
                  f"{b_us:.1f} us ({b_us / N:.2f}/step), max err {err:.3g} "
                  "of max", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
