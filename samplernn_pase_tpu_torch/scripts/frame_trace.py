"""Where a step of K1 (``frame_decode``) goes, phase by phase, on the card;
K1's time per launch under each plan; and, with ``--root``, another
checkout's K1 timed in the same call.

    python -m samplernn_pase_tpu_torch.scripts.frame_trace [--sweep]
                                                           [--root DIR]

At the flagship's shape (B=128, H=1024, q=256, f1=16, bf16 weights) and
in noise modes 2 (one seed) and 3 (per-lane keys and positions), with the
library's trace buffer set (``srnn_frame_decode_trace``), block 0 writes
``clock64()`` at each phase of every step (``csrc/frame_decode.cu``,
``trace_at`` and the tensor-core kernel's ``tracing`` points).  This
prints the mean over steps 1..14 of each phase in us (cycles over the SM
clock, read from ``%globaltimer`` beside ``clock64`` at block 0's entry
and exit), for the CUDA-core kernel (route "fma", K1's only kernel before
the tensor-core one) and the default plan's kernel (route "tc"):

fma: ``gather`` (layer 1: f1 gathered W' rows, b_in, cond), ``h1``
(the slice pushed into every block, the cluster barrier), ``layer2``
(the FMA products), ``ksplit`` (the K-slice sum through shared memory,
bias, relu), ``h2`` (push and barrier), ``layer3`` (products),
``layer3_sum``, ``noise``, ``argmax`` (partials pushed, the barrier),
``roll`` (the final argmax and the window).

tc: ``gather`` (the newest W' row, b_in, cond -> the h1 slice, copied
into the other blocks), ``side_cond`` and ``side_rows`` (the next step's
cond row and rows issued), ``h1`` (until every block's slice landed),
``layer2`` (thread 0's warp's ``ldmatrix`` + ``mma.sync`` products: K-half
0 of h1 @ W_h for 32 of the block's 128 columns, 4 boxes, with
``layer2_box_wait`` the part spent waiting for them), ``epilogue`` (until
every warp's products are done, then the two K-halves' sum through
shared memory, bias, relu, the h2 slice copied), ``h2``, ``layer3``
(the warp's products: its warpgroup's half of the block's K-slice of
W_out for 16 of the tile's 64 columns, with ``layer3_box_wait``),
``partials`` (until the warpgroup is done, copied to the tile's leader),
``rows`` (the next step's row sums), ``leader`` (the partials' sum,
b_out, the noise warp's noise, argmax, sent), ``argmax`` (until every
partial landed), ``roll`` (the sample taken).

Each trace also gives the grid's makespan against the mean block's time
(``waves``: above 1 where some blocks waited for others to leave).
Then the device us per launch (torch.profiler, mean of ``REPS``) of each
route and, with ``--sweep``, of the default plan with shallower rings
(down to ``decode.K1_MIN_STAGES`` slots), each checked against the plain
version by rescoring.  ``--root DIR`` also times ``DIR``'s K1 (a
checkout holding ``samplernn_pase_tpu_torch``, e.g. a ``git archive`` of
the parent under ``build/``) in a subprocess on the same inputs, in the
order root, this tree, this tree, root.  The last line is one JSON
object.  It needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

B, H, Q, F1 = 128, 1024, 256, 16
REPS = 10
TRACE_STEPS = 16
MAX_BLOCKS = 1024
SPANS = {
    "fma": {"gather": (0, 1), "h1": (1, 2), "layer2": (2, 3),
            "ksplit": (3, 4), "h2": (4, 5), "layer3": (5, 10),
            "layer3_sum": (10, 6), "noise": (6, 7), "argmax": (7, 8),
            "roll": (8, 9)},
    "tc": {"gather": (0, 1), "side_cond": (1, 11), "side_rows": (11, 12),
           "h1": (12, 2), "layer2": (2, 3), "epilogue": (3, 4),
           "h2": (4, 5), "layer3": (5, 10), "partials": (10, 6),
           "rows": (6, 13), "leader": (13, 7), "argmax": (7, 8),
           "roll": (8, 9)},
}


def inputs(torch, seed=5):
    """The flagship's K1 inputs, made on the CPU from a seed: weights of
    scale H**-0.5, random levels, cond rows; mode 2's and mode 3's
    arguments."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    bf = torch.bfloat16
    mw = {"w_fused": rnd(F1 * Q, H, scale=0.3).to(bf),
          "b_in": rnd(H, scale=0.1),
          "w_h": rnd(H, H, scale=H ** -0.5).to(bf), "b_h": rnd(H, scale=0.1),
          "w_out": rnd(H, Q, scale=H ** -0.5).to(bf),
          "b_out": rnd(Q, scale=0.1)}
    window = torch.randint(0, Q, (B, F1), generator=gen,
                           dtype=torch.int32).cuda()
    cond = rnd(B, F1 * H, scale=0.5)
    bup = rnd(F1, H, scale=0.1)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, 2), generator=gen,
                         dtype=torch.int32).cuda()
    lane_pos = torch.randint(0, 1 << 20, (B,), generator=gen).cuda()
    args = (window, cond, bup, mw)
    modes = {2: dict(temperature=0.95, noise=None, seed=7, pos0=1000),
             3: dict(temperature=1.0, noise=None, seed=0, pos0=500,
                     lane_keys=keys, lane_pos=lane_pos)}
    return args, modes


def device_us(torch, fn, reps: int = REPS) -> float:
    """Mean device time of fn()'s kernels per call (torch.profiler), after
    a warm call; retried, and raises where no device time is seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / reps
    raise RuntimeError("torch.profiler gave no device time")


def time_modes(torch, kdec, plan=None) -> dict:
    args, modes = inputs(torch)
    kw = {} if plan is None else {"plan": plan}
    return {m: device_us(torch, lambda m=m: kdec.frame_decode(
        *args, **modes[m], **kw)) for m in modes}


def traced(torch, kdec, _build, fn):
    """fn() with block 0's phase trace on: the trace buffer as a list."""
    setter = _build.function("frame_decode", "srnn_frame_decode_trace",
                             [ctypes.c_void_p])
    buf = torch.zeros(TRACE_STEPS * 16 + 4 + 2 * MAX_BLOCKS,
                      dtype=torch.int64, device="cuda")
    setter(buf.data_ptr())
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        setter(None)
    return buf.cpu().tolist()


def phases(tr, route: str) -> dict:
    """Mean us of each span over steps 1..14, the step's own, and the
    grid's waves (over the blocks that wrote their entry)."""
    base = TRACE_STEPS * 16
    ghz = (tr[base + 2] - tr[base]) / max(1, tr[base + 3] - tr[base + 1])
    steps = range(1, TRACE_STEPS - 1)

    def mean(f):
        return sum(f(s) for s in steps) / len(steps) / ghz / 1e3

    out = {k: mean(lambda s, a=a, b=b: tr[s * 16 + b] - tr[s * 16 + a])
           for k, (a, b) in SPANS[route].items()}
    out["step"] = mean(lambda s: tr[(s + 1) * 16] - tr[s * 16])
    if route == "tc":   # cycles thread 0 waited for weight boxes
        out["layer2_box_wait"] = mean(lambda s: tr[s * 16 + 14])
        out["layer3_box_wait"] = mean(lambda s: tr[s * 16 + 15])
    ran = [k for k in range(MAX_BLOCKS) if tr[base + 4 + 2 * k]]
    blocks = len(ran)
    ent = [tr[base + 4 + 2 * k] for k in ran]
    ext = [tr[base + 5 + 2 * k] for k in ran]
    span = (max(ext) - min(ent)) / 1e3
    each = sum(x - e for e, x in zip(ent, ext)) / blocks / 1e3
    out.update(ghz=ghz, blocks=blocks, makespan_us=span, block_us=each,
               waves=span / max(each, 1e-9))
    return out


def agreement(torch, kdec, args, mode_kw, plan) -> float:
    """Rescoring agreement of the kernel under ``plan`` with the plain
    version fed the kernel's own samples."""
    got = kdec.frame_decode(*args, **mode_kw, plan=plan)
    again = kdec.frame_decode_plain(*args, **mode_kw, forced=got)
    return (again == got).float().mean().item()


def clusters(_build, plan) -> int:
    """Clusters of the tensor-core kernel the card holds at once under
    ``plan``."""
    fn = _build.function("frame_decode", "srnn_frame_clusters",
                         [ctypes.c_int] * 4)
    return fn(H, Q, F1, plan.stages)


def root_times(root: str) -> dict:
    """``root``'s K1 times per mode, from a subprocess that imports the
    port from there."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--time-only",
         "--port", root], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return {int(k): v for k, v in
            json.loads(proc.stdout.strip().splitlines()[-1]).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--root", default=None,
                    help="checkout whose K1 to time beside this tree's")
    ap.add_argument("--time-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.port:
        sys.path.insert(0, os.path.abspath(args.port))
    import torch
    if not torch.cuda.is_available():
        print("frame_trace: no CUDA device", file=sys.stderr)
        return 1
    from samplernn_pase_tpu_torch.ops.kernels import _build
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    kdec.plain_numerics()
    if args.time_only:
        print(json.dumps(time_modes(torch, kdec)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "shape": [B, H, Q, F1], "trace": {},
              "us": {}, "sweep": []}
    k1args, modes = inputs(torch)
    default = kdec.frame_plan(H, Q, F1, torch.bfloat16)
    fma = kdec.FramePlan("fma", kdec.FMA_CLUSTER, kdec.FMA_LANES,
                         H // kdec.FMA_CLUSTER, 1, 0,
                         kdec._fma_smem(H, Q, F1, 8))
    routes = {"fma": fma}
    if default.route == "tc":
        routes["tc"] = default
    if args.root:
        result["root_us"] = [root_times(args.root)]
        print(f"root {args.root}: K1 us per launch {result['root_us'][0]}",
              flush=True)
    for name, plan in routes.items():
        result["us"][name] = time_modes(torch, kdec, plan)
        print(f"{name} plan {tuple(plan)}: K1 us per launch "
              f"{result['us'][name]}", flush=True)
    if args.root:
        result["us"]["tc_again"] = time_modes(torch, kdec, default)
        result["root_us"].append(root_times(args.root))
        print(f"again: this tree {result['us']['tc_again']}, root "
              f"{result['root_us'][1]}", flush=True)
    for name, plan in routes.items():
        result["trace"][name] = {}
        for m, kw in modes.items():
            tr = traced(torch, kdec, _build, lambda kw=kw, plan=plan:
                        kdec.frame_decode(*k1args, **kw, plan=plan))
            t = phases(tr, plan.route)
            result["trace"][name][m] = t
            print(f"{name} mode {m} us per step: " + ", ".join(
                f"{k} {v:.3f}" for k, v in t.items()), flush=True)
    if args.sweep:
        plans = [default._replace(stages=st, smem=default.smem - (
            default.stages - st) * kdec.BOX)
            for st in range(kdec.K1_MIN_STAGES, default.stages)]
        for plan in plans:
            fit = clusters(_build, plan)
            row = {"plan": list(plan), "clusters_at_once": fit,
                   "us": time_modes(torch, kdec, plan),
                   "agree": {m: agreement(torch, kdec, k1args, kw, plan)
                             for m, kw in modes.items()}}
            tr = traced(torch, kdec, _build, lambda plan=plan:
                        kdec.frame_decode(*k1args, **modes[2], plan=plan))
            row["trace_mode2"] = phases(tr, "tc")
            result["sweep"].append(row)
            print(f"  plan {tuple(plan)}: {fit} clusters at once, us per "
                  f"launch {row['us']}, rescoring {row['agree']}, step "
                  f"{row['trace_mode2']['step']:.3f} us, waves "
                  f"{row['trace_mode2']['waves']:.2f}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
