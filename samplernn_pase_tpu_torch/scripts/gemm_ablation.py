"""K2's epilogue ablation on the card: what each epilogue term costs.

    python -m samplernn_pase_tpu_torch.scripts.gemm_ablation

K2 (``ops/kernels/decode.gemm_bias``) computes ``round(A) @ W + bias (+
add) (+ the lane's conditioning row)``.  This script times it at the
flagship's tier-input shapes with the epilogue's terms switched on one at
a time (no bias, + bias, + ``add``, + the conditioning row), and at one
GRU gate product with and without its bias, each beside ``torch.addmm``
on the same product (the yardstick; the port never calls it).  Times
are device times from ``torch.profiler``, per launch, over ``REPS``
back-to-back launches; the weights are random bf16 from a seed.

It prints one line per case and, last, one JSON object with every case:
``{"card": ..., "cases": [{"name", "shape", "us", "addmm_us", "plan"},
...]}``.  With ``--sweep`` it also times every plan the core can run
(split, tile width, column groups) at the main paths' bf16 products
beside ``decode.gemm_plan``'s own, and adds them under ``"sweep"``.  It
needs the card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from samplernn_pase_tpu_torch.ops.kernels import _build
from samplernn_pase_tpu_torch.ops.kernels import decode as kdec

B, H, Q = 128, 1024, 256       # the flagship's batch, width and levels
ROWS, RATE = 4, 160            # config 4's conditioning rows per call, rate
REPS = 50


def device_us(fn, reps: int = REPS, tries: int = 3,
              key: str | None = None) -> float:
    """Summed device time of the kernels ``fn`` launches, per call (us),
    from torch.profiler over ``reps`` calls after one warm call; with
    ``key``, of the kernels whose name holds it only.  A trace with no
    such device time in it is taken again, up to ``tries`` times, and
    then raises RuntimeError: a dropped trace is never read as 0 us."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            if key is not None and key not in e.key:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            total += max(us, 0.0)
        if total > 0:
            return total / reps
    raise RuntimeError(f"torch.profiler recorded no device time"
                       f"{'' if key is None else ' in ' + key} in {tries} "
                       "traces")


def cases(dev):
    """(name, A, W, bias, add, levels_q, conditioning kwargs) per case."""
    gen = torch.Generator(device=dev).manual_seed(31)
    win = torch.randint(0, Q, (B, 64), device=dev, generator=gen,
                        dtype=torch.int32)
    w64 = (torch.randn(64, H, device=dev, generator=gen) * 0.1).bfloat16()
    w16 = (torch.randn(16, H, device=dev, generator=gen) * 0.1).bfloat16()
    wg = (torch.randn(H, 3 * H, device=dev, generator=gen)
          * 0.03).bfloat16()
    bias = torch.randn(H, device=dev, generator=gen)
    bias3 = torch.randn(3 * H, device=dev, generator=gen)
    upper = torch.randn(B, H, device=dev, generator=gen)
    h = torch.randn(B, H, device=dev, generator=gen)
    # [B, R, H] storage read as [R, B, H]: generate.project_cond's layout
    ext = torch.randn(B, ROWS, H, device=dev, generator=gen).transpose(0, 1)
    phase = torch.randint(0, RATE, (B,), device=dev, generator=gen,
                          dtype=torch.int32)
    cond = dict(ext=ext, cphase=phase, pos=RATE * 5 // 8, cond_rate=RATE)
    top, bottom = win, win[:, -16:]
    return [
        ("tier1 input, no bias", top, w64, None, None, Q, {}),
        ("tier1 input +bias", top, w64, bias, None, Q, {}),
        ("tier1 input +bias +cond", top, w64, bias, None, Q, cond),
        ("tier0 input, no bias", bottom, w16, None, None, Q, {}),
        ("tier0 input +bias", bottom, w16, bias, None, Q, {}),
        ("tier0 input +bias +add", bottom, w16, bias, upper, Q, {}),
        ("tier0 input +bias +add +cond", bottom, w16, bias, upper, Q, cond),
        ("gate, no bias", h, wg, None, None, 0, {}),
        ("gate +bias", h, wg, bias3, None, 0, {}),
    ]


def run(dev) -> list:
    """Time every case; returns [{"name", "shape", "us", "addmm_us",
    "plan"}]."""
    plan_of = getattr(kdec, "gemm_plan", None)
    out = []
    for name, a, w, bias, add, lq, kw in cases(dev):
        m, k = a.shape
        n = w.shape[1]
        us = device_us(lambda: kdec.gemm_bias(a, w, bias, add, levels_q=lq,
                                              **kw))
        # the yardstick: addmm with everything that is added folded into
        # its added input, on A already dequantized and rounded
        af = (a.float() / (lq / 2) - 1) if lq else a
        a_lib = af.to(w.dtype)
        extra = torch.zeros(m, n, device=dev)
        if bias is not None:
            extra = extra + bias
        if add is not None:
            extra = extra + add
        if kw:
            base = kw["pos"] // kw["cond_rate"]
            bump = (kw["cphase"].long() + kw["pos"] % kw["cond_rate"]
                    >= kw["cond_rate"])[:, None]
            extra = extra + torch.where(bump, kw["ext"][base + 1],
                                        kw["ext"][base])
        lib_in = extra.to(w.dtype)
        lib_us = device_us(lambda: torch.addmm(lib_in, a_lib, w))
        plan = plan_of(k, n, w.dtype) if plan_of else None
        plan = plan._asdict() if plan else None
        out.append({"name": name, "shape": f"[{m},{k}]@[{k},{n}]",
                    "us": us, "addmm_us": lib_us, "plan": plan})
        print(f"K2 ablation {name:30s} [{m},{k}]@[{k},{n}]: {us:.2f} us, "
              f"addmm {lib_us:.2f} us" + (f", plan {plan}" if plan else ""))
    return out


SWEEP = (   # (name, M, K, N, A as levels, with add)
    ("tier0 input +add", 128, 16, 1024, True, True),
    ("tier1 input", 128, 64, 1024, True, False),
    ("config 2 tier2 input", 128, 256, 1024, True, False),
    ("cond projection", 3456, 256, 1024, False, False),
    ("gate (GRU)", 128, 1024, 3072, False, False),
    ("gate h +xg (LSTM)", 128, 1024, 4096, False, True),
    ("bottom upsample", 128, 1024, 16384, False, False),
    ("K9 window", 128, 4096, 1024, False, False),
    ("K9 hidden", 128, 1024, 1024, False, False),
    ("K9 output", 128, 1024, 256, False, False),
)


def candidates(k: int, n: int):
    """Every plan the core can run for K, N: splits 1-8 up to K's 16-row
    steps, tile widths 64 and 128, 4-128 column groups."""
    k16 = -(-k // 16)
    for bn in kdec.STAGES:
        tiles = -(-n // bn)
        for split in (1, 2, 4, 8):
            if split > k16:
                continue
            for groups in sorted({tiles, 128, 96, 64, 48, 32, 24, 16, 8, 4}):
                if groups <= tiles:
                    yield kdec.GemmPlan(split, bn, groups,
                                        kdec._plan_smem(bn), split * groups)


def clusters(plan) -> int:
    """Clusters of ``plan.split`` CTAs the card holds at once for K2's
    core at this plan's tile width and shared memory."""
    fn = _build.function("gemm_bias", "srnn_gemm_bias_clusters",
                         [ctypes.c_int] * 2)
    return fn(plan.split, plan.bn)


def sweep(dev) -> list:
    """Time K2 on every candidate plan at each SWEEP product, beside
    decode.gemm_plan's own."""
    gen = torch.Generator(device=dev).manual_seed(32)
    out = []
    for name, m, k, n, levels, with_add in SWEEP:
        a = (torch.randint(0, Q, (m, k), device=dev, generator=gen,
                           dtype=torch.int32) if levels
             else torch.randn(m, k, device=dev, generator=gen))
        w = (torch.randn(k, n, device=dev, generator=gen)
             * k ** -0.5).bfloat16()
        bias = torch.randn(n, device=dev, generator=gen)
        add = (torch.randn(m, n, device=dev, generator=gen)
               if with_add else None)
        lq = Q if levels else 0
        best = kdec.gemm_plan(k, n, w.dtype)
        times = []
        for plan in [best] + [c for c in candidates(k, n) if c != best]:
            us = device_us(lambda: kdec.gemm_bias(a, w, bias, add,
                                                  levels_q=lq, plan=plan), 20)
            times.append((us, plan))
        times_sorted = sorted(times, key=lambda t: t[0])
        print(f"K2 sweep {name} [{m},{k}]@[{k},{n}]: gemm_plan "
              f"{times[0][1][:3]} {times[0][0]:.2f} us; best "
              + "; ".join(f"{p[:3]} {u:.2f} us ({p.ctas} CTAs, "
                          f"{clusters(p)} clusters resident)"
                          for u, p in times_sorted[:5]))
        out.append({"name": name, "shape": f"[{m},{k}]@[{k},{n}]",
                    "plan": times[0][1]._asdict(), "us": times[0][0],
                    "all": [[*p[:3], u, clusters(p)]
                            for u, p in times_sorted]})
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time every candidate plan")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    kdec.plain_numerics()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    rows = run(torch.device("cuda"))
    result = {"card": card, "cases": rows}
    if args.sweep:
        result["sweep"] = sweep(torch.device("cuda"))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
