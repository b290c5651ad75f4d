#!/usr/bin/env python3
"""Drive the PyTorch port's generation and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. the card: its name and power limit (nvidia-smi), then one nvcc build
   per CUDA source under samplernn_pase_tpu_torch/ops/kernels/csrc, all
   started together, into build/torch_kernels/;
2. each kernel against its plain PyTorch version on the card, at the
   main paths' shapes in bf16 and at a small float32 shape, and timed
   beside its plain version, its bound and one library call computing
   the same function (K2: torch.addmm; K3: aten._thnn_fused_gru_cell;
   K4: cuDNN's GRU through torch.nn.GRU, forward and forward + backward);
3. the generation path at full width: the flagship model (2-tier GRU,
   frame_sizes (16, 4), dim 1024, embed 256, q 256, bf16) with random
   weights from a seed and its kernel weights prepared once, B=128:
   generate_levels greedy and sampled (T=0.95), and one sampled request
   through make_generator(use_kernels="frame"), which must equal the
   sampled one.  Every decode kernel's launch count must move, levels
   must lie in [0, 256), and rescoring the emitted history through the
   plain per-step modules must agree on >= 0.99 of the samples;
4. the training path at full width: the flagship's TBPTT train step
   (make_train_step, make_optimizer(1e-3, 1.0)) at B=128, seq_len 1024
   on random levels from a seed, 2 warm steps then 5 timed.  Both K4
   kernels must launch twice per step (one per tier), the NLL must be
   finite and fall, and one step through the plain scan route
   (pallas_train_rnn=False) must agree in NLL and gradients, in float32
   and in bf16; then graft_entry.entry() on the card;
5. a {"kernels": [...]} line, then the last line
   {"ok": true, "device": {"platform": "gpu", ...}}.

It imports nothing of JAX.  Without a CUDA device, or run from a
directory without the port beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12      # dense tensor-core FLOP/s, H100 SXM data sheet
PEAK_F32 = 67e12        # float32 FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12     # bytes/s
BATCH = 128             # lanes per request, as bench.py
LENGTH = 1024           # samples per request: 16 flagship top frames
SEQ_LEN = 1024          # TBPTT chunk, as scripts/bench_train.py


class SmokeFailure(Exception):
    """A phase found the port wrong: the run ends with a non-zero exit."""


def require(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def bound(nbytes: float, flops: float, peak: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Wall time per call of reps back-to-back calls (CUDA events, warm):
    the device time, or the host's launch time where that is longer."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(torch, fn):
    """Device time of every kernel fn() launches, from torch.profiler:
    {kernel name: (total ms, count)}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = (us / 1e3, e.count)
    return out


def device_ms(torch, fn, reps: int):
    """(device ms, wall ms) per call: the summed device time of the
    kernels fn() launches (profiler), and cuda_ms's wall time.  When the
    profiler records no device time three times over, the device time is
    reported as the wall time (an upper bound) and a note is printed."""
    wall = cuda_ms(torch, fn, reps)

    def many():
        for _ in range(reps):
            fn()
    for _ in range(3):
        dev = sum(t for t, _ in kernel_times(torch, many).values()) / reps
        if dev > 0:
            return dev, wall
    print("  note: torch.profiler recorded no device time; wall time used")
    return wall, wall


def gru_inputs(torch, dev, n: int, b: int, h: int, seed: int):
    """Random GRU sequence inputs from a seed: ((x, h0, wih, bih, whh,
    bhh), dh_seq, dh_fin)."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    return ((rnd(n, b, h), rnd(b, h, scale=0.5),
             rnd(h, 3 * h, scale=h ** -0.5), rnd(3 * h, scale=0.1),
             rnd(h, 3 * h, scale=h ** -0.5), rnd(3 * h, scale=0.1)),
            rnd(n, b, h), rnd(b, h))


FWD_OUT = ("h_seq", "h_fin", "xg", "hg")
BWD_OUT = ("dx", "dh0", "dwih", "dbih", "dwhh", "dbhh")


def gru_bounds(n: int, b: int, h: int):
    """(fwd, bwd) bounds in ms with what bounds them.  Bytes count each
    input read once and each output written once (bf16 weights, x, h_seq,
    dh_seq and dx; float32 biases, states, residuals xg/hg and gradients);
    operations count the products, each 2*B*H*3H per step: 2 forward, 4
    backward (dx, dWih, dWhh and the carry; xg and hg are residuals)."""
    nbh, w, g3 = n * b * h, 2 * h * 3 * h, n * b * 3 * h
    fwd_bytes = (2 * nbh + 4 * b * h + 2 * w + 4 * 6 * h
                 + 2 * (nbh + b * h) + 4 * b * h + 4 * 2 * g3)
    bwd_bytes = (2 * nbh + 4 * b * h + 2 * w + 2 * (nbh + b * h)
                 + 4 * 2 * g3 + 2 * nbh + 4 * b * h
                 + 2 * nbh + 4 * b * h + 4 * w + 4 * 6 * h)
    prod = 2.0 * b * h * 3 * h
    return (bound(fwd_bytes, n * 2 * prod, PEAK_BF16),
            bound(bwd_bytes, n * 4 * prod, PEAK_BF16))


def check_gru_sequence(torch, dev, rt):
    """K4 against its plain versions on the card, timed at both flagship
    tiers.  Returns {"fwd"|"bwd": {"err", "rel_bf16", "ms", "plain",
    "bound", "lib", "by"}}: "err" from the float32 check, "rel_bf16" the
    worst bf16 error over max|plain| at the timed shapes, times averaged
    over the tiers (one launch of each per tier per train step); or
    raises SmokeFailure."""
    # float32, small: the same values up to the order of float32 sums
    args, dhs, dhf = gru_inputs(torch, dev, 6, 4, 128, 10)
    got = rt.gru_sequence_fwd(*args, "float32")
    want = rt.gru_sequence_fwd_plain(*args, "float32")
    errs = {"fwd": 0.0, "bwd": 0.0}
    for name, g, w in zip(FWD_OUT, got, want):
        err = (g - w).abs().max().item()
        errs["fwd"] = max(errs["fwd"], err)
        require(err <= 1e-5, f"gru_sequence_fwd f32 {name}: {err} > 1e-5")
    bargs = (args[0], args[1], args[2], args[4], want[0], want[2], want[3],
             dhs, dhf, "float32")
    for name, g, w in zip(BWD_OUT, rt.gru_sequence_bwd(*bargs),
                          rt.gru_sequence_bwd_plain(*bargs)):
        err = (g - w).abs().max().item()
        # dW sums B*N terms: 1e-5 of its largest value on top of 1e-5
        tol = 1e-5 + (1e-5 * w.abs().max().item() if name[:2] == "dw"
                      else 0.0)
        errs["bwd"] = max(errs["bwd"], err)
        require(err <= tol, f"gru_sequence_bwd f32 {name}: {err} > {tol}")
    print(f"K4 gru_sequence f32 [N=6, B=4, H=128]: forward max err "
          f"{errs['fwd']:.3g}, backward {errs['bwd']:.3g} (bound 1e-5; "
          "dW 1e-5 + 1e-5 * max|dW|)")
    stats = {d: {"err": errs[d], "rel_bf16": 0.0, "ms": 0.0, "plain": 0.0,
                 "bound": 0.0, "lib": 0.0, "by": {}} for d in ("fwd", "bwd")}
    for n in (64, 16):
        b, h = BATCH, 1024
        args, dhs, dhf = gru_inputs(torch, dev, n, b, h, 11 + n)
        got = rt.gru_sequence_fwd(*args, "bfloat16")
        want = rt.gru_sequence_fwd_plain(*args, "bfloat16")
        bargs = (args[0], args[1], args[2], args[4], want[0], want[2],
                 want[3], dhs, dhf, "bfloat16")
        gotb = rt.gru_sequence_bwd(*bargs)
        wantb = rt.gru_sequence_bwd_plain(*bargs)
        again = rt.gru_sequence_bwd(*bargs)
        torch.cuda.synchronize()
        # bf16: a float32 sum taken in another order can land on the other
        # side of a bf16 rounding boundary and move a stored value by one
        # ulp, which the recurrence carries on; the bound is two bf16 ulps
        # of each output's largest value, 2**-7 * max|want|
        rel = []
        for d, name, g, w in (
                [("fwd",) + o for o in zip(FWD_OUT, got, want)]
                + [("bwd",) + o for o in zip(BWD_OUT, gotb, wantb)]):
            r = ((g.float() - w.float()).abs().max()
                 / w.float().abs().max()).item()
            rel.append(f"{name} {r:.2g}")
            stats[d]["rel_bf16"] = max(stats[d]["rel_bf16"], r)
            require(r <= 2 ** -7, f"gru_sequence bf16 N={n} {name}: {r} "
                    "of max|want| > 2**-7")
        require(all(torch.equal(a, c) for a, c in zip(gotb, again)),
                "gru_sequence_bwd is not deterministic")
        fms, fwall = device_ms(torch, lambda: rt.gru_sequence_fwd(
            *args, "bfloat16"), 5)
        bms, bwall = device_ms(torch, lambda: rt.gru_sequence_bwd(*bargs), 5)
        fpl, _ = device_ms(torch, lambda: rt.gru_sequence_fwd_plain(
            *args, "bfloat16"), 1)
        bpl, _ = device_ms(torch, lambda: rt.gru_sequence_bwd_plain(*bargs),
                           1)
        # the yardstick: cuDNN's GRU (r, z, n; b_hn inside r*), weights
        # transposed, bf16; never called by the port
        x, h0, wih, bih, whh, bhh = args
        gru = torch.nn.GRU(h, h).to(dev, torch.bfloat16)
        with torch.no_grad():
            gru.weight_ih_l0.copy_(wih.T)
            gru.weight_hh_l0.copy_(whh.T)
            gru.bias_ih_l0.copy_(bih)
            gru.bias_hh_l0.copy_(bhh)
        gru.flatten_parameters()
        xl = x.to(torch.bfloat16).requires_grad_(True)
        h0l = h0.to(torch.bfloat16)[None]
        douts = [dhs.to(torch.bfloat16), dhf.to(torch.bfloat16)[None]]

        def lib_fwd():
            with torch.no_grad():
                return gru(xl, h0l)

        def lib_fwd_bwd():
            torch.autograd.backward(list(gru(xl, h0l)), douts)

        lib_err = (lib_fwd()[0].float() - got[0][1:].float()).abs().max()
        lf, _ = device_ms(torch, lib_fwd, 5)
        lfb, _ = device_ms(torch, lib_fwd_bwd, 5)
        (fb, fby), (bb, bby) = gru_bounds(n, b, h)
        print(f"K4 gru_sequence bf16 [N={n}, B={b}, H={h}]: "
              f"{', '.join(rel)} of max (bound 2**-7), deterministic; "
              f"forward {fms * 1e3:.1f} us (wall {fwall * 1e3:.1f} us), "
              f"plain {fpl * 1e3:.1f} us, cuDNN {lf * 1e3:.1f} us, bound "
              f"{fb * 1e3:.1f} us ({fby}); backward {bms * 1e3:.1f} us "
              f"(wall {bwall * 1e3:.1f} us), plain {bpl * 1e3:.1f} us, "
              f"cuDNN forward+backward {lfb * 1e3:.1f} us (backward share "
              f"{(lfb - lf) * 1e3:.1f} us), bound {bb * 1e3:.1f} us ({bby}; "
              f"the Pallas kernel's 6 products: "
              f"{n * 6 * 2.0 * b * h * 3 * h / PEAK_BF16 * 1e6:.1f} us); "
              f"cuDNN h_seq vs ours max {lib_err.item():.3g}")
        for d, ms, pl, lib, bd, by in (("fwd", fms, fpl, lf, fb, fby),
                                       ("bwd", bms, bpl, lfb - lf, bb, bby)):
            st = stats[d]
            for key, val in (("ms", ms), ("plain", pl), ("lib", lib),
                             ("bound", bd)):
                st[key] += val / 2
            st["by"][by] = st["by"].get(by, 0) + 1
    return stats


def train_path(torch, dev, cfg, params, card):
    """The flagship's TBPTT train step on the kernel route: 2 warm steps,
    5 timed; launch counts, NLL, the profiler split, and one step's NLL
    and gradients against the plain scan route.  Returns the K4 launch
    counts of the timed steps, or raises SmokeFailure."""
    import dataclasses
    import math

    from samplernn_pase_tpu_torch import graft_entry
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    from samplernn_pase_tpu_torch.train.trainer import make_train_step
    from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map

    b, t = BATCH, SEQ_LEN
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, cfg.q_levels, (b, cfg.lookback + t), generator=gen,
                      dtype=torch.int32).to(dev)
    y = x[:, cfg.lookback:]
    r = torch.zeros(b, device=dev)
    tx = make_optimizer(1e-3, 1.0)
    step = make_train_step(cfg, tx)
    p, opt = params, tx.init(params)
    hid = samplernn.initial_state(params, cfg, b)
    nlls = []
    t0 = time.perf_counter()
    for _ in range(2):
        p, opt, hid, nll = step(p, opt, hid, x, y, r)
        nlls.append(nll)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kdec.reset_launches()
    rt.reset_launches()
    t0 = time.perf_counter()
    for _ in range(5):
        p, opt, hid, nll = step(p, opt, hid, x, y, r)
        nlls.append(nll)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 5
    launches = dict(rt.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"train path launches in 5 steps: {launches}; decode kernels "
          f"{dict(kdec.LAUNCHES)}")
    require(launches == {"gru_sequence_fwd": 10, "gru_sequence_bwd": 10},
            f"K4 launches {launches}, expected 2 of each per step")
    nll_vals = [v.item() for v in nlls]
    print("train NLL per step (bits): " + ", ".join(
        f"{v:.4f}" for v in nll_vals))
    require(all(math.isfinite(v) for v in nll_vals), "non-finite NLL")
    require(nll_vals[-1] < nll_vals[0], "the NLL did not fall")
    # where a step's time goes
    times = kernel_times(torch, lambda: step(p, opt, hid, x, y, r))
    groups = {"gru_sequence (K4)": [0.0, 0], "library products": [0.0, 0],
              "other": [0.0, 0]}
    for key, (ms, cnt) in times.items():
        low = key.lower()
        g = ("gru_sequence (K4)" if "gruseq_" in low else
             "library products" if any(w in low for w in (
                 "gemm", "xmma", "cutlass", "conv", "cudnn", "wgrad",
                 "dgrad")) else "other")
        groups[g][0] += ms
        groups[g][1] += cnt
    busy = sum(ms for ms, _ in groups.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"profiled train step: device busy {busy:.2f} ms; idle share of "
          f"the unprofiled step {1 - busy / (step_s * 1e3):.3f}; "
          + ", ".join(f"{g} {ms:.2f} ms/{c}" for g, (ms, c) in
                      groups.items()))
    print("  top kernels: " + "; ".join(
        f"{k[:60]} {ms:.2f} ms/{c}" for k, (ms, c) in top))
    # orientation: the products of one step, 3x the forward's
    e, hd, f1 = cfg.embed_dim, cfg.dim, cfg.frame_sizes[0]
    fwd_flops = 2.0 * b * t * (f1 * e * hd + hd * hd + hd * cfg.q_levels)
    fwd_flops += 2.0 * b * (t + f1 - 1) * cfg.q_levels * e
    for k, span in enumerate(cfg.tier_spans):
        nf = t // span
        fwd_flops += 2.0 * b * nf * (span * hd + 2 * hd * 3 * hd
                                     + hd * cfg.frame_sizes[k] * hd)
    print(f"train step, flagship B={b}, seq_len {t}, kernel route: "
          f"{step_s * 1e3:.2f} ms per step ({warm:.2f} s for the 2 warm "
          f"steps), {b * t / f1 / step_s:,.0f} bottom frames/s, "
          f"{b * t / step_s:,.0f} samples/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB; products "
          f"{3 * fwd_flops / 1e12:.2f} TFLOP, bound "
          f"{3 * fwd_flops / PEAK_BF16 * 1e3:.2f} ms at {PEAK_BF16 / 1e12:.0f} "
          f"TFLOP/s; on {card}")

    # one step's NLL and gradients against the plain scan route
    def grads(c, p0=params):
        q = tree_map(lambda a: a.detach().requires_grad_(True), p0)
        nll, _ = samplernn.loss_fn(q, c, x, y,
                                   samplernn.initial_state(p0, c, b))
        g = torch.autograd.grad(nll, tree_leaves(q), allow_unused=True)
        return nll.item(), g

    def worst_rel(ga, gb):
        worst, where = 0.0, ""
        for i, (a, e) in enumerate(zip(ga, gb)):
            if e is None:
                continue
            rel = ((a.float() - e.float()).norm() / e.float().norm()).item()
            if rel > worst:
                worst, where = rel, f"leaf {i} {tuple(e.shape)}"
        return worst, where

    def compare(c):
        nk, gk = grads(c)
        np_, gp = grads(dataclasses.replace(c, pallas_train_rnn=False))
        return (nk, np_) + worst_rel(gk, gp)

    # float32: the reference's VJP is the exact gradient, so the routes
    # differ only in the order of float32 sums.  What that order can move
    # is the gradients' own conditioning: the scan route's gradients under
    # a relative perturbation of the params by 1e-7 * N(0, 1), float32
    # rounding's scale.  Bound: three times that floor
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    scan32 = dataclasses.replace(c32, pallas_train_rnn=False)
    pgen = torch.Generator(device=dev).manual_seed(9)
    nudged = tree_map(lambda a: a * (1 + 1e-7 * torch.randn(
        a.shape, device=dev, generator=pgen)), params)
    floor, fwhere = worst_rel(grads(scan32, nudged)[1], grads(scan32)[1])
    nk, np_, worst, where = compare(c32)
    print(f"kernel route vs plain scan route, one step, float32: NLL "
          f"{nk:.6f} vs {np_:.6f} bits (bound 1e-4); worst gradient "
          f"relative norm {worst:.2e} at {where}; the scan route's own "
          f"under a 1e-7 nudge of the params {floor:.2e} at {fwhere} "
          f"(bound 3x that)")
    require(abs(nk - np_) <= 1e-4, "float32 NLL differs from the scan route")
    require(worst <= 3 * floor,
            "a float32 gradient differs from the scan route by more than "
            "its conditioning allows")
    # bf16: the reference's VJP rounds h_{t-1}, dh_seq and the gate
    # gradients to bf16 (2**-9 relative each) where the scan's autograd
    # keeps float32, inside a 16- to 64-step chain; where a rounded
    # h_{t-1} enters the difference h_{t-1} - n and a gradient sums terms
    # that cancel, a whole gradient moves by a few percent (about 0.04 at
    # tier 1's W_hh of the flagship on an H100).  Bounds: NLL 0.01 bits,
    # each gradient 10% in relative norm; a wrong gradient is off by O(1)
    nk, np_, worst, where = compare(cfg)
    print(f"kernel route vs plain scan route, one step, bf16: NLL "
          f"{nk:.5f} vs {np_:.5f} bits (bound 0.01); worst gradient "
          f"relative norm {worst:.4f} at {where} (bound 0.1)")
    require(abs(nk - np_) <= 0.01, "NLL differs from the scan route")
    require(worst <= 0.1, "a gradient differs from the scan route")
    fn, eargs = graft_entry.entry()
    enll, _ = fn(*eargs)
    require(eargs[2].is_cuda and math.isfinite(enll.item()),
            "graft_entry.entry() did not give a finite NLL on the card")
    print(f"graft_entry.entry() on the card: NLL {enll.item():.4f} bits")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    if not (ROOT / "samplernn_pase_tpu_torch" / "ops" / "kernels").is_dir():
        return fail(f"the port (samplernn_pase_tpu_torch) is not beside "
                    f"{Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.config import SampleRNNConfig
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.kernels import _build
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.ops.kernels import megagen
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt

    dev = torch.device("cuda")
    kdec.plain_numerics()

    # ---- 1. the card and the build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} "
          "sources (parallel nvcc, sm_90a)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- flagship model (random weights from a seed) ----
    cfg = SampleRNNConfig(frame_sizes=(16, 4), dim=1024, embed_dim=256,
                          q_levels=256, n_rnn=1, rnn_type="gru",
                          compute_dtype="bfloat16")
    b, hdim, q, f1 = BATCH, cfg.dim, cfg.q_levels, cfg.frame_sizes[0]
    t0 = time.perf_counter()
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    weights = tgen.prepare_weights(params, cfg, dev)
    torch.cuda.synchronize()
    print(f"flagship params and kernel weights (prepared once per model): "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    t0w = time.perf_counter()

    # ---- 2a. K2 gemm_bias at the main path's shapes ----
    t0t, t1t = weights["tiers"]
    h = torch.randn(b, hdim, device=dev, generator=gen) * 0.5
    upper = torch.randn(b, hdim, device=dev, generator=gen)
    win = torch.randint(0, q, (b, cfg.lookback), device=dev,
                        generator=gen, dtype=torch.int32)
    x_gate = torch.randn(b, hdim, device=dev, generator=gen)
    # (name, a, w, bias, add, levels_q, launches per top frame)
    k2_cases = [
        ("tier0 input", win[:, -f1:], t0t["w_in"], t0t["b_in"], upper, q, 4),
        ("tier0 gate x", x_gate, t0t["w_ih"], t0t["b_ih"], None, 0, 4),
        ("tier0 gate h", h, t0t["w_hh"], t0t["b_hh"], None, 0, 4),
        ("tier0 upsample", h, t0t["w_up"], None, None, 0, 4),
        ("tier1 input", win, t1t["w_in"], t1t["b_in"], None, q, 1),
        ("tier1 gate x", x_gate, t1t["w_ih"], t1t["b_ih"], None, 0, 1),
        ("tier1 gate h", h, t1t["w_hh"], t1t["b_hh"], None, 0, 1),
        ("tier1 upsample", h, t1t["w_up"], t1t["b_up_flat"], None, 0, 1),
    ]
    k2 = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0,
          "n": 0, "by": {}}
    for name, a, w, bias, add, lq, per_top in k2_cases:
        got = kdec.gemm_bias(a, w, bias, add, levels_q=lq)
        want = kdec.gemm_bias_plain(a, w, bias, add, levels_q=lq)
        torch.cuda.synchronize()
        k = a.shape[1]
        af = (a.float() / (lq / 2) - 1) if lq else a
        scale = torch.matmul(af.to(w.dtype).float().abs(),
                             w.float().abs()).max().item()
        tol = 2 * k * 2.0 ** -24 * scale + 1e-6 * (1 + want.abs().max().item())
        err = (got - want).abs().max().item()
        ok = err <= tol
        ms, wall = device_ms(torch, lambda: kdec.gemm_bias(
            a, w, bias, add, levels_q=lq), 20)
        pms, _ = device_ms(torch, lambda: kdec.gemm_bias_plain(
            a, w, bias, add, levels_q=lq), 20)
        a_lib = af.to(w.dtype)
        bias_lib = (bias if bias is not None
                    else torch.zeros(w.shape[1], device=dev)).to(w.dtype)
        lms, _ = device_ms(torch, lambda: torch.addmm(bias_lib, a_lib, w),
                           20)
        m, n = b, w.shape[1]
        nbytes = (a.numel() * 4 + w.numel() * w.element_size()
                  + (n * 4 if bias is not None else 0)
                  + (m * n * 4 if add is not None else 0) + m * n * 4)
        bms, by = bound(nbytes, 2.0 * m * n * k, PEAK_BF16)
        print(f"K2 {name:15s} [{m},{k}]@[{k},{n}] err {err:.3g} "
              f"(bound {tol:.3g}) {ms * 1e3:.1f} us (wall per call "
              f"{wall * 1e3:.1f} us), plain "
              f"{pms * 1e3:.1f} us, addmm {lms * 1e3:.1f} us, bound "
              f"{bms * 1e3:.2f} us ({by})")
        if not ok:
            return fail(f"gemm_bias {name}: max abs err {err} > {tol}")
        k2["err"] = max(k2["err"], err)
        for key, val in (("ms", ms), ("plain", pms), ("lib", lms),
                         ("bound", bms)):
            k2[key] += val * per_top
        k2["n"] += per_top
        k2["by"][by] = k2["by"].get(by, 0) + per_top

    # ---- 2b. K3 gru_gates ----
    xg = torch.randn(b, 3 * hdim, device=dev, generator=gen)
    hg = torch.randn(b, 3 * hdim, device=dev, generator=gen)
    err3 = (kdec.gru_gates(xg, hg, h)
            - kdec.gru_gates_plain(xg, hg, h)).abs().max().item()
    if err3 > 2e-6:
        return fail(f"gru_gates: max abs err {err3} > 2e-6")
    ms3, wall3 = device_ms(torch, lambda: kdec.gru_gates(xg, hg, h), 50)
    pms3, _ = device_ms(torch, lambda: kdec.gru_gates_plain(xg, hg, h), 50)
    # the library's fused GRU cell: r, z, n in the same order,
    # h' = n + z * (h - n); timed as a yardstick, never called by the port
    lib_err3 = (torch.ops.aten._thnn_fused_gru_cell(xg, hg, h)[0]
                - kdec.gru_gates_plain(xg, hg, h)).abs().max().item()
    lms3, _ = device_ms(torch, lambda: torch.ops.aten._thnn_fused_gru_cell(
        xg, hg, h)[0], 50)
    b3, by3 = bound(4.0 * (2 * 3 * b * hdim + 2 * b * hdim),
                    12.0 * b * hdim, PEAK_F32)
    print(f"K3 gru_gates [{b},{hdim}] err {err3:.3g} (bound 2e-06) "
          f"{ms3 * 1e3:.1f} us (wall per call {wall3 * 1e3:.1f} us), "
          f"plain {pms3 * 1e3:.1f} us, _thnn_fused_gru_cell "
          f"{lms3 * 1e3:.1f} us (err {lib_err3:.3g}), bound "
          f"{b3 * 1e3:.2f} us ({by3})")

    # ---- 2c. K1 frame_decode: f32 small (equal), bf16 flagship (rescore)
    small = SampleRNNConfig(frame_sizes=(4, 2), dim=64, embed_dim=16,
                            compute_dtype="float32")
    sp = samplernn.init_params(torch.Generator().manual_seed(2), small, dev)
    smw = kdec.prepare_mlp(sp["mlp"], torch.float32, 4)
    swin = torch.randint(0, q, (8, 4), device=dev, generator=gen,
                         dtype=torch.int32)
    scond = torch.randn(8, 4 * 64, device=dev, generator=gen)
    snoise = torch.randn(4, 8, q, device=dev, generator=gen)
    err1 = 0
    for temp, noise in ((0.0, None), (0.9, None), (0.9, snoise)):
        got = kdec.frame_decode(swin, scond, None, smw, temp, noise, 3, 50)
        want = kdec.frame_decode_plain(swin, scond, None, smw, temp, noise,
                                       3, 50)
        err1 = max(err1, (got - want).abs().max().item())
        if not torch.equal(got, want):
            return fail(f"frame_decode f32 T={temp} supplied="
                        f"{noise is not None}: samples differ")
    # the f32 whole path, kernels against plain versions
    sw = torch.full((8, small.lookback), 128, dtype=torch.int32, device=dev)
    sst = samplernn.initial_state(sp, small, 8)
    for temp in (0.0, 0.9):
        got, gs = megagen.generate_full(sw, sst, temp, sp["tiers"],
                                        sp["mlp"], n_top=4,
                                        weights_dtype="float32", seed=4)
        want, ws = megagen.generate_full_plain(
            sw, sst, temp, sp["tiers"], sp["mlp"], n_top=4,
            weights_dtype="float32", seed=4)
        serr = max((x - y).abs().max().item() for x, y in zip(gs, ws))
        if not torch.equal(got, want) or serr > 1e-5:
            return fail(f"generate_full f32 T={temp}: samples differ or "
                        f"state err {serr} > 1e-5")
    print("K1/K2/K3 f32 small shapes: samples equal to the plain versions")

    mw = weights["mlp"]
    cond = kdec.gemm_bias(h, t0t["w_up"])
    fwin = win[:, -f1:]
    k1 = {}
    for temp in (0.0, 0.95):
        got = kdec.frame_decode(fwin, cond, t0t["b_up"], mw, temp, None, 7,
                                1000)
        again = kdec.frame_decode_plain(fwin, cond, t0t["b_up"], mw, temp,
                                        None, 7, 1000, forced=got)
        agree = (again == got).float().mean().item()
        k1[temp] = agree
        if agree < 0.99:
            return fail(f"frame_decode bf16 T={temp}: rescoring agreement "
                        f"{agree} < 0.99")
    ms1, wall1 = device_ms(torch, lambda: kdec.frame_decode(
        fwin, cond, t0t["b_up"], mw, 0.95, None, 7, 1000), 10)
    pms1, _ = device_ms(torch, lambda: kdec.frame_decode_plain(
        fwin, cond, t0t["b_up"], mw, 0.95, None, 7, 1000), 3)
    # bytes this frame's data needs: window, cond rows, b_up, the W' rows
    # its windows gather, W_h, W_out, biases, the output
    seq = torch.cat([fwin, got], dim=1).long()
    slots = torch.stack([seq[:, i:i + f1] for i in range(f1)])  # [i, B, j]
    rows = (torch.arange(f1, device=dev) * q + slots).unique().numel()
    nbytes1 = (b * f1 * 4 + b * f1 * hdim * 4 + f1 * hdim * 4
               + rows * hdim * 2 + (hdim * hdim + hdim * q) * 2
               + (2 * hdim + q) * 4 + b * f1 * 4)
    flops1 = 2.0 * b * f1 * (hdim * hdim + hdim * q)
    b1, by1 = bound(nbytes1, flops1, PEAK_BF16)
    print(f"K1 frame_decode [B={b}, f1={f1}] bf16 rescoring agreement "
          f"greedy {k1[0.0]:.4f} sampled {k1[0.95]:.4f}; "
          f"{ms1 * 1e3:.1f} us (wall per call {wall1 * 1e3:.1f} us), "
          f"plain {pms1 * 1e3:.1f} us, bound "
          f"{b1 * 1e3:.2f} us ({by1}, {rows} W' rows)")

    # ---- 2d. K4 gru_sequence forward and backward ----
    try:
        k4 = check_gru_sequence(torch, dev, rt)
    except SmokeFailure as err:
        return fail(str(err))
    print(f"phase 2 (kernel checks and timing): "
          f"{time.perf_counter() - t0w:.1f} s")

    # ---- 3. the generation path at full width ----
    kdec.reset_launches()
    t0 = time.perf_counter()
    greedy = tgen.generate_levels(params, cfg, b, LENGTH, None, seed=0,
                                  device=dev, kernel_weights=weights)
    torch.cuda.synchronize()
    t_greedy = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampled = tgen.generate_levels(params, cfg, b, LENGTH, 0.95, seed=1,
                                   device=dev, kernel_weights=weights)
    torch.cuda.synchronize()
    t_sampled = time.perf_counter() - t0
    frame = tgen.make_generator(cfg, b, LENGTH, 0.95, use_kernels="frame",
                                device=dev)(params, seed=1)
    torch.cuda.synchronize()
    launches = dict(kdec.LAUNCHES)
    print(f"main path launches: {launches}")
    if not all(launches.values()):
        return fail(f"a kernel was not launched on the main path: {launches}")
    for name, lv in (("greedy", greedy), ("sampled", sampled),
                     ("frame", frame)):
        if lv.shape != (b, LENGTH) or lv.dtype != torch.int32:
            return fail(f"{name}: shape {tuple(lv.shape)} {lv.dtype}")
        if lv.min().item() < 0 or lv.max().item() >= q:
            return fail(f"{name}: levels outside [0, {q})")
    if not torch.equal(frame, sampled):
        return fail("make_generator(use_kernels='frame') differs from the "
                    "same sampled request through generate_levels")
    agree_g = tgen.rescore(params, cfg, greedy, None, seed=0)
    agree_s = tgen.rescore(params, cfg, sampled, 0.95, seed=1)
    print(f"rescoring agreement (plain per-step modules, bf16): greedy "
          f"{agree_g:.4f}, sampled {agree_s:.4f}; make_generator's "
          "request equal to generate_levels'")
    if min(agree_g, agree_s) < 0.99:
        return fail("rescoring agreement below 0.99")
    # where the time goes: one more sampled request under the profiler
    t0 = time.perf_counter()
    times = kernel_times(torch, lambda: tgen.generate_levels(
        params, cfg, b, LENGTH, 0.95, seed=1, device=dev,
        kernel_weights=weights))
    wall = (time.perf_counter() - t0) * 1e3
    groups = {"frame_decode": [0.0, 0], "gemm_bias": [0.0, 0],
              "gru_gates": [0.0, 0], "other": [0.0, 0]}
    for key, (t, cnt) in times.items():
        g = next((g for g in groups if g in key), "other")
        groups[g][0] += t
        groups[g][1] += cnt
    busy = sum(t for t, _ in groups.values())
    print(f"profiled sampled request: wall {wall:.1f} ms (profiler on), "
          f"device busy {busy:.1f} ms, idle share {1 - busy / wall:.3f} "
          f"(profiler on), {1 - busy / (t_sampled * 1e3):.3f} of the "
          f"unprofiled request's {t_sampled * 1e3:.1f} ms; "
          + ", ".join(f"{g} {t:.1f} ms/{c}" for g, (t, c) in
                      groups.items()))
    n = b * LENGTH
    print(f"whole-generation route, B={b}, {LENGTH} samples: greedy "
          f"{n / t_greedy:,.0f} samples/s ({t_greedy:.3f} s), sampled "
          f"{n / t_sampled:,.0f} samples/s ({t_sampled:.3f} s) on {card}")

    # ---- 4. the training path at full width ----
    t0 = time.perf_counter()
    try:
        k4_launches = train_path(torch, dev, cfg, params, card)
    except SmokeFailure as err:
        return fail(str(err))
    print(f"phase 4 (training path): {time.perf_counter() - t0:.1f} s")

    # ---- 5. the result lines ----
    k2n = k2["n"]
    line = {"kernels": [
        {"name": "frame_decode", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/frame_decode.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/decode.py:218",
         "launches": launches["frame_decode"], "max_abs_err": err1,
         "ms": ms1, "plain_ms": pms1, "bound_ms": b1, "bound_by": by1,
         "library_ms": None},
        {"name": "gemm_bias", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/gemm_bias.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/megagen.py:496",
         "launches": launches["gemm_bias"], "max_abs_err": k2["err"],
         "ms": k2["ms"] / k2n, "plain_ms": k2["plain"] / k2n,
         "bound_ms": k2["bound"] / k2n,
         "bound_by": max(k2["by"], key=k2["by"].get),
         "library_ms": k2["lib"] / k2n},
        {"name": "gru_gates", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/gru_gates.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/decode.py:153",
         "launches": launches["gru_gates"], "max_abs_err": err3,
         "ms": ms3, "plain_ms": pms3, "bound_ms": b3, "bound_by": by3,
         "library_ms": lms3},
    ] + [
        {"name": f"gru_sequence_{d}", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/"
                   "gru_sequence.cu",
         "replaces": f"samplernn_pase_tpu/ops/pallas/rnn_train.py:{line}",
         "launches": k4_launches[f"gru_sequence_{d}"],
         "max_abs_err": k4[d]["err"],
         "max_abs_err_at": "float32 N=6 B=4 H=128",
         "max_rel_err_bf16": k4[d]["rel_bf16"],
         "max_rel_err_bf16_at": "bfloat16 N=64 and N=16, B=128, H=1024 "
                                "(the timed shapes), of max|plain|",
         "ms": k4[d]["ms"],
         "plain_ms": k4[d]["plain"], "bound_ms": k4[d]["bound"],
         "bound_by": max(k4[d]["by"], key=k4[d]["by"].get),
         "library_ms": k4[d]["lib"]}
        for d, line in (("fwd", 137), ("bwd", 156))
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
