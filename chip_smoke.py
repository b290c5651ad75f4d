#!/usr/bin/env python3
"""Drive the PyTorch port's generation and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. the card: its name and power limit (nvidia-smi), then one nvcc build
   per CUDA source under samplernn_pase_tpu_torch/ops/kernels/csrc, all
   started together, into build/torch_kernels/;
2. each kernel against its plain PyTorch version on the card, at the
   main paths' shapes in bf16 and at a small float32 shape (K2 at every
   distinct product of both decode paths, the flagship's and config 2's,
   its entry in the kernels line weighted by each product's launches,
   each product's split plan printed beside its time; rows of M=1 and
   M=5 calls bit-equal to the same rows of the full-batch call; K2's
   epilogue terms timed one at a time by scripts/gemm_ablation.py),
   and timed beside its plain version, its bound and one library call
   computing the same function (K2: torch.addmm; K3:
   aten._thnn_fused_gru_cell; K4/K5: cuDNN's GRU/LSTM through
   torch.nn.GRU/LSTM, its forward, forward + backward and backward share
   (the difference, the backward kernel's library_ms), with each K4/K5
   launch's device time (input product, chain, dX, dWih, dWhh) and the
   chain's us per step from scripts/seq_split.py; K6:
   aten._thnn_fused_lstm_cell, with its route and an empty kernel on its
   grid, the launch floor, beside it);
3. the flagship's generation at full width (2-tier GRU, frame_sizes
   (16, 4), dim 1024, embed 256, q 256, bf16) with random weights from a
   seed and its kernel weights prepared once, B=128: generate_levels
   greedy and sampled (T=0.95), and one sampled request through
   make_generator(use_kernels="frame"), which must equal the sampled one.
   Every decode kernel of the path must launch, levels must lie in
   [0, 256), and rescoring the emitted history through the plain
   per-step modules must agree on >= 0.99 of the samples; then one
   sampled request at bench.py's 16,384 samples (B=128, T=0.95, exact
   launch counts), timed in samples/s;
4. the flagship's TBPTT train step (make_train_step, make_optimizer(1e-3,
   1.0)) at B=128, seq_len 1024 on random levels from a seed, 2 warm
   steps then 5 timed.  Both K4 kernels must launch twice per step (one
   per tier), the NLL must be finite and fall, and one step through the
   plain scan route (pallas_train_rnn=False) must agree in NLL and
   gradients, in float32 and in bf16; then graft_entry.entry() on the card;
5. config 2's generation (configs/c2_3tier_lstm.json: 3-tier LSTM,
   frame_sizes (16, 4, 4), dim 1024, bf16) with random weights from a
   seed, B=128, 4,096 samples: greedy and sampled at the config's T=1.0,
   and one make_generator(use_kernels="frame") request equal to the
   sampled one, through K1, K2 and K6 (K1, K2 and K6 launch counts checked),
   rescoring >= 0.99 on the first 1,024 samples;
6. config 2's TBPTT training at B=64, seq_len 1024 through
   make_multi_train_step at the config's steps_per_call=8 (one warm call,
   one timed): K5 forward and backward launch 3 times per step (one per
   tier), the NLL is finite and falls, and one step agrees with the scan
   route as in phase 4;
7. config 4's conditioned generation (configs/c4_tts_conditioned.json:
   2-tier GRU, frame_sizes (16, 4), dim 1024, cond_dim 256, cond_rate
   160, bf16) with random weights and random cond rows from a seed, B=128,
   4,096 samples: one sampled request with per-lane cond positions (phases
   spread over 0..159), lane keys and noise positions at the config's
   T=1.0, the same request greedy, a shared-seed request and the same
   through make_generator(conditioned=True, use_kernels="frame"), which
   must be equal, and the per-lane request split into 4 calls, which must
   equal it bit for bit; exact K1, K2 (and its conditioning mode), K3 and
   K1 lane-key launch counts; rescoring >= 0.99 on the first 1,024
   samples;
8. config 4 stream serving: StreamPool(n_lanes=128, T=1.0), 8 chunks of
   1,024 samples with joins, stops, slot reuse and extend_cond between
   them; exact launch counts; four lanes bit-equal to solo B=1
   StreamingGenerators on the card; the last chunk's levels through K7's
   decode at [128, 1024], bit-equal to the plain decode, and its time;
   per-chunk wall time, samples/s and the device's idle share;
9. the stacked flagship (configs/c5_gen_b128.json's model with n_rnn=2
   and weight norm, built here): generate_levels greedy and sampled
   (T=0.95) at B=128, 1,024 samples, one make_generator(use_kernels=
   "frame") request equal to the sampled one, exactly 44 launches per top
   frame (counted per kernel), rescoring >= 0.99, generate() to a
   waveform through K7's decode (equal to the plain decode, K7's encode
   taking it back to the levels); then a StreamPool of 128 lanes over 2
   chunks, two lanes bit-equal to solo B=1 streams;
10. the stacked flagship's train step at B=128, seq_len 1024 (2 warm, 5
   timed): K4 forward and backward 4 times per step (2 tiers x 2
   layers), a finite falling NLL, one step against the scan route as in
   phase 4;
11. the roofline entry point (samplernn_pase_tpu_torch.scripts.
   vpu_ceiling), K8's and K9's own path: K8, K9 and the flagship's
   generation timed per step;
12. config 4 through Trainer.run (the model and the train section of
   configs/c4_tts_conditioned.json: B=32, seq_len 1280, steps_per_call 8,
   bf16) for 2 epochs on a corpus written to disk from a seed (80 wavs of
   sines by synthetic_corpus's recipe with ragged tails, a .npy of random
   cond rows per wav, read back by WavCorpus.from_folder through the
   native library: 20 steps an epoch, 2 groups and a 4-step tail; about 6
   wavs held out), with LoggerPlugin, ValidationPlugin (every 16 steps
   and at each epoch's end), CheckpointPlugin (every 8 steps) and a
   GeneratorPlugin that fires once (2 conditioned sequences of 16,000
   samples at T=1.0 on the kernel route, read back through audio_io).
   K4 forward launches twice per train and val step and backward twice
   per train step, the generation's K1/K2/K3/K7 launches are exact, the
   NLL is finite and falls, the val lines are held-out, the retention
   keeps the latest 3 and the best, and the data never left the native
   route; steps 10-12 are traced (device busy, idle share); step ms,
   bottom frames/s, peak memory and the host's time by part are
   printed.  A fresh Trainer then restores the second epoch's mid-epoch
   checkpoint and runs to the epoch's end: its steps, batch indices,
   NLLs, parameters, hiddens and Adam moments equal the uninterrupted
   run's bit for bit;
13. the quality smoke's full mode (python -m samplernn_pase_tpu_torch.
   scripts.quality_smoke: dim 512, bf16, two speakers), which must print
   OK;
14. the bench twins, python -m samplernn_pase_tpu_torch.bench and python
   -m samplernn_pase_tpu_torch.scripts.bench_train, each in its own
   process: their JSON lines, with a positive value and no skip;
15. config 3's extraction (configs/c3_pase_extract.json's encoder: 64
   sinc filters of 251 taps, 7 blocks, emb 256, decimation 160, bf16;
   random weights from a seed) through extract_to_dir at batch 16 over
   phase 12's wavs, rewritten from its seed into two speaker folders:
   each .npy len // 160 rows of 256, finite, in the mirrored tree; one
   batch in float32 on the card (TF32 off) within 1e-4 of the CPU's in
   relative norm, bf16 within 0.05 of float32; seconds of audio embedded
   per second and the convolutions' time per batch;
16. config 4 through JointTrainer.run (its model, pase and train
   sections: B=32, seq_len 1280, steps_per_call 8, bf16) for 2 epochs
   over those wavs, with phase 12's plugins and checks (the
   GeneratorPlugin conditioned through generation_cond): K4 as in phase
   12, K7 decode once per train and val step and twice for the
   generation, the encoder's parameters and BatchNorm state trained
   (count = train steps), a resume bit-equal to the uninterrupted run
   (both halves, BatchNorm state, hiddens, Adam); K7 at joint_cond's
   strided [32, 1280] view bit-equal to its plain version; one joint step
   against the scan route as in phase 4; the encoder's share of a step
   and the cost of its deterministic convolutions;
17. serve.run_jobs with config 4's model on 128 lanes at T=1.0, chunks
   of 1,024: 200 jobs conditioned on phase 15's embeddings at their
   natural length (4 with a stream_key, 4 continuing a prompt),
   retain_results=False: every length, on_done once per job, exact
   launch counts, each waveform through K7's decode (equal to the plain
   decode), the pinned jobs bit-equal to solo B=1 streams, 16 jobs equal
   with enqueue_ahead on and off, a bad manifest raising before any job;
   wall time, samples/s, utilization, idle share and host syncs a chunk;
18. the bench_pool twin (python -m samplernn_pase_tpu_torch.scripts.
   bench_pool) in its own process: its 8 rows, positive, no skip;
19. config 4's TTS pipeline through the command line
   (samplernn_pase_tpu_torch.cli.main with --platform cuda, in this
   process, over phase 15's wavs): extract with the default encoder
   (config 3's); train --joint with configs/c4_tts_conditioned.json for
   one epoch, then --resume to two (config.json, "resumed at step N",
   the logged steps, a falling NLL, exact K4 and K7 launches); evaluate
   on val, also in its own process (equal JSON), and on train at full
   batch and at batch 1 (coverage 1.0, NLLs within 1e-3 bits, host syncs
   a batch in sync debug mode); extract --ckpt; generate at the config's
   128 x 16,000 conditioned on a wav (exact launches) and 4 greedy lanes
   continuing a seed wav (equal to each other and to one lane primed and
   generated in process); stream with --stream-key 7 enqueue-ahead,
   --blocked and at 2 chunks a call (bit-equal, and equal to a
   StreamPool lane started with the same words); serve over the
   extracted embeddings on 128 lanes (each job's length, exact launches)
   and a mixed manifest (its stream_key 7 job equal to the stream), and
   a bad manifest exiting before any wav;
20. the mesh on the card: (a) a one-rank NCCL mesh in this process, the
   float32 flagship through Trainer.run with mesh= equal to mesh=None
   within 1e-5; (b) two ranks sharing the card over gloo
   (parallel.launch.run_ranks, a deadline on the ranks; a rank's failure
   fails the phase): the flagship's train step at B=128, 64 a rank
   (float32 at dim 64 within 1e-5, bf16 at full width within phase 4's
   bars, K4 twice a step on each rank, its steps timed), the same step on
   a (1, 2) (data, model) mesh with the MLP split 512/512, config 4
   through JointTrainer.run for one epoch at B=32 (per-step NLLs within
   0.01 bits of the unsharded run, BatchNorm state equal on both ranks),
   run_jobs on 128 lanes over 64 jobs of phase 17's kind, greedy and with
   pinned keys (bit-equal to the unsharded run, exact K1 lane-key
   launches on each rank), and cli.main(["train", "--joint", ...]) on
   both ranks over the group this script made; each part's wall time
   (the two-rank times measure gloo's staging through the host, not
   scaling);
21. the bench_host and perf_floor twins and the four examples, each in
   its own process (its launches counted by a wrapper): each prints its
   line with no skip, bench_host's native gather at over 4x the card's
   step rate, and perf_floor exits 0 (every floor holds);
22. a {"kernels": [...]} line (launch counts over phases 3-21's main
   paths), which fails the run if any entry, or any by_path or
   projection sub-entry, reads faster than its bound_ms; then the last
   line {"ok": true, "device": {"platform": "gpu", ...}}.

Phase 2 also holds config 4's kernel modes against their plain versions:
K2's conditioning epilogue at both tier inputs (exact against K2 without
it plus the selected row, at positions that take and skip the two-row
bump) and at the projection of the cond rows, and K1's per-lane-key noise
(mode 3), with lane batch independence; K2 at the stacked flagship's
products; K7 (codec) bit for bit against its plain version on the card
(and decode within 3 ulp of the CPU's; levels outside [0, q); views
misaligned for 16-byte accesses), timed at [128, 16384] and [128, 1024]
with the L2 warm and cold beside the empty kernel on its grid and a bound
reckoned from its compiled item loop, K8 (vpu_tail) with equal samples
and K9 (mxu_stream) within 2**-7 of its largest value, each timed beside
its bound; and, float32 at small width, stacked generate_full against its
plain twin and the kernel route against the plain route on a 1-tier, a
4-tier and an f1=1 model.

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
C2_LENGTH = 4096        # samples per config-2 request: 16 top frames
C2_RESCORE = 1024       # samples of it rescored through the plain modules
C4_LENGTH = 4096        # samples per config-4 request: 64 top frames
C4_RESCORE = 1024
C4_ROWS = 512           # cond rows per lane of a config-4 request
C4_CHUNK = 1024         # pool chunk: 64 ms of 16 kHz audio
C4_CHUNKS = 8
BENCH_LENGTH = 16384    # bench.py's request length


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


def kernel_name(mangled: str) -> str:
    """The kernel's own name in a mangled symbol of the kernels'
    anonymous namespace (_ZN<len><namespace><len><name>...)."""
    import re
    m = re.match(r"_ZN(\d+)", mangled)
    if m:
        rest = mangled[m.end() + int(m.group(1)):]
        n = re.match(r"(\d+)", rest)
        if n:
            return rest[n.end():n.end() + int(n.group(1))]
    return mangled[:60]


def kernel_group(key: str, groups) -> str:
    """The group of a profiled kernel: the first group name in its name
    (K2's bf16 route runs as the skinny core's kernel), else "other"."""
    if "skinny_gemm" in key:
        key = "gemm_bias"
    return next((g for g in groups if g in key), "other")


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
    kernels fn() launches (gemm_ablation.device_us: torch.profiler, a
    trace with no device time taken again), and cuda_ms's wall time.  When
    the profiler records no device time three times over, the device time
    is reported as the wall time (an upper bound) and a note is printed."""
    from samplernn_pase_tpu_torch.scripts.gemm_ablation import device_us
    wall = cuda_ms(torch, fn, reps)
    try:
        return device_us(fn, reps) / 1e3, wall
    except RuntimeError:
        print("  note: torch.profiler recorded no device time; wall time used")
        return wall, wall


# The sequence kernels: K4 (GRU, the flagship's tiers: N = 64 and 16 at
# B=128) and K5 (LSTM, config 2's tiers: N = 64, 16 and 4 at B=64).  The
# forward results and the backward's in the order the wrappers return
# them; "pallas" the lines of the pallas_calls they replace.
SEQ = {
    "gru": dict(kernel="K4", gates=3, states=1, residuals=2,
                fwd_out=("h_seq", "h_fin", "xg", "hg"),
                bwd_out=("dx", "dh0", "dwih", "dbih", "dwhh", "dbhh"),
                pallas=(137, 156)),
    "lstm": dict(kernel="K5", gates=4, states=2, residuals=1,
                 fwd_out=("h_seq", "c_seq", "h_fin", "c_fin", "g"),
                 bwd_out=("dx", "dh0", "dc0", "dwih", "dbih", "dwhh",
                          "dbhh"),
                 pallas=(325, 346)),
}


def seq_args(torch, dev, rt, cell: str, n: int, b: int, h: int, seed: int,
             dtype: str):
    """Random inputs from a seed for K4 or K5: (forward args, backward
    args built on the plain forward's residuals, the plain forward's
    results, (x, h0, c0, wih, bih, whh, bhh), the output gradients)."""
    gen = torch.Generator().manual_seed(seed)
    g = SEQ[cell]["gates"]

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    x, h0, c0 = rnd(n, b, h), rnd(b, h, scale=0.5), rnd(b, h, scale=0.5)
    wih, bih = rnd(h, g * h, scale=h ** -0.5), rnd(g * h, scale=0.1)
    whh, bhh = rnd(h, g * h, scale=h ** -0.5), rnd(g * h, scale=0.1)
    dhs, dhf, dcf = rnd(n, b, h), rnd(b, h), rnd(b, h)
    if cell == "gru":
        fargs = (x, h0, wih, bih, whh, bhh, dtype)
        want = rt.gru_sequence_fwd_plain(*fargs)
        bargs = (x, h0, wih, whh, want[0], want[2], want[3], dhs, dhf, dtype)
        douts = (dhs, dhf)
    else:
        fargs = (x, h0, c0, wih, bih, whh, bhh, dtype)
        want = rt.lstm_sequence_fwd_plain(*fargs)
        bargs = (x, c0, wih, whh, want[0], want[1], want[4], dhs, dhf, dcf,
                 dtype)
        douts = (dhs, dhf, dcf)
    return fargs, bargs, want, (x, h0, c0, wih, bih, whh, bhh), douts


def seq_bounds(cell: str, n: int, b: int, h: int):
    """(fwd, bwd) bounds in ms with what bounds them.  Bytes count each
    input read once and each output written once: bf16 weights, x, the
    stored sequences (h_seq, and c_seq for K5), dh_seq and dx; float32
    biases, states, residuals (K4: xg and hg; K5: g) and gradients.
    Operations count the products, each 2*B*H*gates*H per step: 2
    forward, 4 backward (dx, dWih, dWhh and the carry; the gates are
    residuals, not recomputed)."""
    sp = SEQ[cell]
    g, st, res = sp["gates"], sp["states"], sp["residuals"]
    nbh, w = n * b * h, 2 * h * g * h
    fwd_bytes = (2 * nbh + 4 * st * b * h + 2 * w + 4 * 2 * g * h
                 + 2 * (nbh + b * h) + 2 * (st - 1) * nbh + 4 * st * b * h
                 + 4 * res * nbh * g)
    bwd_bytes = (2 * nbh + 4 * b * h + 2 * w + 2 * (nbh + b * h)
                 + 2 * (st - 1) * nbh + 4 * res * nbh * g + 2 * nbh
                 + 4 * st * b * h + 2 * nbh + 4 * st * b * h + 4 * w
                 + 4 * 2 * g * h)
    prod = 2.0 * b * h * g * h
    return (bound(fwd_bytes, n * 2 * prod, PEAK_BF16),
            bound(bwd_bytes, n * 4 * prod, PEAK_BF16))


def check_sequence(torch, dev, rt, cell: str, b: int, tiers, h: int):
    """K4 ("gru") or K5 ("lstm") against its plain versions on the card:
    float32 at [N=6, B=4, H=128], then bf16 at the main path's tiers
    (N in tiers, batch b, width h), each timed.  Returns {"fwd"|"bwd":
    {"err", "rel_bf16", "ms", "plain", "bound", "lib", "by"}}: "err" from
    the float32 check, "rel_bf16" the worst bf16 error over max|plain|,
    times averaged over the tiers (one launch of each per tier per train
    step); or raises SmokeFailure."""
    from samplernn_pase_tpu_torch.scripts import seq_split
    sp = SEQ[cell]
    name = f"{cell}_sequence"
    fwd, bwd = getattr(rt, f"{name}_fwd"), getattr(rt, f"{name}_bwd")
    bwd_plain = getattr(rt, f"{name}_bwd_plain")
    tag = f"{sp['kernel']} {name}"
    # float32, small: the same values up to the order of float32 sums
    fargs, bargs, want, _, _ = seq_args(torch, dev, rt, cell, 6, 4, 128, 10,
                                        "float32")
    errs = {"fwd": 0.0, "bwd": 0.0}
    for out, g, w in zip(sp["fwd_out"], fwd(*fargs), want):
        err = (g - w).abs().max().item()
        errs["fwd"] = max(errs["fwd"], err)
        require(err <= 1e-5, f"{name}_fwd f32 {out}: {err} > 1e-5")
    for out, g, w in zip(sp["bwd_out"], bwd(*bargs), bwd_plain(*bargs)):
        err = (g - w).abs().max().item()
        # dW and db sum B*N terms: 1e-5 of their largest value on top
        tol = 1e-5 + (1e-5 * w.abs().max().item() if out[:2] in ("dw", "db")
                      else 0.0)
        errs["bwd"] = max(errs["bwd"], err)
        require(err <= tol, f"{name}_bwd f32 {out}: {err} > {tol}")
    print(f"{tag} f32 [N=6, B=4, H=128]: forward max err "
          f"{errs['fwd']:.3g}, backward {errs['bwd']:.3g} (bound 1e-5; "
          "dW, db 1e-5 + 1e-5 * max)")
    stats = {d: {"err": errs[d], "rel_bf16": 0.0, "ms": 0.0, "plain": 0.0,
                 "bound": 0.0, "lib": 0.0, "by": {}} for d in ("fwd", "bwd")}
    for n in tiers:
        fargs, bargs, want, ins, douts = seq_args(
            torch, dev, rt, cell, n, b, h, 11 + n, "bfloat16")
        got = fwd(*fargs)
        gotb = bwd(*bargs)
        wantb = bwd_plain(*bargs)
        again = [bwd(*bargs) for _ in range(2)]
        torch.cuda.synchronize()
        # bf16: a float32 sum taken in another order can land on the other
        # side of a bf16 rounding boundary and move a stored value by one
        # ulp, which the recurrence carries on; the bound is two bf16 ulps
        # of each output's largest value, 2**-7 * max|want|
        rel = []
        for d, out, g, w in (
                [("fwd",) + o for o in zip(sp["fwd_out"], got, want)]
                + [("bwd",) + o for o in zip(sp["bwd_out"], gotb, wantb)]):
            r = ((g.float() - w.float()).abs().max()
                 / w.float().abs().max()).item()
            rel.append(f"{out} {r:.2g}")
            stats[d]["rel_bf16"] = max(stats[d]["rel_bf16"], r)
            require(r <= 2 ** -7, f"{name} bf16 N={n} {out}: {r} of "
                    "max|want| > 2**-7")
        require(all(torch.equal(a, c) for run in again
                    for a, c in zip(gotb, run)),
                f"{name}_bwd is not deterministic over three runs")
        fms, fwall = device_ms(torch, lambda: fwd(*fargs), 5)
        bms, bwall = device_ms(torch, lambda: bwd(*bargs), 5)
        # each launch's device time: the input product and the chain
        # forward; the chain, dX, dWih and dWhh backward
        fsplit = seq_split.split(seq_split.kernel_events(
            torch, lambda: fwd(*fargs)), seq_split.FWD_ROLES)
        bsplit = seq_split.split(seq_split.kernel_events(
            torch, lambda: bwd(*bargs)), seq_split.BWD_ROLES)
        fpl, _ = device_ms(torch, lambda: getattr(
            rt, f"{name}_fwd_plain")(*fargs), 1)
        bpl, _ = device_ms(torch, lambda: bwd_plain(*bargs), 1)
        # the yardstick: cuDNN's GRU (r, z, n; b_hn inside r*) or LSTM
        # (i, f, g, o), weights transposed, bf16; never called by the port
        x, h0, c0, wih, bih, whh, bhh = ins
        lib = (torch.nn.GRU if cell == "gru" else torch.nn.LSTM)(h, h).to(
            dev, torch.bfloat16)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(wih.T)
            lib.weight_hh_l0.copy_(whh.T)
            lib.bias_ih_l0.copy_(bih)
            lib.bias_hh_l0.copy_(bhh)
        lib.flatten_parameters()
        xl = x.to(torch.bfloat16).requires_grad_(True)
        s0 = h0.to(torch.bfloat16)[None]
        if cell == "lstm":
            s0 = (s0, c0.to(torch.bfloat16)[None])
        dl = [d.to(torch.bfloat16) if i == 0 else d.to(torch.bfloat16)[None]
              for i, d in enumerate(douts)]

        def outs(out):
            seq, fin = out
            return [seq] + (list(fin) if cell == "lstm" else [fin])

        def lib_fwd():
            with torch.no_grad():
                return lib(xl, s0)

        def lib_fwd_bwd():
            torch.autograd.backward(outs(lib(xl, s0)), dl)

        lib_err = (lib_fwd()[0].float() - got[0][1:].float()).abs().max()
        lf, _ = device_ms(torch, lib_fwd, 5)
        lfb, _ = device_ms(torch, lib_fwd_bwd, 5)
        (fb, fby), (bb, bby) = seq_bounds(cell, n, b, h)
        g = sp["gates"]
        print(f"{tag} bf16 [N={n}, B={b}, H={h}]: "
              f"{', '.join(rel)} of max (bound 2**-7), deterministic; "
              f"forward {fms * 1e3:.1f} us (wall {fwall * 1e3:.1f} us), "
              f"plain {fpl * 1e3:.1f} us, cuDNN forward {lf * 1e3:.1f} us, "
              f"bound {fb * 1e3:.1f} us ({fby}); backward {bms * 1e3:.1f} "
              f"us (wall {bwall * 1e3:.1f} us), plain {bpl * 1e3:.1f} us, "
              f"cuDNN forward + backward {lfb * 1e3:.1f} us, cuDNN backward "
              f"share {(lfb - lf) * 1e3:.1f} us, bound {bb * 1e3:.1f} us "
              f"({bby}; the Pallas kernel's 6 products: "
              f"{n * 6 * 2.0 * b * h * g * h / PEAK_BF16 * 1e6:.1f} us); "
              f"cuDNN h_seq vs ours max {lib_err.item():.3g}")
        print(f"  {tag} launches, us: forward "
              + ", ".join(f"{k} {v:.1f}" for k, v in fsplit.items())
              + f" (chain {fsplit['chain'] / n:.2f} us/step); backward "
              + ", ".join(f"{k} {v:.1f}" for k, v in bsplit.items())
              + f" (chain {bsplit['chain'] / n:.2f} us/step); plan "
              f"{tuple(rt.chain_plan(cell, h, b)[:5])}")
        for d, ms, pl, lb, bd, by in (("fwd", fms, fpl, lf, fb, fby),
                                      ("bwd", bms, bpl, lfb - lf, bb, bby)):
            st = stats[d]
            for key, val in (("ms", ms), ("plain", pl), ("lib", lb),
                             ("bound", bd)):
                st[key] += val / len(tiers)
            st["by"][by] = st["by"].get(by, 0) + 1
    return stats


def profile_step(torch, fn, step_s: float):
    """Where one train step's device time goes (torch.profiler): the
    sequence kernels (K4/K5, their GEMMs included), the library products
    and the rest, with the idle share of an unprofiled step of step_s."""
    times = kernel_times(torch, fn)
    seq = "sequence kernels (K4/K5)"
    groups = {seq: [0.0, 0], "library products": [0.0, 0],
              "other": [0.0, 0]}
    for key, (ms, cnt) in times.items():
        low = key.lower()
        g = (seq if "seq_" in low else
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


def check_routes(torch, dev, cfg, params, x, y, loss=None):
    """One step's NLL and gradients on the kernel route against the plain
    scan route (pallas_train_rnn=False), in float32 and in bf16; raises
    SmokeFailure beyond the bounds below.  ``loss(q, c)``, the step's NLL
    of params q under model config c, defaults to the model's own from h0
    on (x, y)."""
    import dataclasses

    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map

    b = x.shape[0]

    def grads(c, p0=params):
        q = tree_map(lambda a: a.detach().requires_grad_(True), p0)
        nll = (loss(q, c) if loss is not None else samplernn.loss_fn(
            q, c, x, y, samplernn.initial_state(p0, c, b))[0])
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
    # bf16: the reference's VJPs round h_{t-1}, dh_seq and the gate
    # gradients (and K5's c_seq) to bf16 (2**-9 relative each) where the
    # scan's autograd keeps float32, inside a chain of up to 64 steps;
    # where rounded values enter a difference and a gradient sums terms
    # that cancel, a whole gradient moves by a few percent (about 0.04 at
    # tier 1's W_hh of the flagship on an H100).  Bounds: NLL 0.01 bits,
    # each gradient 10% in relative norm; a wrong gradient is off by O(1)
    nk, np_, worst, where = compare(cfg)
    print(f"kernel route vs plain scan route, one step, bf16: NLL "
          f"{nk:.5f} vs {np_:.5f} bits (bound 0.01); worst gradient "
          f"relative norm {worst:.4f} at {where} (bound 0.1)")
    require(abs(nk - np_) <= 0.01, "NLL differs from the scan route")
    require(worst <= 0.1, "a gradient differs from the scan route")


def train_path(torch, dev, cfg, params, card, name="flagship",
               entry=True):
    """A 2-tier GRU's TBPTT train step on the kernel route (the flagship,
    or its stacked form): 2 warm steps, 5 timed; launch counts (one K4
    forward and backward per tier and layer), NLL, the profiler split, and
    one step's NLL and gradients against the plain scan route; with
    ``entry``, graft_entry.entry() on the card.  Returns the K4 launch
    counts of the timed steps, or raises SmokeFailure."""
    import math

    from samplernn_pase_tpu_torch import graft_entry
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    from samplernn_pase_tpu_torch.train.trainer import make_train_step

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
    print(f"{name} train path launches in 5 steps: {launches}; decode "
          f"kernels {dict(kdec.LAUNCHES)}")
    per_step = cfg.n_tiers * cfg.n_rnn
    require(launches == {"gru_sequence_fwd": 5 * per_step,
                         "gru_sequence_bwd": 5 * per_step,
                         "lstm_sequence_fwd": 0, "lstm_sequence_bwd": 0},
            f"K4 launches {launches}, expected {per_step} of each per step")
    nll_vals = [v.item() for v in nlls]
    print(f"{name} train NLL per step (bits): " + ", ".join(
        f"{v:.4f}" for v in nll_vals))
    require(all(math.isfinite(v) for v in nll_vals), "non-finite NLL")
    require(nll_vals[-1] < nll_vals[0], "the NLL did not fall")
    profile_step(torch, lambda: step(p, opt, hid, x, y, r), step_s)
    # orientation: the products of one step, 3x the forward's
    e, hd, f1 = cfg.embed_dim, cfg.dim, cfg.frame_sizes[0]
    fwd_flops = 2.0 * b * t * (f1 * e * hd + hd * hd + hd * cfg.q_levels)
    fwd_flops += 2.0 * b * (t + f1 - 1) * cfg.q_levels * e
    for k, span in enumerate(cfg.tier_spans):
        nf = t // span
        fwd_flops += 2.0 * b * nf * (span * hd + 2 * cfg.n_rnn * hd * 3 * hd
                                     + hd * cfg.frame_sizes[k] * hd)
    print(f"train step, {name} B={b}, seq_len {t}, kernel route: "
          f"{step_s * 1e3:.2f} ms per step ({warm:.2f} s for the 2 warm "
          f"steps), {b * t / f1 / step_s:,.0f} bottom frames/s, "
          f"{b * t / step_s:,.0f} samples/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB; products "
          f"{3 * fwd_flops / 1e12:.2f} TFLOP, bound "
          f"{3 * fwd_flops / PEAK_BF16 * 1e3:.2f} ms at {PEAK_BF16 / 1e12:.0f} "
          f"TFLOP/s; on {card}")
    check_routes(torch, dev, cfg, params, x, y)
    if not entry:
        return launches
    fn, eargs = graft_entry.entry()
    enll, _ = fn(*eargs)
    require(eargs[2].is_cuda and math.isfinite(enll.item()),
            "graft_entry.entry() did not give a finite NLL on the card")
    print(f"graft_entry.entry() on the card: NLL {enll.item():.4f} bits")
    return launches


def k2_cases(torch, dev, gen, cfg, params, weights, b: int, n_top: int):
    """K2's distinct products on a decode path at its shapes, on random
    activations from gen (drawn h, upper, window, x first, as the
    flagship's checks always drew them): per tier its input (levels, +
    upper below the top), per stacked layer the input gates and the
    recurrent gates (+ xg as ``add`` for an LSTM), and the upsample; and
    the f1 products that fold the embedding into the MLP's first layer in
    float32 (prepare_mlp, run once per make_generator request).  Returns
    ([(name, a, w, bias, add, levels_q, launches in the path's run of n_top
    top frames)], h, the window)."""
    from samplernn_pase_tpu_torch.ops import weight_norm as wnorm

    q, hd, f1 = cfg.q_levels, cfg.dim, cfg.frame_sizes[0]
    h = torch.randn(b, hd, device=dev, generator=gen) * 0.5
    upper = torch.randn(b, hd, device=dev, generator=gen)
    win = torch.randint(0, q, (b, cfg.lookback), device=dev, generator=gen,
                        dtype=torch.int32)
    x = torch.randn(b, hd, device=dev, generator=gen)
    lstm = cfg.rnn_type == "lstm"
    xg = torch.randn(b, 4 * hd, device=dev, generator=gen) if lstm else None
    cases = []
    for k, (tw, span) in enumerate(zip(weights["tiers"], cfg.tier_spans)):
        n = n_top * (cfg.lookback // span)
        top = k == cfg.n_tiers - 1
        cases.append((f"tier{k} input", win[:, -span:], tw["w_in"],
                      tw["b_in"], None if top else upper, q, n))
        for i, lw in enumerate(tw["layers"]):
            at = f"tier{k}" + (f" layer{i}" if len(tw["layers"]) > 1 else "")
            cases += [
                (f"{at} gate x", x, lw["w_ih"], lw["b_ih"], None, 0, n),
                (f"{at} gate h" + (" +xg" if lstm else ""), h, lw["w_hh"],
                 lw["b_hh"], xg, 0, n)]
        cases.append((f"tier{k} upsample", h, tw["w_up"],
                      None if k == 0 else tw["b_up_flat"], None, 0, n))
    mlp = params["mlp"]
    embed = mlp["embed"].float().contiguous()
    e = embed.shape[1]
    w_in = wnorm.resolve(mlp["w_in"]).float()[:e].contiguous()
    cases.append(("mlp embed fold", embed, w_in, None, None, 0, f1))
    return cases, h, win


def check_gemm(torch, dev, kdec, cases, path: str):
    """K2 against its plain version on each case of ``k2_cases``, timed
    beside its plain version, torch.addmm and its bound.  Returns the
    path's {"err", "launches", and the launch-weighted mean "ms", "plain",
    "lib", "bound", "by": {bound_by: launches}}, or raises SmokeFailure."""
    st = {"err": 0.0, "launches": 0, "ms": 0.0, "plain": 0.0, "lib": 0.0,
          "bound": 0.0, "by": {}}
    for name, a, w, bias, add, lq, runs, *kw in cases:
        kw = kw[0] if kw else {}
        got = kdec.gemm_bias(a, w, bias, add, levels_q=lq, **kw)
        want = kdec.gemm_bias_plain(a, w, bias, add, levels_q=lq, **kw)
        torch.cuda.synchronize()
        m, k = a.shape
        n = w.shape[1]
        af = (a.float() / (lq / 2) - 1) if lq else a
        scale = torch.matmul(af.to(w.dtype).float().abs(),
                             w.float().abs()).max().item()
        tol = 2 * k * 2.0 ** -24 * scale + 1e-6 * (1 + want.abs().max().item())
        err = (got - want).abs().max().item()
        ms, wall = device_ms(torch, lambda: kdec.gemm_bias(
            a, w, bias, add, levels_q=lq, **kw), 20)
        pms, _ = device_ms(torch, lambda: kdec.gemm_bias_plain(
            a, w, bias, add, levels_q=lq, **kw), 20)
        a_lib = af.to(w.dtype)
        bias_lib = (bias if bias is not None
                    else torch.zeros(n, device=dev)).to(w.dtype)
        lib_add = add
        if kw:
            # the library cannot select a row per lane: the yardstick is
            # addmm with the selected rows folded into its added input
            row = ext_row(torch, **kw)
            lib_add = row if add is None else add + row
        if lib_add is None:
            lms, _ = device_ms(torch, lambda: torch.addmm(bias_lib, a_lib, w),
                               20)
        else:
            # (A @ W + bias) + add as one library call: addmm with the
            # bias folded into add
            add_lib = (lib_add + bias_lib.float()).to(w.dtype)
            lms, _ = device_ms(torch, lambda: torch.addmm(add_lib, a_lib, w),
                               20)
        # conditioning reads each row's selected ext row and its phase
        nbytes = (a.numel() * 4 + w.numel() * w.element_size()
                  + (n * 4 if bias is not None else 0)
                  + (m * n * 4 if add is not None else 0) + m * n * 4
                  + (m * n * 4 + m * 4 if kw else 0))
        bms, by = bound(nbytes, 2.0 * m * n * k,
                        PEAK_BF16 if w.dtype == torch.bfloat16 else PEAK_F32)
        plan = kdec.gemm_plan(k, n, w.dtype)
        plan = (f"plan split {plan.split} bn {plan.bn} groups {plan.groups}"
                f" ({plan.ctas} CTAs per 128 rows)" if plan
                else "float32 FMA route")
        print(f"K2 {path} {name:16s} [{m},{k}]@[{k},{n}] {w.dtype} err "
              f"{err:.3g} (bound {tol:.3g}) {ms * 1e3:.1f} us (wall per call "
              f"{wall * 1e3:.1f} us), plain {pms * 1e3:.1f} us, addmm "
              f"{lms * 1e3:.1f} us, bound {bms * 1e3:.2f} us ({by}); "
              f"{plan}; {runs} launches in the path's run")
        require(err <= tol, f"gemm_bias {path} {name}: max abs err {err} > "
                f"{tol}")
        st["err"] = max(st["err"], err)
        st["launches"] += runs
        for key, val in (("ms", ms), ("plain", pms), ("lib", lms),
                         ("bound", bms)):
            st[key] += val * runs
        st["by"][by] = st["by"].get(by, 0) + runs
    for key in ("ms", "plain", "lib", "bound"):
        st[key] /= st["launches"]
    return st


def check_rows_independent(torch, kdec, cases, path: str):
    """K2's bf16 products at full width: rows of an M=1 and an M=5 call
    bit-equal to the same rows of the M=128 call, and two M=128 calls
    bit-equal (the plan does not depend on M).  Raises SmokeFailure."""
    n_checked = 0
    for name, a, w, bias, add, lq, _, *kw in cases:
        kw = kw[0] if kw else {}
        if w.dtype != torch.bfloat16:
            continue

        def call(lo, hi):
            sub = dict(kw, ext=kw["ext"][:, lo:hi],
                       cphase=kw["cphase"][lo:hi]) if kw else {}
            return kdec.gemm_bias(a[lo:hi], w, bias,
                                  None if add is None else add[lo:hi],
                                  levels_q=lq, **sub)
        full = call(0, a.shape[0])
        require(torch.equal(full, call(0, a.shape[0])),
                f"gemm_bias {path} {name}: two calls differ")
        for lo, hi in ((0, 1), (a.shape[0] - 1, a.shape[0]), (7, 12)):
            require(torch.equal(call(lo, hi), full[lo:hi]),
                    f"gemm_bias {path} {name}: rows {lo}..{hi - 1} alone "
                    "differ from the same rows of the whole call")
        n_checked += 1
    print(f"K2 {path}: {n_checked} bf16 products, rows of M=1 and M=5 "
          "calls bit-equal to the whole call's, two calls bit-equal")


def ext_row(torch, ext, cphase, pos, cond_rate):
    """The conditioning row K2's epilogue adds to each output row: row
    pos // cond_rate, or the next (clamped to the last) where the lane's
    phase carries it over (megagen.py:211-219)."""
    base = pos // cond_rate
    hi = min(base + 1, ext.shape[0] - 1)
    bump = (cphase.long() + pos % cond_rate >= cond_rate)[:, None]
    return torch.where(bump, ext[hi], ext[base])


def c4_request(torch, dev, cfg, b: int):
    """Config 4's request inputs from a seed: cond [B, C4_ROWS, cond_dim]
    normal rows; cond_pos0 [B], lane b at row b % 5 plus a phase spread
    over 0 .. cond_rate - 1; lane keys noise.lane_key(4, b, 0); noise_pos0
    [B] = 3b."""
    import numpy as np

    from samplernn_pase_tpu_torch.ops.kernels.noise import lane_key
    gen = torch.Generator(device=dev).manual_seed(21)
    cond = torch.randn(b, C4_ROWS, cfg.cond_dim, device=dev, generator=gen)
    lane = torch.arange(b, device=dev)
    rate = cfg.cond_rate
    cpos = (lane % 5) * rate + (lane * (rate - 1)) // (b - 1)
    keys = np.stack([lane_key(4, i, 0) for i in range(b)])
    return cond, cpos, keys, lane * 3


def c4_kernel_checks(torch, dev, kdec, tgen, cfg, weights, b: int,
                     calls: int):
    """Config 4's kernel modes against their plain versions (phase 2): K2's
    conditioning epilogue at both tier inputs, exactly K2 without it plus
    the selected row at positions that take and skip the bump, then timed
    with the cond projection through check_gemm (launch weights: ``calls``
    requests of C4_LENGTH samples); K1's lane-key mode (rescoring against
    its plain version, a lane alone equal to the same lane in the batch),
    timed.  Returns (K2 conditioning stats, projection stats, K1 stats:
    {"err", "ms", "plain", "bound", "by", "agree"}), or raises
    SmokeFailure."""
    q, hd, f1 = cfg.q_levels, cfg.dim, cfg.frame_sizes[0]
    n_top = C4_LENGTH // cfg.lookback
    gen = torch.Generator(device=dev).manual_seed(22)
    win = torch.randint(0, q, (b, cfg.lookback), device=dev, generator=gen,
                        dtype=torch.int32)
    upper = torch.randn(b, hd, device=dev, generator=gen)
    cond, cpos, keys, npos = c4_request(torch, dev, cfg, b)
    ext, phase, rate = tgen.project_cond(weights, cfg, cond, cpos, C4_LENGTH)
    tiers = weights["tiers"]
    for k, tw in enumerate(tiers):
        a, up = win[:, -cfg.tier_spans[k]:], (upper if k == 0 else None)
        base = kdec.gemm_bias(a, tw["w_in"], tw["b_in"], up, levels_q=q)
        for pos in (0, rate * 5 // 8, C4_LENGTH // 4 + rate // 4,
                    C4_LENGTH - cfg.tier_spans[k]):
            kw = dict(ext=ext[k], cphase=phase, pos=pos, cond_rate=rate)
            bumped = (phase.long() + pos % rate >= rate).sum().item()
            got = kdec.gemm_bias(a, tw["w_in"], tw["b_in"], up, levels_q=q,
                                 **kw)
            require(torch.equal(got, base + ext_row(torch, **kw)),
                    f"gemm_bias conditioning, tier {k}, pos {pos}: not K2 "
                    "plus the selected row")
            print(f"K2 config 4 tier{k} input +cond pos {pos}: equal to K2 "
                  f"+ the selected row ({bumped} of {b} lanes on the next "
                  f"row, {ext[k].shape[0]} rows)")
    cond_cases = [
        (f"tier1 input +cond", win[:, -cfg.tier_spans[1]:], tiers[1]["w_in"],
         tiers[1]["b_in"], None, q, calls * n_top,
         dict(ext=ext[1], cphase=phase, pos=rate * 5 // 8,
              cond_rate=rate)),
        (f"tier0 input +up +cond", win[:, -f1:], tiers[0]["w_in"],
         tiers[0]["b_in"], upper, q, calls * n_top * cfg.frame_sizes[1],
         dict(ext=ext[0], cphase=phase, pos=rate * 5 // 8,
              cond_rate=rate))]
    need = ext[0].shape[0]
    idx = ((cpos // rate)[:, None] + torch.arange(need, device=dev)).clamp(
        0, cond.shape[1] - 1)
    rows = cond.gather(1, idx[:, :, None].expand(b, need, cond.shape[2]))
    proj_cases = [("cond projection", rows.reshape(b * need, -1),
                   tiers[0]["w_cond"], None, None, 0, calls * len(tiers))]
    k2c = check_gemm(torch, dev, kdec, cond_cases, "config 4")
    k2p = check_gemm(torch, dev, kdec, proj_cases, "config 4")
    check_rows_independent(torch, kdec, cond_cases + proj_cases, "config 4")

    # K1 noise mode 3: per-lane keys and positions
    mw, t0 = weights["mlp"], tiers[0]
    h = torch.randn(b, hd, device=dev, generator=gen) * 0.5
    crow = kdec.gemm_bias(h, t0["w_up"])
    fwin = win[:, -f1:]
    lane_pos = (npos * 7 + 11).contiguous()
    args = (fwin, crow, t0["b_up"], mw, 1.0, None, 0, 500)
    # the keys in the form the generation loop passes, converted once
    keys = kdec.kernel_lane_keys(keys, dev)
    kw = dict(lane_keys=keys, lane_pos=lane_pos)
    got = kdec.frame_decode(*args, **kw)
    again = kdec.frame_decode_plain(*args, forced=got, **kw)
    agree = (again == got).float().mean().item()
    one = kdec.frame_decode(fwin[5:6], crow[5:6], t0["b_up"], mw, 1.0, None,
                            0, 500, lane_keys=keys[5:6],
                            lane_pos=lane_pos[5:6])
    require(torch.equal(one[0], got[5]),
            "frame_decode lane keys: lane 5 alone differs from lane 5 in the "
            "batch")
    require(agree >= 0.99, f"frame_decode lane keys bf16: rescoring "
            f"agreement {agree} < 0.99")
    ms, wall = device_ms(torch, lambda: kdec.frame_decode(*args, **kw), 10)
    pms, _ = device_ms(torch, lambda: kdec.frame_decode_plain(*args, **kw), 3)
    seq = torch.cat([fwin, got], dim=1).long()
    slots = torch.stack([seq[:, i:i + f1] for i in range(f1)])
    n_rows = (torch.arange(f1, device=dev) * q + slots).unique().numel()
    nbytes = (b * f1 * 4 + b * f1 * hd * 4 + f1 * hd * 4 + n_rows * hd * 2
              + (hd * hd + hd * q) * 2 + (2 * hd + q) * 4 + b * f1 * 4
              + b * 2 * 4 + b * 8)
    bd, by = bound(nbytes, 2.0 * b * f1 * (hd * hd + hd * q), PEAK_BF16)
    plan = kdec.frame_plan(hd, q, f1, torch.bfloat16)
    print(f"K1 frame_decode lane keys [B={b}, f1={f1}] bf16 plan "
          f"{tuple(plan)}: rescoring agreement {agree:.4f}, lane 5 alone "
          f"equal to lane 5 in the batch; {ms * 1e3:.1f} us (wall per call "
          f"{wall * 1e3:.1f} us), {ms * 1e3 / f1:.2f} us per step, plain "
          f"{pms * 1e3:.1f} us, bound {bd * 1e3:.2f} us ({by}, {n_rows} W' "
          "rows)")
    k1 = {"err": 0.0, "ms": ms, "plain": pms, "bound": bd, "by": by,
          "agree": agree}
    return k2c, k2p, k1


def check_lstm_gates(torch, dev, kdec, b: int, hdim: int):
    """K6 against its plain version at config 2's decode shape, timed,
    beside an empty kernel on the same grid (K6's floor on this card).
    Returns (err, ms, plain_ms, lib_ms, bound_ms, bound_by), or raises
    SmokeFailure."""
    import ctypes

    from samplernn_pase_tpu_torch.ops.kernels import _build
    gen = torch.Generator(device=dev).manual_seed(4)
    g = torch.randn(b, 4 * hdim, device=dev, generator=gen)
    c = torch.randn(b, hdim, device=dev, generator=gen)
    route = kdec.lstm_gates_route(hdim, g.stride(0), c.stride(0),
                                  g.data_ptr() % 16 // 4,
                                  c.data_ptr() % 16 // 4)
    err = max((a - w).abs().max().item() for a, w in zip(
        kdec.lstm_gates(g, c), kdec.lstm_gates_plain(g, c)))
    require(err <= 2e-6, f"lstm_gates: max abs err {err} > 2e-6")
    ms, wall = device_ms(torch, lambda: kdec.lstm_gates(g, c), 50)
    pms, _ = device_ms(torch, lambda: kdec.lstm_gates_plain(g, c), 50)
    empty = _build.function("lstm_gates", "srnn_lstm_gates_floor",
                            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor_ms, _ = device_ms(torch, lambda: empty(b, hdim, stream), 50)
    # the library's fused LSTM cell: i, f, g, o from input + hidden gates
    # (here g and zeros); timed as a yardstick, never called by the port
    zeros = torch.zeros_like(g)
    lib = torch.ops.aten._thnn_fused_lstm_cell(g, zeros, c)
    lib_err = max((a - w).abs().max().item() for a, w in zip(
        lib[:2], kdec.lstm_gates_plain(g, c)))
    lms, _ = device_ms(torch, lambda: torch.ops.aten._thnn_fused_lstm_cell(
        g, zeros, c), 50)
    bd, by = bound(4.0 * (4 * b * hdim + b * hdim + 2 * b * hdim),
                   20.0 * b * hdim, PEAK_F32)
    print(f"K6 lstm_gates [{b},{hdim}] route {route}: err {err:.3g} (bound "
          f"2e-06) {ms * 1e3:.2f} us (wall per call {wall * 1e3:.1f} us), "
          f"empty kernel on its grid {floor_ms * 1e3:.2f} us, plain "
          f"{pms * 1e3:.1f} us, _thnn_fused_lstm_cell {lms * 1e3:.2f} us "
          f"(err {lib_err:.3g}), bound {bd * 1e3:.2f} us ({by})")
    return err, ms, pms, lms, bd, by


def decode_launches(cfg, n: int, lane_keys: bool = False) -> dict:
    """Decode-kernel launches of one call of n samples: per tier step
    2 + 2 n_rnn K2 (input, two gate products per layer, upsample) and
    n_rnn K3 (GRU) or K6 (LSTM), per bottom frame one K1 (in its lane-key
    mode with ``lane_keys``); a conditioned model's tier inputs take K2's
    conditioning epilogue, and each call projects its rows once per tier
    (one K2 each)."""
    n_top = n // cfg.lookback
    steps = n_top * sum(cfg.lookback // s for s in cfg.tier_spans)
    k1 = n_top * cfg.lookback // cfg.frame_sizes[0]
    cond = bool(cfg.cond_dim)
    counts = {"frame_decode": k1,
              "gemm_bias": steps * (2 + 2 * cfg.n_rnn)
              + (cfg.n_tiers if cond else 0),
              "gru_gates": 0, "lstm_gates": 0,
              "gemm_bias_cond": steps if cond else 0,
              "frame_decode_lane_keys": k1 if lane_keys else 0}
    counts["gru_gates" if cfg.rnn_type == "gru" else "lstm_gates"] = (
        steps * cfg.n_rnn)
    return counts


def path_bound(cfg, b: int):
    """A decode path's bound per top frame at batch b: the sum of each
    launch's bound (K2: A, W, bias, add and C; K3: xg, hg, h and h'; K6:
    g, c and h', c'; K1: every W' row, which a B=128 frame's windows touch,
    as phase 2's K1 check counts) -> (ms, launches per top frame)."""
    q, hd, f1 = cfg.q_levels, cfg.dim, cfg.frame_sizes[0]
    lstm = cfg.rnn_type == "lstm"
    gates = 4 if lstm else 3

    def k2(k, n, add):
        return bound(b * k * 4 + k * n * 2 + n * 4 + b * n * 4 * (1 + add),
                     2.0 * b * k * n, PEAK_BF16)[0]

    k1 = bound(2 * b * f1 * 4 + b * f1 * hd * 4 + f1 * hd * 4
               + f1 * q * hd * 2 + (hd * hd + hd * q) * 2
               + (2 * hd + q) * 4, 2.0 * b * f1 * (hd * hd + hd * q),
               PEAK_BF16)[0]
    cell = (bound(4.0 * 7 * b * hd, 20.0 * b * hd, PEAK_F32)[0] if lstm
            else bound(4.0 * 8 * b * hd, 12.0 * b * hd, PEAK_F32)[0])
    total, launches = 0.0, 0
    for k, span in enumerate(cfg.tier_spans):
        # input (+ upper below the top), per layer xg and hg (+ xg for an
        # LSTM) and the cell, the upsample (, K1)
        step = (k2(span, hd, k < cfg.n_tiers - 1)
                + cfg.n_rnn * (k2(hd, gates * hd, False)
                               + k2(hd, gates * hd, lstm) + cell)
                + k2(hd, cfg.frame_sizes[k] * hd, False)
                + (k1 if k == 0 else 0.0))
        total += step * (cfg.lookback // span)
        launches += (2 + 3 * cfg.n_rnn + (k == 0)) * (cfg.lookback // span)
    return total, launches


def c2_generation(torch, dev, exp, params, weights, k2_launches: int, card):
    """Config 2's generation on the kernel route (K1, K2, K6) at B=128 on
    params and their kernel weights: greedy, sampled at the config's
    temperature and one make_generator request; launch counts (K2's must
    be k2_launches, the count phase 2 weighted its cases by), levels,
    rescoring and the profiler split.  Returns the decode kernels' launch
    counts, or raises SmokeFailure."""
    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec

    cfg, temp = exp.model, exp.generate.temperature
    b, q, n = BATCH, cfg.q_levels, C2_LENGTH
    kdec.reset_launches()
    t0 = time.perf_counter()
    greedy = tgen.generate_levels(params, cfg, b, n, None, seed=0,
                                  device=dev, kernel_weights=weights)
    torch.cuda.synchronize()
    t_greedy = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampled = tgen.generate_levels(params, cfg, b, n, temp, seed=1,
                                   device=dev, kernel_weights=weights)
    torch.cuda.synchronize()
    t_sampled = time.perf_counter() - t0
    frame = tgen.make_generator(cfg, b, n, temp, use_kernels="frame",
                                device=dev)(params, seed=1)
    torch.cuda.synchronize()
    launches = dict(kdec.LAUNCHES)
    print(f"config 2 generation launches (3 requests): {launches}")
    n_top = n // cfg.lookback
    want = {k: 3 * v for k, v in decode_launches(cfg, n).items()}
    want["gemm_bias"] += cfg.frame_sizes[0]   # make_generator's MLP fold
    require(launches == want, f"config 2 launches {launches}, expected "
            f"{want}")
    require(launches["gemm_bias"] == k2_launches,
            f"gemm_bias: {launches['gemm_bias']} launches, phase 2 weighted "
            f"its cases by {k2_launches}")
    for name, lv in (("greedy", greedy), ("sampled", sampled),
                     ("frame", frame)):
        require(lv.shape == (b, n) and lv.dtype == torch.int32,
                f"config 2 {name}: shape {tuple(lv.shape)} {lv.dtype}")
        require(lv.min().item() >= 0 and lv.max().item() < q,
                f"config 2 {name}: levels outside [0, {q})")
    require(torch.equal(frame, sampled),
            "config 2: make_generator(use_kernels='frame') differs from "
            "the same sampled request through generate_levels")
    agree_g = tgen.rescore(params, cfg, greedy[:, :C2_RESCORE], None,
                           seed=0)
    agree_s = tgen.rescore(params, cfg, sampled[:, :C2_RESCORE], temp,
                           seed=1)
    print(f"config 2 rescoring agreement (plain per-step modules, bf16, "
          f"first {C2_RESCORE} samples): greedy {agree_g:.4f}, sampled "
          f"{agree_s:.4f}; make_generator's request equal to "
          "generate_levels'")
    require(min(agree_g, agree_s) >= 0.99,
            "config 2 rescoring agreement below 0.99")
    t0 = time.perf_counter()
    times = kernel_times(torch, lambda: tgen.generate_levels(
        params, cfg, b, n, temp, seed=1, device=dev,
        kernel_weights=weights))
    wall = (time.perf_counter() - t0) * 1e3
    groups = {"frame_decode": [0.0, 0], "gemm_bias": [0.0, 0],
              "lstm_gates": [0.0, 0], "other": [0.0, 0]}
    for key, (t, cnt) in times.items():
        g = kernel_group(key, groups)
        groups[g][0] += t
        groups[g][1] += cnt
    busy = sum(t for t, _ in groups.values())
    print(f"config 2 profiled sampled request: wall {wall:.1f} ms "
          f"(profiler on), device busy {busy:.1f} ms ({busy / n_top:.2f} ms "
          f"per top frame), idle share {1 - busy / (t_sampled * 1e3):.3f} "
          f"of the unprofiled request's {t_sampled * 1e3:.1f} ms; "
          + ", ".join(f"{g} {t:.1f} ms/{c}" for g, (t, c) in
                      groups.items()))
    top_bound, top_launches = path_bound(cfg, b)
    print(f"config 2 generation path bound: {top_bound:.3f} ms per top frame "
          f"(the sum of its {top_launches} launches' bounds)")
    print(f"config 2 generation, B={b}, {n} samples: greedy "
          f"{b * n / t_greedy:,.0f} samples/s ({t_greedy:.3f} s), sampled "
          f"(T={temp}) {b * n / t_sampled:,.0f} samples/s "
          f"({t_sampled:.3f} s); {t_sampled * 1e3 / n_top:.2f} ms per top "
          f"frame of {cfg.lookback} samples; on {card}")
    return launches


def c2_train_path(torch, dev, exp, card):
    """Config 2's TBPTT training on the kernel route through
    make_multi_train_step at the config's steps_per_call: one warm call,
    one timed; launch counts, NLL, the profiler split of one step and one
    step against the scan route.  Returns the K5 launch counts of the
    timed call, or raises SmokeFailure."""
    import math

    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    from samplernn_pase_tpu_torch.train.trainer import (
        make_multi_train_step, make_train_step)

    cfg, tr = exp.model, exp.train
    k, b, t = tr.steps_per_call, tr.batch_size, tr.seq_len
    params = samplernn.init_params(torch.Generator().manual_seed(6), cfg,
                                   dev)
    gen = torch.Generator().manual_seed(7)
    xs = torch.randint(0, cfg.q_levels, (k, b, cfg.lookback + t),
                       generator=gen, dtype=torch.int32).to(dev)
    ys = xs[:, :, cfg.lookback:]
    rs = torch.zeros(k, b, device=dev)
    tx = make_optimizer(tr.lr, tr.grad_clip)
    multi = make_multi_train_step(cfg, tx)
    t0 = time.perf_counter()
    p, opt, hid, nll0 = multi(params, tx.init(params),
                              samplernn.initial_state(params, cfg, b), xs,
                              ys, rs)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rt.reset_launches()
    t0 = time.perf_counter()
    p, opt, hid, nll1 = multi(p, opt, hid, xs, ys, rs)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / k
    launches = dict(rt.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"config 2 train launches in one call of {k} steps: {launches}")
    want = {"gru_sequence_fwd": 0, "gru_sequence_bwd": 0,
            "lstm_sequence_fwd": cfg.n_tiers * k,
            "lstm_sequence_bwd": cfg.n_tiers * k}
    require(launches == want,
            f"K5 launches {launches}, expected {cfg.n_tiers} of each per "
            "step")
    nll_vals = torch.cat([nll0, nll1]).tolist()
    print("config 2 train NLL per step (bits): " + ", ".join(
        f"{v:.4f}" for v in nll_vals) + f"; mean of the first pass over "
        f"the {k} batches {nll0.mean().item():.4f}, of the second "
        f"{nll1.mean().item():.4f}")
    require(all(math.isfinite(v) for v in nll_vals), "non-finite NLL")
    require(nll1.mean().item() < nll0.mean().item(),
            "config 2: the NLL did not fall from the first pass over the "
            "batches to the second")
    step = make_train_step(cfg, tx)
    profile_step(torch, lambda: step(p, opt, hid, xs[0], ys[0], rs[0]),
                 step_s)
    f1 = cfg.frame_sizes[0]
    print(f"config 2 train step, B={b}, seq_len {t}, kernel route, "
          f"steps_per_call {k}: {step_s * 1e3:.2f} ms per step ({warm:.2f} "
          f"s for the warm call), {b * t / f1 / step_s:,.0f} bottom "
          f"frames/s, {b * t / step_s:,.0f} samples/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB; on {card}")
    check_routes(torch, dev, cfg, params, xs[0], ys[0])
    return launches


def add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in total | more}


def c4_generation(torch, dev, exp, params, weights, card):
    """Config 4's conditioned generation on the kernel route at B=128:
    the per-lane request (cond positions, lane keys, noise positions) at
    the config's temperature, greedy, a shared-seed request equal to
    make_generator(conditioned=True, use_kernels="frame")'s, and the
    per-lane request in 4 calls, equal to the one; exact launch counts,
    levels, rescoring and the profiler split.  Returns the decode kernels'
    launch counts, or raises SmokeFailure."""
    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec

    cfg, temp = exp.model, exp.generate.temperature
    b, q, n = BATCH, cfg.q_levels, C4_LENGTH
    cond, cpos, keys, npos = c4_request(torch, dev, cfg, b)
    lane = dict(cond=cond, cond_pos0=cpos, lane_keys=keys, noise_pos0=npos,
                device=dev, kernel_weights=weights)
    kdec.reset_launches()
    t0 = time.perf_counter()
    sampled = tgen.generate_levels(params, cfg, b, n, temp, **lane)
    torch.cuda.synchronize()
    t_sampled = time.perf_counter() - t0
    t0 = time.perf_counter()
    greedy = tgen.generate_levels(params, cfg, b, n, None, **lane)
    torch.cuda.synchronize()
    t_greedy = time.perf_counter() - t0
    shared = tgen.generate_levels(params, cfg, b, n, temp, seed=1, cond=cond,
                                  device=dev, kernel_weights=weights)
    frame = tgen.make_generator(cfg, b, n, temp, conditioned=True,
                                use_kernels="frame", device=dev)(
        params, 1, cond)
    parts, st, hist = [], None, None
    for i in range(4):
        piece = n // 4
        lv, st, hist = tgen.generate_levels(
            params, cfg, b, piece, temp, initial_states=st, hist=hist,
            return_state=True, **dict(lane, cond_pos0=cpos + i * piece,
                                      noise_pos0=npos + i * piece))
        parts.append(lv)
    torch.cuda.synchronize()
    launches = dict(kdec.LAUNCHES)
    want = {}
    for calls, length, keyed in ((1, n, True), (3, n, False),
                                 (4, n // 4, True)):
        for _ in range(calls):
            want = add_counts(want, decode_launches(cfg, length, keyed))
    want["gemm_bias"] += cfg.frame_sizes[0]   # make_generator's MLP fold
    print(f"config 4 generation launches (4 requests, one split in 4 "
          f"calls): {launches}")
    require(launches == want, f"config 4 launches {launches}, expected "
            f"{want}")
    for name, lv in (("sampled", sampled), ("greedy", greedy),
                     ("shared", shared), ("frame", frame)):
        require(lv.shape == (b, n) and lv.dtype == torch.int32,
                f"config 4 {name}: shape {tuple(lv.shape)} {lv.dtype}")
        require(lv.min().item() >= 0 and lv.max().item() < q,
                f"config 4 {name}: levels outside [0, {q})")
    require(torch.equal(frame, shared),
            "config 4: make_generator(conditioned=True, use_kernels="
            "'frame') differs from the same request through "
            "generate_levels")
    require(torch.equal(torch.cat(parts, 1), sampled),
            "config 4: the request split into 4 calls differs from one call")
    agree_s = tgen.rescore(params, cfg, sampled[:, :C4_RESCORE], temp,
                           noise_pos0=npos, cond=cond, cond_pos0=cpos,
                           lane_keys=keys)
    agree_g = tgen.rescore(params, cfg, greedy[:, :C4_RESCORE], None,
                           cond=cond, cond_pos0=cpos)
    print(f"config 4 rescoring agreement (plain per-step modules, bf16, "
          f"same cond rows and lane noise, first {C4_RESCORE} samples): "
          f"sampled {agree_s:.4f}, greedy {agree_g:.4f}; make_generator's "
          "request equal to generate_levels'; 4 calls equal to one")
    require(min(agree_s, agree_g) >= 0.99,
            "config 4 rescoring agreement below 0.99")
    t0 = time.perf_counter()
    times = kernel_times(torch, lambda: tgen.generate_levels(
        params, cfg, b, n, temp, **lane))
    wall = (time.perf_counter() - t0) * 1e3
    groups = {"frame_decode": [0.0, 0], "gemm_bias": [0.0, 0],
              "gru_gates": [0.0, 0], "other": [0.0, 0]}
    for key, (t, cnt) in times.items():
        g = kernel_group(key, groups)
        groups[g][0] += t
        groups[g][1] += cnt
    busy = sum(t for t, _ in groups.values())
    n_top = n // cfg.lookback
    print(f"config 4 profiled per-lane request: wall {wall:.1f} ms "
          f"(profiler on), device busy {busy:.1f} ms ({busy / n_top:.2f} ms "
          f"per top frame), idle share {1 - busy / (t_sampled * 1e3):.3f} "
          f"of the unprofiled request's {t_sampled * 1e3:.1f} ms; "
          + ", ".join(f"{g} {t:.1f} ms/{c}" for g, (t, c) in
                      groups.items()))
    print(f"config 4 conditioned generation, B={b}, {n} samples: sampled "
          f"(T={temp}, lane keys) {b * n / t_sampled:,.0f} samples/s "
          f"({t_sampled:.3f} s, {t_sampled * 1e3 / n_top:.2f} ms per top "
          f"frame of {cfg.lookback} samples), greedy "
          f"{b * n / t_greedy:,.0f} samples/s ({t_greedy:.3f} s); on {card}")
    return launches


def c4_serving(torch, dev, exp, params, card):
    """Config 4's stream serving: StreamPool(n_lanes=128) at the config's
    temperature, C4_CHUNKS chunks of C4_CHUNK samples.  Lanes 0-95 start
    at chunk 0 with streams of 50-400 rows (lanes 40-47 on a 10-row
    prefix, extended at chunk 2), 96-127 join at chunk 3, 16-31 stop at
    chunk 4 and restart on new streams at chunk 5.  Exact launch counts;
    lanes 0, 20, 40 and 100 bit-equal to solo B=1 StreamingGenerators with
    their streams and keys; the last chunk's levels through K7's decode,
    bit-equal to the plain decode, and its time warm and cold; per-chunk
    wall time, samples/s and the idle share.  Returns the pool's launch counts, or
    raises SmokeFailure."""
    import numpy as np

    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.ops.kernels import codec
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.ops.kernels.noise import lane_key
    from samplernn_pase_tpu_torch.scripts import codec_bench
    from samplernn_pase_tpu_torch.serve import StreamPool

    cfg, temp = exp.model, exp.generate.temperature
    n_lanes, chunk, seed = BATCH, C4_CHUNK, 31
    rng = np.random.default_rng(32)

    def stream(rows):
        return rng.standard_normal((rows, cfg.cond_dim), np.float32)

    streams = {lane: stream(50 + lane * 350 // 95) for lane in range(96)}
    late = {lane: stream(50 + (lane - 96) * 350 // 31)
            for lane in range(96, 128)}
    fresh = {lane: stream(60 + 9 * (lane - 16)) for lane in range(16, 32)}
    extended = range(40, 48)
    pool = StreamPool(params, cfg, n_lanes=n_lanes, temperature=temp,
                      seed=seed, device=dev)
    kdec.reset_launches()
    walls, life, outs = [], 0.0, []
    for c in range(C4_CHUNKS):
        t0 = time.perf_counter()
        if c == 0:
            for lane, rows in streams.items():
                got = pool.start(cond=rows[:10] if lane in extended
                                 else rows)
                require(got == lane, f"lane {got} claimed, expected {lane}")
        if c == 2:
            for lane in extended:
                pool.extend_cond(lane, streams[lane][10:])
        if c == 3:
            for lane, rows in late.items():
                pool.start(cond=rows, lane=lane)
        if c == 4:
            for lane in fresh:
                pool.stop(lane)
        if c == 5:
            for lane, rows in fresh.items():
                pool.start(cond=rows, lane=lane)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs.append(pool.emit(chunk))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        life += t1 - t0
    launches = dict(kdec.LAUNCHES)
    want = {}
    for _ in range(C4_CHUNKS):
        want = add_counts(want, decode_launches(cfg, chunk, True))
    want["gemm_bias"] += cfg.frame_sizes[0]   # kernel weights, first emit
    print(f"config 4 pool launches ({C4_CHUNKS} chunks): {launches}")
    require(launches == want, f"pool launches {launches}, expected {want}")
    for lv in outs:
        require(lv.shape == (n_lanes, chunk) and lv.min().item() >= 0
                and lv.max().item() < cfg.q_levels,
                "pool chunk: wrong shape or levels outside [0, q)")
    # solo B=1 streams on the card: (lane, first chunk, epoch, streams
    # to attach before chunk index)
    solos = ((0, 0, 0, {0: streams[0]}),
             (100, 3, 0, {0: late[100]}),
             (20, 5, 1, {0: fresh[20]}),
             (40, 0, 0, {0: streams[40][:10], 2: streams[40]}))
    for lane, first, epoch, attach in solos:
        sg = tgen.StreamingGenerator(params, cfg, 1, temperature=temp,
                                     stream_keys=lane_key(seed, lane, epoch),
                                     device=dev)
        solo = []
        for c in range(C4_CHUNKS - first):
            if c in attach:
                sg.set_cond(attach[c])
            solo.append(sg.emit(chunk)[0])
        got = torch.cat([o[lane] for o in outs[first:]])
        same = (got == torch.cat(solo)).float().mean().item()
        print(f"pool lane {lane} (from chunk {first}, key epoch {epoch}"
              f"{', extended at chunk 2' if len(attach) > 1 else ''}) "
              f"against a solo B=1 StreamingGenerator: {same:.4f} of "
              f"{got.numel()} samples equal")
        require(same == 1.0, f"pool lane {lane} differs from its solo "
                "stream")
    # the last chunk's levels through K7's decode at [128, 1024], what
    # StreamPool.emit_waveform decodes each chunk
    last = outs[-1]
    wave = codec.mu_law_decode(last, cfg.q_levels)
    require(torch.equal(wave, codec.mu_law_decode_plain(last, cfg.q_levels)),
            "K7 decode of the pool's last chunk differs from the plain "
            "decode")
    k7 = codec_bench.k7_times(
        torch, lambda: codec.mu_law_decode(last, cfg.q_levels), "decode")
    print(f"config 4 pool: the last chunk's levels [{n_lanes}, {chunk}] "
          f"through K7 decode (plan "
          f"{tuple(codec.plan_for(last, wave, cfg.q_levels, True))}): "
          f"bit-equal to the plain decode, {k7['warm']:.3f} us per launch "
          f"warm, {k7['cold']:.3f} us cold L2; on {card}")
    t0 = time.perf_counter()
    times = kernel_times(torch, lambda: pool.emit(chunk))
    pwall = (time.perf_counter() - t0) * 1e3
    busy = sum(t for t, _ in times.values())
    med = sorted(walls)[len(walls) // 2]
    total = sum(walls)
    n_top = chunk // cfg.lookback
    print(f"config 4 pool, {n_lanes} lanes, {C4_CHUNKS} chunks of {chunk} "
          f"samples ({chunk * 1e3 / 16000:.0f} ms of audio): per-chunk wall "
          f"median {med * 1e3:.1f} ms, max {max(walls) * 1e3:.1f} ms (first "
          f"{walls[0] * 1e3:.1f} ms), "
          f"{n_lanes * chunk * C4_CHUNKS / total:,.0f} lane-samples/s "
          f"({med * 1e3 / n_top:.2f} ms per top frame); lifecycle calls "
          f"{life * 1e3:.1f} ms in all; one profiled chunk: device busy "
          f"{busy:.1f} ms, idle share {1 - busy / (med * 1e3):.3f} of the "
          f"median chunk (profiler on: wall {pwall:.1f} ms); on {card}")
    return launches


def codec_checks(torch, dev):
    """K7 against its plain version (ops/mulaw.py's PyTorch ops) on the
    card, bit for bit: encode over [128, 16384] uniform floats in
    [-1.2, 1.2) (2**21 of them) and every level boundary and one ulp
    either side; decode over all 256 levels, and within 3 ulp of the plain
    version on the CPU (ROADMAP.md C), and over levels outside [0, q);
    both on misaligned views (rows 1 and 3 elements past a 16-byte line,
    leading dimensions not a multiple of 4).  Each direction timed at
    [128, 16384] (generate()'s request) and [128, 1024] (one pool chunk),
    warm (back-to-back launches) and cold (a 128 MB buffer written between
    launches; K7's own kernel from the profile: codec_bench.k7_times),
    each timed result bit-equal to the plain version, beside the empty
    kernel on its plan's grid, its plain version (warm) and its bound: the
    larger of bytes over 3.35 TB/s and the issue and MUFU times of the
    item loop of its plan's kernel, counted in the SASS of the library
    just built (codec_bench.item_loop), at the SM clock read under load.
    Returns {"encode"|"decode": {"err", "ms" (cold, at [128, 16384]),
    "plain", "bound", "by"}}, or raises SmokeFailure."""
    import numpy as np

    from samplernn_pase_tpu_torch.ops.kernels import _build, codec
    from samplernn_pase_tpu_torch.scripts import codec_bench as cb

    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.rand(BATCH, 16384, device=dev, generator=gen) * 2.4 - 1.2
    # level k starts where (y + 1) * 0.5 * mu + 0.5 reaches k, mu = 255
    mu = 255.0
    y = 2.0 * (np.arange(1, 256) - 0.5) / mu - 1.0
    xb = (np.sign(y) * np.expm1(np.abs(y) * np.log1p(mu)) / mu).astype(
        np.float32)
    edges = np.concatenate([np.nextafter(xb, np.float32(-2)), xb,
                            np.nextafter(xb, np.float32(2))])
    edges = torch.from_numpy(edges[None]).to(dev)
    wide = torch.rand(BATCH, 16387, device=dev, generator=gen) * 2.4 - 1.2
    for name, inp in (("random", x), ("level boundaries", edges),
                      ("rows 1 element past a 16-byte line, ld 16387",
                       wide[:, 1:16385]),
                      ("rows 3 past, 1023 columns", wide[:, 3:1026])):
        got = codec.mu_law_encode(inp)
        want = codec.mu_law_encode_plain(inp)
        require(torch.equal(got, want),
                f"codec encode ({name}): {(got != want).sum().item()} "
                "levels differ from the plain version on the card")
    levels = torch.arange(256, dtype=torch.int32, device=dev)[None]
    got = codec.mu_law_decode(levels)
    require(torch.equal(got, codec.mu_law_decode_plain(levels)),
            "codec decode differs from the plain version on the card")
    # ulps apart: the float32 bit patterns as integers (one sign per level)
    ulps = (got.cpu().view(torch.int32).long() - codec.mu_law_decode_plain(
        levels.cpu()).view(torch.int32).long()).abs().max().item()
    require(ulps <= 3, f"codec decode: {ulps} ulp from the CPU plain "
            "version (bound 3)")
    outside = torch.tensor([[-2 ** 31, -1, 256, 263, 2 ** 31 - 1]],
                           dtype=torch.int32, device=dev)
    lwide = torch.randint(-3, 260, (BATCH, 16387), device=dev, generator=gen,
                          dtype=torch.int32)
    for name, inp in (("levels outside [0, 256)", outside),
                      ("rows 1 element past a 16-byte line, ld 16387",
                       lwide[:, 1:16385]),
                      ("rows 3 past, 1023 columns", lwide[:, 3:1026])):
        require(torch.equal(codec.mu_law_decode(inp),
                            codec.mu_law_decode_plain(inp)),
                f"codec decode ({name}) differs from the plain version on "
                "the card")
    lv = torch.randint(0, 256, (BATCH, 16384), device=dev, generator=gen,
                       dtype=torch.int32)
    listing = cb.sass(_build._lib_path("codec"))
    mhz = cb.sm_clock_mhz(torch, lambda: codec.mu_law_encode(x))
    out = {}
    for name, fn, plain, inp in (
            ("encode", codec.mu_law_encode, codec.mu_law_encode_plain, x),
            ("decode", codec.mu_law_decode, codec.mu_law_decode_plain, lv)):
        for cols in (16384, 1024):
            a = inp[:, :cols].contiguous()
            res = fn(a)
            require(torch.equal(res, plain(a)),
                    f"codec {name} [{BATCH}, {cols}] differs from the "
                    "plain version on the card")
            plan = codec.plan_for(a, res, 256, name == "decode")
            t = cb.k7_times(torch, lambda: fn(a), name,
                            (plan.blocks, 1, plan.threads))
            loop = cb.item_loop(listing, name, plan)
            bd, by, three = cb.k7_bound_us(a.numel(), loop, mhz)
            print(f"K7 codec {name} [{BATCH}, {cols}] plan {tuple(plan)}: "
                  f"warm {t['warm']:.3f} us, cold L2 {t['cold']:.3f} us, "
                  f"empty kernel on its grid {t['floor']:.3f} us; bound "
                  f"{bd:.3f} us ({by}; bytes {three['bytes']:.3f}, issue "
                  f"{three['issue']:.3f}, MUFU {three['mufu']:.3f}: "
                  f"{loop[0]:.1f} instructions and {loop[1]:.2f} MUFU an "
                  f"element at {mhz:.0f} MHz)")
            if cols == 16384:
                ms, bound, by16 = t["cold"] / 1e3, bd / 1e3, by
        pms, _ = device_ms(torch, lambda: plain(inp), 20)
        out[name] = {"err": 0.0, "ms": ms, "plain": pms, "bound": bound,
                     "by": by16}
        what = ("2**21 floats, the 765 boundary values and 2 misaligned "
                "views" if name == "encode" else
                f"all 256 levels ({ulps} ulp from the CPU's), 5 outside "
                "[0, 256) and 2 misaligned views")
        print(f"K7 codec {name} [{BATCH}, 16384]: bit-equal to the plain "
              f"version on the card ({what}); {ms * 1e3:.2f} us cold L2, "
              f"plain {pms * 1e3:.1f} us warm, bound {bound * 1e3:.2f} us "
              f"({by16})")
    return out


def roofline_checks(torch, dev):
    """K8 and K9 against their plain versions on the card at the
    flagship's shapes (the script's inputs): K8's samples and one-hot ring
    equal with supplied noise and with Philox noise, in every timed call
    too; K9's accumulator within 2**-7 of its largest value (bf16 inputs,
    float32 sums taken in another order, so a bf16 rounding of the hidden
    activations may land on the other side, and every step repeats it:
    the inputs do not change from step to step).  Timed as the script
    calls them: K8 with Philox noise over N_STEPS steps, K9 over 16
    frames, beside their plain versions,
    their bounds and, for K9, torch.mm on the same products.  Returns
    {"vpu_tail"|"mxu_stream": {"err", "ms", "plain", "bound", "by",
    "lib"}}, or raises SmokeFailure."""
    from samplernn_pase_tpu_torch.scripts import vpu_ceiling as vc

    x = vc.inputs(dev)
    b, q, f1, hd = vc.B, vc.Q, vc.F1, vc.H
    plan = vc.vpu_plan(q, f1)
    # 3 frames fill a few of the plan's noise slots; 40 frames of supplied
    # noise turn the ring of slots over several times (every slot reused,
    # its barriers' phases flipped); the timed Philox calls below (256
    # frames) are checked as well
    for use_prng, n in ((False, 3), (True, 3), (False, 40)):
        got, ring = vc.vpu_tail(x["logits"], x["gum"], 5, n_frames=n,
                                use_prng=use_prng, return_ring=True)
        want, wring = vc.vpu_tail_plain(x["logits"], x["gum"], 5,
                                        n_frames=n, use_prng=use_prng)
        require(torch.equal(got, want) and torch.equal(ring, wring),
                f"vpu_tail (use_prng={use_prng}, {n} frames): samples or "
                "ring differ from the plain version")
    names = ("ebuf", "w1", "w2", "wh", "wo", "wup")
    bf = [x[k].to(torch.bfloat16) for k in names]
    got = vc.mxu_stream(*bf, n_frames=1)
    want = vc.mxu_stream_plain(*bf, n_frames=1)
    err9 = (got - want).abs().max().item()
    tol9 = 2 ** -7 * want.abs().max().item()
    require(err9 <= tol9, f"mxu_stream: max abs err {err9} > {tol9}")

    n_frames = vc.N_STEPS // f1
    timed = []   # every timed call's (samples, ring), checked after

    def k8():
        timed.append(vc.vpu_tail(x["logits"], x["gum"], 9,
                                 n_frames=n_frames, use_prng=True,
                                 return_ring=True))

    ms8, wall8 = device_ms(torch, k8, 3)
    pms8, _ = device_ms(torch, lambda: vc.vpu_tail_plain(
        x["logits"], x["gum"], 9, n_frames=n_frames, use_prng=True), 1)
    want, wring = vc.vpu_tail_plain(x["logits"], x["gum"], 9,
                                    n_frames=n_frames, use_prng=True)
    bad = sum(not (torch.equal(got, want) and torch.equal(ring, wring))
              for got, ring in timed)
    require(bad == 0, f"vpu_tail: {bad} of the {len(timed)} timed calls "
            f"({n_frames} frames, Philox) differ from the plain version")
    steps = n_frames * f1
    # bytes: logits, the samples and the ring; operations per level and
    # step: the scaled add and the compare (3), and the noise (Philox's
    # 10 rounds per 4 levels, about 25 integer operations a level, and the
    # transform's 5)
    bd8, by8 = bound(4.0 * b * q + 4.0 * b * f1 + 2.0 * b * f1 * q,
                     33.0 * steps * b * q, PEAK_F32)
    nf9 = 16
    ms9, wall9 = device_ms(torch, lambda: vc.mxu_stream(*bf, n_frames=nf9), 3)
    pms9, _ = device_ms(torch, lambda: vc.mxu_stream_plain(
        *bf, n_frames=nf9), 1)
    e, w1, w2, wh, wo, wup = bf
    head = e[:, :vc.HEAD].contiguous()
    tail = e[:, vc.HEAD:].contiguous()
    first = e[:, :hd].contiguous()

    def library():
        # the same products through torch.mm in bf16: never called by the
        # port, the yardstick
        for _ in range(nf9):
            torch.mm(first, wup)
            for _ in range(f1):
                hm = torch.relu(torch.mm(head, w1) + torch.mm(tail, w2))
                torch.mm(torch.relu(torch.mm(hm, wh)), wo)

    lms9, _ = device_ms(torch, library, 3)
    flops9 = nf9 * 2.0 * b * (f1 * (f1 * q * hd + hd * hd + hd * q)
                              + hd * f1 * hd)
    nbytes9 = (2.0 * b * f1 * q + 2.0 * (f1 * q * hd + hd * hd + hd * q
                                         + hd * f1 * hd) + 4.0 * b * q)
    bd9, by9 = bound(nbytes9, flops9, PEAK_BF16)
    print(f"K8 vpu_tail [B={b}, q={q}, f1={f1}] plan {tuple(plan)}: "
          "samples and ring equal to the plain version (supplied noise over "
          "3 and 40 frames, Philox over 3 and, in all "
          f"{len(timed)} timed calls, {n_frames}); {n_frames} frames "
          f"with Philox noise {ms8 * 1e3:.1f} us (wall {wall8 * 1e3:.1f} us, "
          f"{ms8 * 1e3 / steps:.3f} us per step), plain {pms8 * 1e3:.1f} us, "
          f"bound {bd8 * 1e3:.2f} us ({by8})")
    print(f"K9 mxu_stream [B={b}, H={hd}, q={q}, f1={f1}] bf16: max abs err "
          f"{err9:.3g} (bound {tol9:.3g}, 2**-7 of max); {nf9} frames "
          f"{ms9 * 1e3:.1f} us (wall {wall9 * 1e3:.1f} us, "
          f"{ms9 * 1e3 / (nf9 * f1):.3f} us per step), plain "
          f"{pms9 * 1e3:.1f} us, torch.mm {lms9 * 1e3:.1f} us, bound "
          f"{bd9 * 1e3:.2f} us ({by9}, {flops9 / nf9 / 1e9:.1f} GFLOP per "
          "frame)")
    return {"vpu_tail": {"err": 0.0, "ms": ms8, "plain": pms8, "bound": bd8,
                         "by": by8, "lib": None},
            "mxu_stream": {"err": err9, "ms": ms9, "plain": pms9,
                           "bound": bd9, "by": by9, "lib": lms9}}


def scope_checks(torch, dev):
    """The kernel route's scope beyond the megakernel's, float32 at small
    width on the card: generate_full on stacked GRU and LSTM tiers
    (n_rnn=2) against its plain twin, and generate_levels' kernel route
    against its plain route, greedy, on a 1-tier, a 4-tier and an f1=1
    model (all n_rnn=2).  Raises SmokeFailure."""
    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.config import SampleRNNConfig
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.kernels import megagen

    b = 8
    for rnn_type, sizes in (("gru", (4, 2)), ("lstm", (4, 2, 2))):
        cfg = SampleRNNConfig(frame_sizes=sizes, dim=64, embed_dim=16,
                              n_rnn=2, rnn_type=rnn_type,
                              compute_dtype="float32")
        p = samplernn.init_params(torch.Generator().manual_seed(11), cfg,
                                  dev)
        win = torch.full((b, cfg.lookback), 128, dtype=torch.int32,
                         device=dev)
        st = samplernn.initial_state(p, cfg, b)
        for temp in (0.0, 0.9):
            kw = dict(n_top=4, rnn_type=rnn_type, weights_dtype="float32",
                      seed=4)
            got, gs = megagen.generate_full(win, st, temp, p["tiers"],
                                            p["mlp"], **kw)
            want, ws = megagen.generate_full_plain(win, st, temp,
                                                   p["tiers"], p["mlp"], **kw)
            serr = max((u - v).abs().max().item() for u, v in zip(gs, ws))
            require(torch.equal(got, want) and serr <= 1e-5,
                    f"stacked {rnn_type} generate_full f32 T={temp}: samples "
                    f"differ or state err {serr} > 1e-5")
    for sizes in ((8,), (4, 2, 2, 2), (1, 16)):
        cfg = SampleRNNConfig(frame_sizes=sizes, dim=64, embed_dim=16,
                              n_rnn=2, compute_dtype="float32")
        p = samplernn.init_params(torch.Generator().manual_seed(12), cfg,
                                  dev)
        n = cfg.lookback * max(2, 64 // cfg.lookback)
        got = tgen.generate_levels(p, cfg, b, n, None, use_kernels=True,
                                   device=dev)
        want = tgen.generate_levels(p, cfg, b, n, None, use_kernels=False,
                                    device=dev)
        require(torch.equal(got, want),
                f"frame_sizes {sizes}: the kernel route's greedy float32 "
                f"samples differ from the plain route's "
                f"({(got != want).float().mean().item():.4f})")
    print("scope f32 small shapes: stacked (n_rnn=2) GRU and LSTM "
          "generate_full equal to the plain versions; 1-tier (8,), 4-tier "
          "(4, 2, 2, 2) and f1=1 (1, 16) greedy kernel route equal to the "
          "plain route")


def stacked_generation(torch, dev, cfg, params, weights, k2_launches: int,
                       card):
    """The stacked flagship's generation on the kernel route at B=128:
    greedy and sampled at T=0.95 and one make_generator(use_kernels=
    "frame") request equal to the sampled one; exactly 44 launches per top
    frame, per kernel; levels and rescoring; generate() to a waveform
    through K7's decode, equal to the plain decode of the sampled levels,
    and K7's encode taking it back to them; the profiler split.  Returns
    the decode and codec kernels' launch counts, or raises
    SmokeFailure."""
    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.ops.kernels import codec
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec

    b, q, n, temp = BATCH, cfg.q_levels, LENGTH, 0.95
    n_top = n // cfg.lookback
    kdec.reset_launches()
    t0 = time.perf_counter()
    greedy = tgen.generate_levels(params, cfg, b, n, None, seed=0,
                                  device=dev, kernel_weights=weights)
    torch.cuda.synchronize()
    t_greedy = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampled = tgen.generate_levels(params, cfg, b, n, temp, seed=1,
                                   device=dev, kernel_weights=weights)
    torch.cuda.synchronize()
    t_sampled = time.perf_counter() - t0
    frame = tgen.make_generator(cfg, b, n, temp, use_kernels="frame",
                                device=dev)(params, seed=1)
    torch.cuda.synchronize()
    launches = dict(kdec.LAUNCHES)
    want = {k: 3 * v for k, v in decode_launches(cfg, n).items()}
    want["gemm_bias"] += cfg.frame_sizes[0]   # make_generator's MLP fold
    print(f"stacked flagship launches (3 requests of {n_top} top frames): "
          f"{launches}")
    require(launches == want, f"stacked flagship launches {launches}, "
            f"expected {want}")
    require(launches["gemm_bias"] == k2_launches,
            f"gemm_bias: {launches['gemm_bias']} launches, phase 2 weighted "
            f"its cases by {k2_launches}")
    per_top = (sum(launches.values()) - launches["gemm_bias_cond"]
               - launches["frame_decode_lane_keys"]
               - cfg.frame_sizes[0]) / (3 * n_top)
    require(per_top == 44, f"{per_top} launches per top frame, expected 44")
    for name, lv in (("greedy", greedy), ("sampled", sampled),
                     ("frame", frame)):
        require(lv.shape == (b, n) and lv.dtype == torch.int32
                and lv.min().item() >= 0 and lv.max().item() < q,
                f"stacked {name}: shape {tuple(lv.shape)} {lv.dtype} or "
                f"levels outside [0, {q})")
    require(torch.equal(frame, sampled),
            "stacked: make_generator(use_kernels='frame') differs from the "
            "same sampled request through generate_levels")
    agree_g = tgen.rescore(params, cfg, greedy, None, seed=0)
    agree_s = tgen.rescore(params, cfg, sampled, temp, seed=1)
    print(f"stacked flagship rescoring agreement (plain per-step modules, "
          f"bf16): greedy {agree_g:.4f}, sampled {agree_s:.4f}; 44 launches "
          f"per top frame; make_generator's request equal to "
          f"generate_levels'")
    require(min(agree_g, agree_s) >= 0.99,
            "stacked flagship rescoring agreement below 0.99")
    # generate() to a waveform: K7's decode, then K7's encode takes it back
    codec.reset_launches()
    wave = tgen.generate(params, cfg, b, n, temp, seed=1, device=dev)
    back = codec.mu_law_encode(wave)
    torch.cuda.synchronize()
    codec_launches = dict(codec.LAUNCHES)
    require(codec_launches == {"codec_encode": 1, "codec_decode": 1},
            f"codec launches {codec_launches}, expected one of each")
    require(torch.equal(wave, codec.mu_law_decode_plain(sampled)),
            "generate(): the waveform differs from the plain decode of the "
            "same request's levels")
    require(torch.equal(back, sampled),
            "K7 encode of the generated waveform differs from its levels")
    print(f"stacked flagship generate(): waveform [{b}, {n}] through K7 "
          f"decode, bit-equal to the plain decode of the sampled levels; K7 "
          f"encode gives the levels back; codec launches {codec_launches}")
    t0 = time.perf_counter()
    times = kernel_times(torch, lambda: tgen.generate_levels(
        params, cfg, b, n, temp, seed=1, device=dev, kernel_weights=weights))
    wall = (time.perf_counter() - t0) * 1e3
    groups = {"frame_decode": [0.0, 0], "gemm_bias": [0.0, 0],
              "gru_gates": [0.0, 0], "other": [0.0, 0]}
    for key, (t, cnt) in times.items():
        g = kernel_group(key, groups)
        groups[g][0] += t
        groups[g][1] += cnt
    busy = sum(t for t, _ in groups.values())
    print(f"stacked flagship profiled sampled request: wall {wall:.1f} ms "
          f"(profiler on), device busy {busy:.1f} ms ({busy / n_top:.3f} ms "
          f"per top frame; K1 {groups['frame_decode'][0] / busy:.3f} of it), "
          f"idle share {1 - busy / (t_sampled * 1e3):.3f} of the unprofiled "
          f"request's {t_sampled * 1e3:.1f} ms; "
          + ", ".join(f"{g} {t:.1f} ms/{c}" for g, (t, c) in groups.items()))
    top_bound, top_launches = path_bound(cfg, b)
    print(f"stacked flagship generation path bound: {top_bound:.3f} ms per "
          f"top frame (the sum of its {top_launches} launches' bounds)")
    print(f"stacked flagship generation (n_rnn=2, weight norm), B={b}, {n} "
          f"samples: greedy {b * n / t_greedy:,.0f} samples/s "
          f"({t_greedy:.3f} s), sampled (T={temp}) "
          f"{b * n / t_sampled:,.0f} samples/s ({t_sampled:.3f} s, "
          f"{t_sampled * 1e3 / n_top:.2f} ms per top frame); on {card}")
    return add_counts(launches, codec_launches)


def stacked_serving(torch, dev, cfg, params, card):
    """The stacked flagship in a StreamPool of BATCH (128) lanes at
    T=0.95: 3/4 of them from chunk 0, the rest joining at chunk 1, 2
    chunks of LENGTH samples; exact launch counts; lanes 0 and 100 (one
    of each group) bit-equal to solo B=1 StreamingGenerators with their
    keys.  Returns the pool's launch counts, or raises SmokeFailure."""
    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.ops.kernels.noise import lane_key
    from samplernn_pase_tpu_torch.serve import StreamPool

    n_lanes, chunk, seed, temp = BATCH, LENGTH, 41, 0.95
    pool = StreamPool(params, cfg, n_lanes=n_lanes, temperature=temp,
                      seed=seed, device=dev)
    kdec.reset_launches()
    outs, walls = [], []
    early = n_lanes * 3 // 4
    for c in range(2):
        for _ in range(early if c == 0 else n_lanes - early):
            pool.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(pool.emit(chunk))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(kdec.LAUNCHES)
    want = {k: 2 * v for k, v in decode_launches(cfg, chunk, True).items()}
    want["gemm_bias"] += cfg.frame_sizes[0]   # kernel weights, first emit
    require(launches == want, f"stacked pool launches {launches}, expected "
            f"{want}")
    for lane, first in ((0, 0), (n_lanes * 25 // 32, 1)):
        sg = tgen.StreamingGenerator(params, cfg, 1, temperature=temp,
                                     stream_keys=lane_key(seed, lane, 0),
                                     device=dev)
        solo = torch.cat([sg.emit(chunk)[0] for _ in range(2 - first)])
        got = torch.cat([o[lane] for o in outs[first:]])
        same = (got == solo).float().mean().item()
        print(f"stacked pool lane {lane} (from chunk {first}) against a solo "
              f"B=1 StreamingGenerator: {same:.4f} of {got.numel()} samples "
              "equal")
        require(same == 1.0, f"stacked pool lane {lane} differs from its "
                "solo stream")
    print(f"stacked flagship pool, {n_lanes} lanes, 2 chunks of {chunk} "
          f"samples: chunk wall {', '.join(f'{w * 1e3:.1f}' for w in walls)} "
          f"ms; launches {launches}; on {card}")
    return launches


def roofline_path(torch, dev):
    """The roofline entry point (``python -m samplernn_pase_tpu_torch.
    scripts.vpu_ceiling``), K8's and K9's own path: its records, with
    their launch counts.  Raises SmokeFailure."""
    from samplernn_pase_tpu_torch.scripts import vpu_ceiling as vc

    vc.reset_launches()
    records = vc.roofline(dev)
    torch.cuda.synchronize()
    launches = dict(vc.LAUNCHES)
    for r in records:
        print(f"vpu_ceiling: {json.dumps(r)}")
    require(all(launches.values()),
            f"the roofline script did not launch K8 and K9: {launches}")
    return launches, records


C4_CHUNKS_PER_UTT = 10  # TBPTT chunks per config-4 corpus utterance
C4_UTTS = 80            # utterances of the config-4 corpus (about 8 held out)
C4_GEN = 16_000         # samples per GeneratorPlugin sequence


def c4_corpus(dirs, cfg, seq_len: int, seed: int):
    """Phase 12's corpus, written to disk: C4_UTTS wavs of sines by
    synthetic_corpus's recipe (a random f0 and 4 harmonics of random
    amplitude and phase, peak 0.8), each with a ragged tail inside its
    last of C4_CHUNKS_PER_UTT chunks, and one .npy of random float32
    conditioning rows [ceil(len / cond_rate), cond_dim] per wav."""
    import numpy as np

    from samplernn_pase_tpu_torch.ops.audio_io import write_wav
    wavs, conds = dirs
    wavs.mkdir(parents=True)
    conds.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(C4_UTTS):
        n = (C4_CHUNKS_PER_UTT - 1) * seq_len + int(rng.integers(
            seq_len // 4, seq_len - seq_len // 4))
        t = np.arange(n) / 16_000
        f0 = rng.uniform(80, 400)
        x = sum(rng.uniform(0.1, 0.5) * np.sin(2 * np.pi * f0 * (k + 1) * t
                                               + rng.uniform(0, 2 * np.pi))
                for k in range(4))
        write_wav(wavs / f"utt{i:05d}.wav", 0.8 * x / np.max(np.abs(x)))
        np.save(conds / f"utt{i:05d}.npy", rng.normal(size=(
            -(-n // cfg.cond_rate), cfg.cond_dim)).astype(np.float32))


def tree_diff(torch, a, b) -> float:
    """Largest absolute difference of two trees of tensors, leaves matched
    by key and index (a restored tree may order its keys otherwise)."""
    if isinstance(a, dict):
        require(set(a) == set(b), f"tree keys {sorted(a)} != {sorted(b)}")
        return max((tree_diff(torch, a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)):
        require(len(a) == len(b), "tree lengths differ")
        return max((tree_diff(torch, x, y) for x, y in zip(a, b)),
                   default=0.0)
    if not isinstance(a, torch.Tensor):
        return 0.0 if a == b else float("inf")
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


def drive_trainer(torch, cfg, tcfg, corpus, make, work, card, label,
                  gen_cond=None, codec_per_step=0, gen_codec=1):
    """Phases 12 and 16: ``make(tcfg, plugins)`` builds a trainer over
    ``corpus``, which runs ``tcfg.epochs`` epochs with LoggerPlugin,
    ValidationPlugin (every 2 groups and at each epoch's end),
    CheckpointPlugin (every group) and a GeneratorPlugin that fires once
    (2 sequences of C4_GEN samples at T=1.0, on ``gen_cond`` or, without
    it, the trainer's generation_cond).  Checks: K4 forward twice per train
    and val step and backward twice per train step; K7 decode
    ``codec_per_step`` times per train and val step and ``gen_codec`` times
    for the generation; the generation's K1/K2/K3 exactly; steps numbered
    in order; a finite NLL that falls; held-out val lines; the retention
    (latest 3 and the best); the wavs written; the data on the native
    route.  Prints step ms, bottom frames/s, the traced group's idle share,
    peak memory and the host's time by part.  Then a fresh trainer
    restores the second epoch's mid-epoch checkpoint and runs to the end:
    its steps, batch indices, NLLs, checkpoint params, hiddens and Adam
    moments equal the uninterrupted run's bit for bit.  The caller resets
    ``native_loader``'s routes before it reads the corpus.  Returns
    (trainer, launches of the run: K4, decode kernels and codec, (step ms,
    device ms per traced step)), or raises SmokeFailure."""
    import dataclasses
    import math

    import numpy as np

    from samplernn_pase_tpu_torch.data import native_loader
    from samplernn_pase_tpu_torch.ops import audio_io
    from samplernn_pase_tpu_torch.ops.kernels import codec as kcodec
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    from samplernn_pase_tpu_torch.train import trainer as tr
    from samplernn_pase_tpu_torch.train.checkpoint import CheckpointManager
    from samplernn_pase_tpu_torch.train.metrics import MetricsWriter

    k_call = cadence = tcfg.steps_per_call
    steps = len(corpus.batcher("train", tcfg.batch_size, tcfg.seq_len,
                               cfg.lookback, cfg.cond_rate))
    val_steps = len(corpus.batcher("val", tcfg.batch_size, tcfg.seq_len,
                                   cfg.lookback, cfg.cond_rate))
    total = tcfg.epochs * steps
    print(f"{label}: {len(corpus.train_idx)} train and "
          f"{len(corpus.val_idx)} held-out utterances; an epoch is {steps} "
          f"steps of B={tcfg.batch_size}, seq_len {tcfg.seq_len} (groups "
          f"of {k_call}), validation {val_steps} steps")
    require(corpus.has_val and steps >= 2 * k_call and steps % k_call
            and val_steps % k_call, f"{label} corpus: the epoch needs 2 "
            "full groups and a tail, and a held-out split with a tail")
    writer = MetricsWriter(work / "metrics.jsonl", echo=False)
    mgr = CheckpointManager(work / "ckpt", max_to_keep=tcfg.max_to_keep)
    recs = []

    class Cap(tr.Plugin):
        def on_step(self, trainer, step, metrics):
            recs.append((step, trainer.batch_idx, metrics["nll_bits"],
                         metrics["samples_per_sec"]))

    # validation every 2 groups and at each epoch's end; one generation
    val_every, gen_at = 2 * cadence, 3 * cadence
    plugins = [tr.LoggerPlugin(writer, every=1),
               tr.ValidationPlugin(writer, every_steps=val_every),
               tr.CheckpointPlugin(mgr, every_steps=cadence),
               tr.GeneratorPlugin(work / "samples", every_steps=gen_at,
                                  n_seqs=2, length=C4_GEN, temperature=1.0,
                                  cond=gen_cond),
               Cap()]
    trainer = make(tcfg, plugins)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt.reset_launches()
    kdec.reset_launches()
    kcodec.reset_launches()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    writer.close()
    peak = torch.cuda.max_memory_allocated()
    seq = dict(rt.LAUNCHES)
    dec = dict(kdec.LAUNCHES)
    cod = dict(kcodec.LAUNCHES)
    n_val = (total // val_every + tcfg.epochs) * val_steps
    print(f"{label} launches: {seq}; decode kernels "
          f"{ {k: v for k, v in dec.items() if v} }; codec {cod}; data "
          f"routes {dict(native_loader.ROUTES)}")
    require(seq == {"gru_sequence_fwd": 2 * (total + n_val),
                    "gru_sequence_bwd": 2 * total,
                    "lstm_sequence_fwd": 0, "lstm_sequence_bwd": 0},
            f"K4 launches {seq}: expected 2 forward per train and val step "
            f"({total} and {n_val}) and 2 backward per train step")
    want = decode_launches(cfg, C4_GEN)
    want["gemm_bias"] += cfg.frame_sizes[0]    # the request's MLP fold
    require(dec == want, f"GeneratorPlugin: decode launches {dec}, "
            f"expected one conditioned request of {C4_GEN} samples {want}")
    want_k7 = codec_per_step * (total + n_val) + gen_codec
    require(cod == {"codec_encode": 0, "codec_decode": want_k7},
            f"K7 launches {cod}: expected {codec_per_step} decode per "
            f"train and val step and {gen_codec} for the generation")
    # the routes count from the caller's reset before the corpus was read
    require(native_loader.ROUTES["numpy"] == 0
            and native_loader.ROUTES["native"] >= len(corpus.utterances)
            + total, "the data path left the native route")
    require([r[0] for r in recs] == list(range(total)),
            "steps not numbered 0..n-1")
    nlls = [r[2] for r in recs]
    require(all(math.isfinite(v) for v in nlls), "non-finite NLL")
    first, last = (sum(nlls[:k_call]) / k_call,
                   sum(nlls[-k_call:]) / k_call)
    print(f"{label} train NLL (bits), mean of the first and last {k_call} "
          f"steps: {first:.4f} -> {last:.4f}; per step "
          + ", ".join(f"{v:.3f}" for v in nlls))
    require(last < first, "the NLL did not fall")
    lines = [json.loads(s) for s in
             (work / "metrics.jsonl").read_text().splitlines()]
    val = [d for d in lines if d.get("split") == "val"]
    require(len(val) == n_val // val_steps
            and all(math.isfinite(d["nll_bits"])
                    and "val_is_train_fallback" not in d for d in val),
            f"expected {n_val // val_steps} held-out val lines, got {val}")
    kept, best = mgr.all_steps(), mgr.best_step(strict=True)
    latest = [total - 2 * cadence, total - cadence, total][
        -tcfg.max_to_keep:]
    require(kept == sorted(set(latest) | {best}),
            f"checkpoints {kept}: expected the latest {latest} and the "
            f"best by val NLL ({best})")
    wavs = sorted((work / "samples").glob("*.wav"))
    require([w.name for w in wavs] == [f"step{gen_at:08d}_seq{i}.wav"
                                       for i in range(2)],
            f"GeneratorPlugin wrote {[w.name for w in wavs]}")
    for w in wavs:
        x, sr = audio_io.read_wav(w)
        require(sr == 16_000 and x.shape == (C4_GEN,)
                and np.isfinite(x).all() and np.abs(x).max() <= 1.0,
                f"{w.name}: {x.shape} at {sr} Hz")
    where = [f"step {d['step']}" if "step" in d
             else f"end of epoch {d['epoch']}" for d in val]
    print(f"{label} val NLL (bits): " + ", ".join(
        f"{d['nll_bits']:.4f} ({w})" for d, w in zip(val, where))
        + f"; checkpoints {kept} (best {best}); GeneratorPlugin wavs "
        f"{[w.name for w in wavs]} read back, 2 x {C4_GEN} samples")
    # a step's wall time (launch to NLL read, per group): the second
    # epoch's full groups, warm and unprofiled; the first group (warm-up)
    # and the traced one (steps 8-15, profiler on) beside them
    b, t = tcfg.batch_size, tcfg.seq_len

    def ms(rs):
        return sum(b * t / r[3] * 1e3 for r in rs) / len(rs)

    step_ms = ms(recs[steps:steps + 2 * k_call])
    prof = trainer.profile
    busy = sum(e.self_device_time_total for e in prof.prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3
    host = trainer.host_s
    print(f"{label}, B={b}, seq_len {t}, steps_per_call {k_call}: "
          f"{step_ms:.2f} ms per step over the second epoch's full groups "
          f"({b * t / cfg.frame_sizes[0] / step_ms * 1e3:,.0f} bottom "
          f"frames/s; first group, warm-up, {ms(recs[:k_call]):.2f}; the "
          f"tail, one step a call, {ms(recs[total - steps % k_call:]):.2f})"
          f"; traced group (steps {k_call}-{2 * k_call - 1}, profiler on): "
          f"device busy {busy:.1f} ms of {prof.wall_s * 1e3:.1f} ms, idle "
          f"share {1 - busy / (prof.wall_s * 1e3):.3f} (profiler on), "
          f"{1 - busy / k_call / step_ms:.3f} of the unprofiled steps; "
          f"peak memory {peak / 2 ** 30:.2f} GiB; host seconds of the "
          f"{wall:.1f} s run: "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
          + f" (staging {host['stage'] / wall:.4f} of the run); on {card}")
    require(busy > 0 and (work / "profile" / "trace.json").exists(),
            "the trace of steps 10-12 recorded no device time")
    # resume: a fresh trainer from the second epoch's mid-epoch
    # checkpoint, to the end of that epoch
    at = total - 2 * cadence
    cursor = mgr.restore(at)["cursor"]
    resumed = []

    class Cap2(tr.Plugin):
        def on_step(self, trainer, step, metrics):
            resumed.append((step, trainer.batch_idx, metrics["nll_bits"]))

    t2 = make(dataclasses.replace(tcfg, profile_dir=""), [Cap2()])
    require(t2.restore(mgr, step=at), "no checkpoint to resume from")
    t2.run()
    torch.cuda.synchronize()
    nxt = int(cursor[2])
    require(int(cursor[0]) == 1 and resumed and resumed[0][0] == nxt
            and (nxt - steps) == int(cursor[1]) + 1,
            f"resume: first step {resumed[:1]}, cursor {cursor.tolist()}")
    require([r[:2] for r in resumed] == [r[:2] for r in recs[nxt:]],
            "resume: step numbering or batch indices differ from the "
            "uninterrupted run")
    diffs = {"params": tree_diff(torch, t2._ckpt_params(),
                                 trainer._ckpt_params()),
             "hiddens": tree_diff(torch, list(t2.hiddens),
                                  list(trainer.hiddens)),
             "adam": tree_diff(torch, [t2.opt_state["mu"],
                                       t2.opt_state["nu"]],
                               [trainer.opt_state["mu"],
                                trainer.opt_state["nu"]])}
    nll_diff = max(abs(a[2] - b[2]) for a, b in zip(resumed, recs[nxt:]))
    print(f"{label} resume from checkpoint {at} (cursor "
          f"{cursor.tolist()}): steps {resumed[0][0]}-{resumed[-1][0]}; "
          f"max abs difference from the uninterrupted run: NLL {nll_diff}, "
          + ", ".join(f"{k} {v}" for k, v in diffs.items()))
    require(nll_diff == 0 and not any(diffs.values()),
            "the resumed run differs from the uninterrupted run")
    return trainer, {**seq, **dec, **cod}, (step_ms, busy / k_call)


def c4_trainer(torch, dev, exp, params, card):
    """Phase 12: config 4's training through Trainer.run for 2 epochs with
    its plugins on a corpus read from disk (wavs and cached cond rows),
    then a resume from the second epoch's mid-epoch checkpoint equal to
    the uninterrupted run (``drive_trainer``).  Returns the phase's
    launch counts, or raises SmokeFailure."""
    import dataclasses
    import shutil

    import numpy as np

    from samplernn_pase_tpu_torch.data import native_loader
    from samplernn_pase_tpu_torch.data.dataset import WavCorpus
    from samplernn_pase_tpu_torch.train import trainer as tr

    cfg = exp.model
    work = ROOT / "build" / "c4_trainer"
    shutil.rmtree(work, ignore_errors=True)
    tcfg = dataclasses.replace(exp.train, epochs=2,
                               profile_dir=str(work / "profile"))
    t0 = time.perf_counter()
    c4_corpus((work / "wavs", work / "cond"), cfg, tcfg.seq_len, 41)
    native_loader.reset_routes()
    corpus = WavCorpus.from_folder(work / "wavs", cond_dir=work / "cond")
    print(f"config 4 corpus: {C4_UTTS} wavs and cond rows written and read "
          f"back in {time.perf_counter() - t0:.1f} s")
    gen_cond = np.random.default_rng(42).normal(
        size=(2, -(-C4_GEN // cfg.cond_rate), cfg.cond_dim)).astype(
        np.float32)
    _, launches, _ = drive_trainer(
        torch, cfg, tcfg, corpus,
        lambda tc, plugins: tr.Trainer(cfg, tc, corpus, plugins=plugins,
                                       params=params, device=dev),
        work, card, "config 4 Trainer.run", gen_cond=gen_cond)
    shutil.rmtree(work, ignore_errors=True)
    return launches


TTS_WORK = ROOT / "build" / "c4_tts"   # phases 15-17: wavs, embeddings
EXTRACT_BATCH = 16
C4_JOBS = 200          # phase 17's manifest
C4_JOB_KEYS = 4        # of them with a pinned stream_key
C4_JOB_SEEDS = 4       # and with seed_levels and seed_cond


def tts_corpus(cfg, seq_len: int):
    """Phases 15-17's wavs: phase 12's (``c4_corpus`` from its seed), in
    two speaker folders a/ and b/ so that extraction mirrors a tree."""
    import shutil
    shutil.rmtree(TTS_WORK, ignore_errors=True)
    wavs = TTS_WORK / "wavs"
    c4_corpus((wavs, TTS_WORK / "cond"), cfg, seq_len, 41)
    for i, f in enumerate(sorted(wavs.glob("*.wav"))):
        spk = wavs / ("a" if i < C4_UTTS // 2 else "b")
        spk.mkdir(exist_ok=True)
        f.rename(spk / f.name)
    shutil.rmtree(TTS_WORK / "cond")
    return wavs


def pase_kernel_ms(torch, fn):
    """(convolution ms, other ms, kernels) of fn() on the card from
    torch.profiler: cuDNN's convolution kernels (and their transposes)
    against the rest."""
    times = kernel_times(torch, fn)
    conv = sum(ms for k, (ms, _) in times.items() if any(
        w in k.lower() for w in ("conv", "xmma", "cudnn", "implicit",
                                 "fprop", "dgrad", "wgrad", "gemm")))
    return conv, sum(ms for ms, _ in times.values()) - conv, len(times)


def c3_extraction(torch, dev, pcfg, wav_dir, card):
    """Phase 15: config 3's encoder (configs/c3_pase_extract.json's pase
    section: 64 sinc filters of 251 taps, 7 blocks, emb 256, decimation
    160, bf16) with random weights from a seed, ``extract_to_dir`` at
    batch 16 over ``wav_dir``, written to disk.  Checks: each .npy has
    len // 160 rows of 256 finite float32 values at the wav's path in the
    mirrored tree; one batch in float32 on the card (TF32 off) within
    1e-4 of the same batch on the CPU in relative norm (float32 sums in
    another order through 8 layers); the bf16 embeddings within 0.05 of
    the float32 card's in relative norm.  Prints seconds of audio
    embedded per second (a second, warm pass in memory) and the conv time
    per batch.  Returns {wav path: embedding}."""
    import dataclasses

    import numpy as np

    from samplernn_pase_tpu_torch import extract
    from samplernn_pase_tpu_torch.models import pase
    from samplernn_pase_tpu_torch.ops.audio_io import read_wav
    from samplernn_pase_tpu_torch.tree import tree_map

    params, bn = pase.init_pase(torch.Generator().manual_seed(17), pcfg, dev)
    emb_dir = TTS_WORK / "emb"
    files = sorted(wav_dir.glob("**/*.wav"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = extract.extract_to_dir(params, bn, pcfg, wav_dir, emb_dir,
                                  batch_size=EXTRACT_BATCH, device=dev)
    t_dir = time.perf_counter() - t0
    wavs = [read_wav(f)[0] for f in files]
    require(outs == [emb_dir / f.relative_to(wav_dir).with_suffix(".npy")
                     for f in files] and {o.parent.name for o in outs}
            == {"a", "b"}, "extract_to_dir did not mirror the wav tree")
    embs = {}
    for f, o, w in zip(files, outs, wavs):
        e = np.load(o)
        require(e.shape == (len(w) // pcfg.decimation, pcfg.emb_dim)
                and e.dtype == np.float32 and np.isfinite(e).all(),
                f"{o.name}: {e.shape} {e.dtype} for {len(w)} samples")
        embs[f] = e
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = extract.extract_embeddings(params, bn, pcfg, wavs,
                                       EXTRACT_BATCH, device=dev)
    t_warm = time.perf_counter() - t0
    require(all(np.array_equal(a, embs[f]) for a, f in zip(again, files)),
            "a second extraction pass differs from the first")
    audio_s = sum(len(w) for w in wavs) / pcfg.sample_rate
    # one batch, the longest 16, padded as extract_embeddings pads
    order = np.argsort([len(w) for w in wavs])[-EXTRACT_BATCH:]
    pad = pcfg.decimation * 8
    width = -(-max(len(wavs[i]) for i in order) // pad) * pad
    x = np.zeros((EXTRACT_BATCH, width), np.float32)
    for row, i in enumerate(order):
        x[row, :len(wavs[i])] = wavs[i]
    xd = torch.from_numpy(x).to(dev)
    p32 = dataclasses.replace(pcfg, compute_dtype="float32")
    with torch.inference_mode():
        e_cpu = pase.pase_apply(tree_map(lambda t: t.cpu(), params),
                                tree_map(lambda t: t.cpu(), bn),
                                torch.from_numpy(x), p32)[0]
        e32 = pase.pase_apply(params, bn, xd, p32)[0]
        e16 = pase.pase_apply(params, bn, xd, pcfg)[0]
    rel_cpu = ((e32.cpu() - e_cpu).norm() / e_cpu.norm()).item()
    rel16 = ((e16 - e32).norm() / e32.norm()).item()
    print(f"config 3 extraction, {len(files)} wavs ({audio_s:.1f} s of "
          f"audio) at batch {EXTRACT_BATCH}: float32 on the card against "
          f"the CPU {rel_cpu:.2e} in relative norm (max abs "
          f"{(e32.cpu() - e_cpu).abs().max().item():.2e}, bound 1e-4); "
          f"bf16 against float32 on the card {rel16:.4f} (bound 0.05)")
    require(rel_cpu <= 1e-4, "the float32 embeddings on the card differ "
            "from the CPU's")
    require(rel16 <= 0.05, "the bf16 embeddings differ from float32's")

    def batch():
        with torch.inference_mode():
            pase.pase_apply(params, bn, xd, pcfg)

    conv, other, n_k = pase_kernel_ms(torch, batch)
    wall = cuda_ms(torch, batch, 10)
    print(f"config 3 extraction: {audio_s / t_dir:,.1f} s of audio per s "
          f"(extract_to_dir: read, embed, write {len(files)} .npy, "
          f"{t_dir:.2f} s), {audio_s / t_warm:,.1f} s of audio per s warm in "
          f"memory ({t_warm:.3f} s); one batch [{EXTRACT_BATCH}, {width}] "
          f"bf16: {wall:.2f} ms, device: convolutions {conv:.2f} ms, the "
          f"rest {other:.2f} ms ({n_k} kernels, torch.profiler); on {card}")
    return embs


def joint_route_check(torch, dev, cfg, pcfg, params, bn, x, y):
    """One joint step's NLL and gradients (both halves) on the kernel
    route against the scan route, as phase 4's ``check_routes``."""
    import dataclasses

    from samplernn_pase_tpu_torch.models import pase, samplernn
    from samplernn_pase_tpu_torch.train.joint import joint_cond

    def loss(q, c):
        pc = dataclasses.replace(pcfg, compute_dtype=c.compute_dtype)
        cond, _ = joint_cond(q["pase"], bn, c, pc, x, train=True)
        return samplernn.loss_fn(
            q["srnn"], c, x, y,
            samplernn.initial_state(q["srnn"], c, x.shape[0]), cond)[0]

    with pase.conv_numerics():
        check_routes(torch, dev, cfg, params, x, y, loss=loss)


def c4_joint(torch, dev, exp, wav_dir, card):
    """Phase 16: config 4 through JointTrainer.run at full width (the
    model, pase and train sections of configs/c4_tts_conditioned.json:
    B=32, seq_len 1280, steps_per_call 8, bf16) for 2 epochs over the
    wavs without cached conditioning, by ``drive_trainer`` (K7 decode
    once per train and val step, twice for the generation: the
    conditioning's utterance and the audio).  Also: the encoder's
    parameters and BatchNorm state moved, ``count`` equals the train
    steps; K7 at joint_cond's strided [32, 1280] view (row pitch 1296)
    bit-equal to its plain version; one joint step on the kernel route
    against the scan route; the encoder's share of a step's device time,
    what its deterministic convolutions cost, and the kernels one joint
    step launches beside the plain conditioned step's.  Returns the run's
    launch counts and its ms a step, or raises SmokeFailure."""
    import dataclasses

    from samplernn_pase_tpu_torch.data import native_loader
    from samplernn_pase_tpu_torch.data.dataset import WavCorpus
    from samplernn_pase_tpu_torch.models import pase, samplernn
    from samplernn_pase_tpu_torch.ops.kernels import codec as kcodec
    from samplernn_pase_tpu_torch.scripts import codec_bench
    from samplernn_pase_tpu_torch.train.joint import (
        JointTrainer, init_joint, joint_cond, make_joint_train_step)
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    from samplernn_pase_tpu_torch.train.trainer import make_train_step
    from samplernn_pase_tpu_torch.tree import tree_map

    cfg, pcfg = exp.model, exp.pase
    work = TTS_WORK / "joint"
    tcfg = dataclasses.replace(exp.train, epochs=2,
                               profile_dir=str(work / "profile"))
    native_loader.reset_routes()
    corpus = WavCorpus.from_folder(wav_dir)
    params, bn = init_joint(torch.Generator().manual_seed(19), cfg, pcfg,
                            device=dev)

    def make(tc, plugins):
        return JointTrainer(cfg, pcfg, tc, corpus, plugins, params=params,
                            bn_state=bn, device=dev)

    trainer, launches, (step_ms, busy) = drive_trainer(
        torch, cfg, tcfg, corpus, make, work, card,
        "config 4 JointTrainer.run", codec_per_step=1, gen_codec=2)
    total = trainer.global_step
    moved = tree_diff(torch, trainer.params["pase"], params["pase"])
    counts = {float(trainer.bn_state[k]["count"]) for k in ("sinc", "proj")}
    counts |= {float(s["count"]) for s in trainer.bn_state["blocks"]}
    bn_moved = tree_diff(torch, trainer.bn_state["proj"]["mean"],
                         bn["proj"]["mean"])
    print(f"config 4 joint: encoder parameters moved by up to {moved:.3e}, "
          f"its projection's running mean by {bn_moved:.3e}; BatchNorm "
          f"count {sorted(counts)} after {total} train steps")
    require(moved > 0 and bn_moved > 0 and counts == {float(total)},
            "the encoder or its BatchNorm state did not train")
    # joint_cond's decode: K7 at the chunk's strided view
    x = torch.randint(0, cfg.q_levels, (tcfg.batch_size,
                                        cfg.lookback + tcfg.seq_len),
                      generator=torch.Generator().manual_seed(5),
                      dtype=torch.int32).to(dev)
    y = x[:, cfg.lookback:]
    got = kcodec.mu_law_decode(y, cfg.q_levels)
    require(torch.equal(got, kcodec.mu_law_decode_plain(y, cfg.q_levels)),
            "K7 decode of the strided chunk view differs from the plain "
            "decode")
    k7 = codec_bench.k7_times(
        torch, lambda: kcodec.mu_law_decode(y, cfg.q_levels), "decode")
    print(f"config 4 joint: K7 decode of the chunk's levels "
          f"[{tcfg.batch_size}, {tcfg.seq_len}] (row pitch {y.stride(0)}, "
          f"plan {tuple(kcodec.plan_for(y, got, cfg.q_levels, True))}): "
          f"bit-equal to the plain decode, {k7['warm']:.3f} us warm, "
          f"{k7['cold']:.3f} us cold L2")
    joint_route_check(torch, dev, cfg, pcfg, params, bn, x, y)
    # the encoder's forward and backward at the step's shape, alone
    q = tree_map(lambda t: t.detach().requires_grad_(True), params["pase"])

    def encoder(deterministic: bool):
        def fn():
            with pase.conv_numerics():
                torch.backends.cudnn.deterministic = deterministic
                cond, _ = joint_cond(q, bn, cfg, pcfg, x, train=True)
                cond.sum().backward()
        return fn

    det, _ = device_ms(torch, encoder(True), 10)
    nondet, _ = device_ms(torch, encoder(False), 10)
    b, t = tcfg.batch_size, tcfg.seq_len
    print(f"config 4 joint: the encoder's forward and backward at [{b}, "
          f"{t}] {det:.3f} ms of device time with "
          f"deterministic convolutions, {nondet:.3f} ms with cuDNN's "
          f"default choice (x{det / nondet:.3f}); "
          f"{det / busy if busy else float('nan'):.3f} of a "
          f"traced step's {busy:.2f} ms device time ({step_ms:.2f} ms a "
          f"step unprofiled); on {card}")
    # where the host's time goes: kernels one step launches, the joint
    # step against the plain step conditioned on rows of the same shape
    tx = make_optimizer(exp.train.lr, exp.train.grad_clip)
    hid = samplernn.initial_state(params["srnn"], cfg, b)
    r = torch.zeros(b, device=dev)
    cond = torch.randn(b, t // cfg.cond_rate, cfg.cond_dim, device=dev)
    jstep = make_joint_train_step(cfg, pcfg, tx)
    pstep = make_train_step(cfg, tx)
    jopt, popt = tx.init(params), tx.init(params["srnn"])
    steps = {
        "joint": lambda: jstep(params, jopt, bn, hid, x, y, r),
        "plain, conditioned": lambda: pstep(params["srnn"], popt, hid, x, y,
                                            r, cond=cond)}
    parts = []
    for name, fn in steps.items():
        times = kernel_times(torch, fn)
        parts.append(f"{name} {sum(c for _, c in times.values())} kernels, "
                     f"{sum(ms for ms, _ in times.values()):.2f} ms of "
                     f"device time, {cuda_ms(torch, fn, 5):.2f} ms a call")
    print("config 4 one train step (torch.profiler; CUDA events): "
          + "; ".join(parts))
    return launches, step_ms


def c4_jobs(torch, dev, exp, params, embs, card):
    """Phase 17: ``serve.run_jobs`` with config 4's model (weights from a
    seed) on 128 lanes at T=1.0, chunks of 1,024 samples, over a manifest
    of C4_JOBS jobs conditioned on phase 15's embeddings at their natural
    length (rows x 160): C4_JOB_KEYS with a pinned stream_key, C4_JOB_SEEDS
    continuing a prompt (seed_levels, seed_cond), ``retain_results=False``
    with ``on_done`` collecting.  Checks: every job's length, ``on_done``
    once per job, no audio retained, exact launch counts, every job's
    waveform through K7's decode (equal to the plain decode), the pinned
    jobs bit-equal to solo B=1 StreamingGenerators with their keys, a
    16-job subset equal with enqueue_ahead on and off, a bad manifest
    raising before the first ``on_done``.  Prints wall time, samples/s,
    utilization, the idle share and the host syncs per chunk.  Returns the
    main run's launch counts (run_jobs, with K4's forward priming the
    prompted lanes, and the waveform decodes), or raises SmokeFailure."""
    import warnings

    import numpy as np

    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.ops.kernels import codec as kcodec
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    from samplernn_pase_tpu_torch.ops.kernels.noise import lane_key
    from samplernn_pase_tpu_torch.serve import run_jobs

    cfg, temp = exp.model, exp.generate.temperature
    n_lanes, chunk = BATCH, C4_CHUNK
    rows = list(embs.values())
    rng = np.random.default_rng(51)
    jobs = []
    for i in range(C4_JOBS):
        job = {"id": f"job{i:03d}", "cond": rows[i % len(rows)]}
        if i % (C4_JOBS // C4_JOB_KEYS) == 1:
            job["stream_key"] = lane_key(61, i, 0)
        if i % (C4_JOBS // C4_JOB_SEEDS) == 2:
            job["seed_levels"] = rng.integers(0, cfg.q_levels, 1024)
            job["seed_cond"] = rows[(i + 1) % len(rows)][:7]
        jobs.append(job)
    want = {j["id"]: len(j["cond"]) * cfg.cond_rate for j in jobs}
    done = {}

    def collect(jid, levels):
        require(jid not in done, f"on_done fired twice for {jid}")
        done[jid] = levels

    kw = dict(n_lanes=n_lanes, chunk=chunk, temperature=temp, seed=7,
              device=dev)
    kdec.reset_launches()
    kcodec.reset_launches()
    rt.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, stats = run_jobs(params, cfg, jobs, on_done=collect,
                              retain_results=False, **kw)
    wall = time.perf_counter() - t0
    waves = {jid: tgen.decode_waveform(torch.from_numpy(lv).to(dev)[None],
                                       cfg)[0] for jid, lv in done.items()}
    torch.cuda.synchronize()
    dec, cod, seq = dict(kdec.LAUNCHES), dict(kcodec.LAUNCHES), dict(
        rt.LAUNCHES)
    require(results == {} and set(done) == set(want) and all(
        done[j].shape == (n,) and done[j].dtype == np.int32
        for j, n in want.items()),
        "run_jobs: a job missing, of the wrong length, or audio retained")
    exp_dec = {}
    for _ in range(stats["chunks"]):
        exp_dec = add_counts(exp_dec, decode_launches(cfg, chunk, True))
    exp_dec["gemm_bias"] += cfg.frame_sizes[0]  # kernel weights, first emit
    print(f"run_jobs: {stats}; launches {dec}; codec {cod}; K4 {seq}")
    require(dec == exp_dec, f"run_jobs launches {dec}, expected {exp_dec}")
    # a prompted job's join primes its lane: one K4 forward per tier
    require(seq == {"gru_sequence_fwd": C4_JOB_SEEDS * cfg.n_tiers,
                    "gru_sequence_bwd": 0, "lstm_sequence_fwd": 0,
                    "lstm_sequence_bwd": 0},
            f"K4 launches {seq}: one forward per tier per prompted job")
    require(cod == {"codec_encode": 0, "codec_decode": len(want)},
            "one K7 decode per job's waveform expected")
    for jid, w in waves.items():
        lv = torch.from_numpy(done[jid]).to(dev)
        require(torch.equal(w, kcodec.mu_law_decode_plain(lv, cfg.q_levels)),
                f"{jid}: K7's waveform differs from the plain decode")
    # the pinned jobs against solo B=1 streams on the card
    for job in jobs:
        if "stream_key" not in job:
            continue
        sg = tgen.StreamingGenerator(params, cfg, 1, temperature=temp,
                                     stream_keys=job["stream_key"],
                                     device=dev)
        sg.set_cond(job["cond"])
        n = want[job["id"]]
        solo = torch.cat([sg.emit(chunk)[0] for _ in range(-(-n // chunk))])
        require(np.array_equal(solo[:n].cpu().numpy(), done[job["id"]]),
                f"{job['id']} differs from its solo B=1 stream")
    sub = jobs[:16]
    on = run_jobs(params, cfg, sub, enqueue_ahead=True, **kw)[0]
    off = run_jobs(params, cfg, sub, enqueue_ahead=False, **kw)[0]
    require(all(np.array_equal(on[j["id"]], off[j["id"]]) for j in sub),
            "enqueue_ahead changed a job's samples")
    fired = []
    bad = jobs + [dict(jobs[0])]             # a duplicate id, last
    try:
        run_jobs(params, cfg, bad, on_done=lambda j, lv: fired.append(j),
                 **kw)
        raised = False
    except ValueError:
        raised = True
    require(raised and not fired, "a bad manifest did not raise before "
            "the first job")
    # the same manifest under the profiler (idle share) and sync debug
    # mode (synchronising calls warn; the drain's event waits, one a
    # chunk, are explicit)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            times = kernel_times(torch, lambda: run_jobs(
                params, cfg, jobs, retain_results=False, **kw))
            pwall = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:80] for w in caught
             if "called a synchronizing" in str(w.message)]
    busy = sum(t for t, _ in times.values())
    n_samples = stats["generated"]
    print(f"run_jobs, {len(jobs)} jobs ({C4_JOB_KEYS} pinned, "
          f"{C4_JOB_SEEDS} with prompts) on {n_lanes} lanes, chunks of "
          f"{chunk}: {wall:.3f} s wall, {n_samples:,} samples "
          f"({n_samples / wall:,.0f} generated samples/s, "
          f"{n_samples / wall / 16_000:,.1f}x real time in all), "
          f"{stats['chunks']} chunks ({wall / stats['chunks'] * 1e3:.1f} ms "
          f"each), utilization {stats['utilization']:.4f}; profiled run: "
          f"device busy {busy:.1f} ms of {pwall:.1f} ms (idle share "
          f"{1 - busy / pwall:.3f} with the profiler on, "
          f"{1 - busy / (wall * 1e3):.3f} of the unprofiled run); host "
          f"syncs: {len(syncs) / stats['chunks']:.2f} a chunk in "
          f"synchronising calls ({len(syncs)} in {stats['chunks']} chunks"
          f"{': ' + '; '.join(sorted(set(syncs))[:3]) if syncs else ''}) "
          f"plus 1 event wait a chunk (the drain); pinned jobs equal their "
          f"solo streams, enqueue-ahead on and off equal on 16 jobs, a bad "
          f"manifest raised before any job; on {card}")
    return {**dec, **cod, **seq}


def bench_pool_twin(card):
    """Phase 18: ``python -m samplernn_pase_tpu_torch.scripts.bench_pool``
    in its own process: the reference's 8 rows, each positive, no skip."""
    rows = [json.loads(s) for s in run_module(
        "samplernn_pase_tpu_torch.scripts.bench_pool")]
    for r in rows:
        print(json.dumps(r))
    names = [r.get("metric") for r in rows]
    want = ["solo_plain_b1_chunk1024", "solo_conditioned_b1_chunk1024"] + [
        f"pool_serving_n{n}_chunk{c}" for c in (1280, 1024)
        for n in (8, 32, 128)]
    require(names == want and all(r["median_ms_per_chunk"] > 0
                                  for r in rows),
            f"bench_pool rows {names}, expected {want}")
    print(f"bench_pool twin on {card}: " + "; ".join(
        f"{r['metric']} {r['median_ms_per_chunk']} ms" for r in rows))
    return rows


CLI_WORK = TTS_WORK / "cli"   # phase 19's experiment, embeddings and audio
STREAM_KEY = 7                 # phase 19's pinned stream


class Verbs:
    """Phase 19's runner: ``cli.main(["--platform", "cuda", verb, ...])``
    in this process, its stdout and stderr captured, the kernel launches
    and the MLP folds (``generate.prepare_weights`` calls) of each verb
    counted and summed over the phase.  A ``SystemExit`` or an exception
    in a verb fails the phase."""

    def __init__(self, torch):
        from samplernn_pase_tpu_torch import generate as tgen
        from samplernn_pase_tpu_torch.ops.kernels import codec as kcodec
        from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
        from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
        self.torch, self.tgen = torch, tgen
        self.counters = (kdec, kcodec, rt)
        self.total, self.folds, self.wall = {}, 0, {}
        self.uncond_k2 = 0      # K2 tier-step launches without cond rows
        self._prepare = tgen.prepare_weights

    def __enter__(self):
        def counted(*args, **kwargs):
            self._n_folds += 1
            return self._prepare(*args, **kwargs)
        self._n_folds = 0
        self.tgen.prepare_weights = counted
        return self

    def __exit__(self, *exc):
        self.tgen.prepare_weights = self._prepare

    def __call__(self, verb, *argv, tag=None):
        """(seconds, stdout, stderr, launches) of one verb."""
        import contextlib
        import io

        from samplernn_pase_tpu_torch import cli
        for c in self.counters:
            c.reset_launches()
        folds = self._n_folds
        out, err = io.StringIO(), io.StringIO()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                cli.main(["--platform", "cuda", verb, *map(str, argv)])
        except SystemExit as exc:
            raise SmokeFailure(f"cli {verb} exited ({exc}): "
                               f"{err.getvalue()[-3000:]}") from exc
        self.torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = {k: v for c in self.counters for k, v in c.LAUNCHES.items()}
        self.total = add_counts(self.total, n)
        self.folds += self._n_folds - folds
        self.wall[tag or verb] = dt
        return dt, out.getvalue(), err.getvalue(), n


def pcm(path):
    """A wav file's int16 samples."""
    import wave

    import numpy as np
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def check_counts(n: dict, want: dict, what: str):
    """The launch counts ``n`` hold ``want``, and every other kernel of
    theirs launched no time."""
    got = {k: v for k, v in n.items() if v or k in want}
    full = {k: want.get(k, 0) for k in got}
    require(got == full and all(n.get(k, 0) == v for k, v in want.items()),
            f"{what}: launches { {k: v for k, v in n.items() if v} }, "
            f"expected {want}")


def c4_cli(torch, dev, exp3, wav_dir, card, joint_ms):
    """Phase 19: config 4's TTS pipeline driven verb by verb through
    ``samplernn_pase_tpu_torch.cli.main`` on the card, over phase 15's
    wavs: ``extract`` (the default encoder, which is config 3's),
    ``train --joint`` with config 4's file for one epoch and again with
    ``--resume`` to two, ``evaluate`` (val in process and in its own
    process, train at full batch and at batch 1, under sync debug mode),
    ``extract --ckpt``, ``generate`` (128 x 16,000 conditioned on a wav;
    4 greedy lanes continuing a seed wav), ``stream`` three ways with a
    pinned key and ``serve`` (the extracted embeddings at 128 lanes, then
    a mixed manifest, then a bad one).  Checks exact launch counts,
    config.json, the resume, the NLL, coverage and the tail passes, the
    seeded lanes against an in-process generation, the streams against
    each other and a StreamPool lane, and the keyed job against the
    stream.  Returns (launch counts of the verbs, MLP folds, K2 launches
    of tier steps decoded without conditioning rows), or raises
    SmokeFailure."""
    import dataclasses
    import math
    import re
    import shutil
    import warnings

    import numpy as np

    from samplernn_pase_tpu_torch import config as C
    from samplernn_pase_tpu_torch import extract
    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.data.dataset import (
        WavCorpus, _quantize_host)
    from samplernn_pase_tpu_torch.models.pase import absorb_legacy_bias
    from samplernn_pase_tpu_torch.ops.audio_io import read_wav, write_wav
    from samplernn_pase_tpu_torch.ops.kernels.noise import int_key
    from samplernn_pase_tpu_torch.serve import StreamPool
    from samplernn_pase_tpu_torch.train.checkpoint import CheckpointManager
    from samplernn_pase_tpu_torch.tree import tree_map

    c4_file = ROOT / "configs" / "c4_tts_conditioned.json"
    file_exp = C.load_config(c4_file)      # what the CLI reads
    cfg, tc = file_exp.model, file_exp.train
    shutil.rmtree(CLI_WORK, ignore_errors=True)
    CLI_WORK.mkdir(parents=True)
    exp_dir, emb1, emb2 = (CLI_WORK / "exp", CLI_WORK / "emb",
                           CLI_WORK / "emb_joint")
    files = sorted(wav_dir.glob("**/*.wav"))
    wavs = {f: read_wav(f)[0] for f in files}
    wav0 = files[0]
    audio_s = sum(len(x) for x in wavs.values()) / 16_000
    zero4 = {"gru_sequence_fwd": 0, "gru_sequence_bwd": 0}
    with Verbs(torch) as verb:
        # ---- extract: config 3's encoder is PASEConfig(), the default
        require(C.PASEConfig() == exp3.pase,
                "PASEConfig() differs from configs/c3_pase_extract.json's "
                "pase section")
        dt, _, _, n = verb("extract", "--dataset", wav_dir, "--out", emb1,
                           "--batch_size", EXTRACT_BATCH)
        check_counts(n, {}, "extract")
        embs = {}
        for f in files:
            e = np.load(emb1 / f.relative_to(wav_dir).with_suffix(".npy"))
            require(e.shape == (len(wavs[f]) // 160, 256)
                    and np.isfinite(e).all(), f"extract: {f.name} {e.shape}")
            embs[f] = e
        print(f"cli extract: {len(files)} wavs, {audio_s:.1f} s of audio, "
              f"{dt:.2f} s wall ({audio_s / dt:.1f} s of audio per s); "
              f"the tree mirrored, len // 160 rows of 256, finite")

        # ---- train --joint, then --resume to a second epoch
        corpus = WavCorpus.from_folder(wav_dir)
        steps = len(corpus.batcher("train", tc.batch_size, tc.seq_len,
                                   cfg.lookback, cfg.cond_rate))
        val_steps = len(corpus.batcher("val", tc.batch_size, tc.seq_len,
                                       cfg.lookback, cfg.cond_rate))
        metrics = exp_dir / "metrics.jsonl"
        seen, runs = 0, []
        for epochs in (1, 2):
            extra = ["--resume"] if epochs == 2 else []
            dt, _, err, n = verb(
                "train", "--config", c4_file, "--dataset", wav_dir,
                "--exp-dir", exp_dir, "--joint", "--epochs", epochs,
                *extra, tag=f"train epochs {epochs}")
            want_cfg = C.to_json(dataclasses.replace(file_exp, train=(
                dataclasses.replace(tc, exp_dir=str(exp_dir),
                                    epochs=epochs))))
            require((exp_dir / "config.json").read_text() == want_cfg,
                    f"train: config.json is not the config file with "
                    f"--exp-dir and --epochs {epochs} applied")
            if epochs == 2:
                m = re.search(r"resumed at step (\d+)", err)
                require(m is not None and int(m.group(1)) == steps,
                        f"train --resume: no 'resumed at step {steps}' in "
                        f"its output")
            lines = [json.loads(s)
                     for s in metrics.read_text().splitlines()]
            new, seen = lines[seen:], len(lines)
            n_val = sum(d.get("split") == "val" for d in new) * val_steps
            check_counts(n, {"gru_sequence_fwd": 2 * (steps + n_val),
                             "gru_sequence_bwd": 2 * steps,
                             "codec_decode": steps + n_val},
                         f"train --epochs {epochs}")
            runs.append((dt, new, n_val))
        train = [d for d in lines if d.get("split") == "train"]
        val = [d["nll_bits"] for d in lines if d.get("split") == "val"]
        require([d["step"] for d in train] == list(
            range(0, 2 * steps, tc.log_every_steps)),
            f"train: logged steps {[d['step'] for d in train]}")
        nll = [d["nll_bits"] for d in train]
        require(all(math.isfinite(v) for v in nll + val) and nll[-1] < nll[0],
                f"train: NLL {nll} (val {val})")
        b, t = tc.batch_size, tc.seq_len
        step_ms = {d["step"]: b * t / d["samples_per_sec"] * 1e3
                   for d in train}
        print(f"cli train --joint (B={b}, seq_len {t}, steps_per_call "
              f"{tc.steps_per_call}): {steps} steps an epoch, validation "
              f"{val_steps} steps; epoch 1 {runs[0][0]:.1f} s wall, "
              f"--resume to epoch 2 {runs[1][0]:.1f} s wall (resumed at "
              f"step {steps}); logged train NLL "
              + ", ".join(f"{v:.4f}" for v in nll) + "; val NLL "
              + ", ".join(f"{v:.4f}" for v in val) + "; ms a step at the "
              "logged steps " + ", ".join(f"{s}: {v:.2f}" for s, v in
                                         step_ms.items())
              + f" (JointTrainer.run, phase 16: {joint_ms:.2f}); K4 and K7 "
              f"launches exact over {runs[0][2] // val_steps} and "
              f"{runs[1][2] // val_steps} validations")

        # ---- evaluate: val in process and in its own process
        ev = ["--ckpt", exp_dir, "--dataset", wav_dir]
        dt, out, _, n = verb("evaluate", *ev, "--split", "val",
                             tag="evaluate val")
        rep = json.loads(out.strip().splitlines()[-1])
        t0 = time.perf_counter()
        rep2 = json.loads(run_module("samplernn_pase_tpu_torch.cli", [
            "--platform", "cuda", "evaluate", *map(str, ev), "--split",
            "val"])[-1])
        dt_proc = time.perf_counter() - t0
        require(rep == rep2, f"evaluate val: {rep} in process, {rep2} in "
                "its own process")
        require(rep["batch_size"] == 1 and rep["held_out"]
                and rep["coverage"] == 1.0 and rep["conditioning"] == "joint",
                f"evaluate val: {rep}")
        check_counts(n, {"gru_sequence_fwd": 2 * rep["batches"],
                         "gru_sequence_bwd": 0,
                         "codec_decode": rep["batches"]}, "evaluate val")
        # train split at full batch and at batch 1, under sync debug mode
        reps, syncs = {}, {}
        for bs in (tc.batch_size, 1):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    dt, out, _, n = verb("evaluate", *ev, "--split", "train",
                                         "--batch_size", bs,
                                         tag=f"evaluate train batch {bs}")
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            reps[bs] = r = json.loads(out.strip().splitlines()[-1])
            syncs[bs] = sum("called a synchronizing" in str(w.message)
                            for w in caught)
            require(r["batch_size"] == bs and r["coverage"] == 1.0
                    and r["conditioning"] == "joint"
                    and r["held_out"] is False, f"evaluate train: {r}")
            check_counts(n, {"gru_sequence_fwd": 2 * r["batches"],
                             "gru_sequence_bwd": 0,
                             "codec_decode": r["batches"]},
                         f"evaluate train batch {bs}")
        full, one = reps[tc.batch_size], reps[1]
        d_nll = abs(full["nll_bits"] - one["nll_bits"])
        per_batch = ((syncs[1] - syncs[tc.batch_size])
                     / (one["batches"] - full["batches"]))
        print(f"cli evaluate: val {rep} ({verb.wall['evaluate val']:.2f} s "
              f"in process, {dt_proc:.1f} s in its own process, equal "
              f"JSON); train at batch {tc.batch_size}: {full} "
              f"({verb.wall[f'evaluate train batch {tc.batch_size}']:.2f} "
              f"s), at batch 1: {one} "
              f"({verb.wall['evaluate train batch 1']:.2f} s); |full - "
              f"one lane| = {d_nll:.2e} bits (bound 1e-3); host syncs "
              f"(sync debug mode): {syncs[tc.batch_size]} in "
              f"{full['batches']} batches and {syncs[1]} in "
              f"{one['batches']}, {per_batch:.3f} a batch")
        require(full["samples"] == one["samples"] and d_nll <= 1e-3,
                "evaluate: the full-batch NLL differs from the one-lane "
                "NLL")

        # ---- extract with the jointly trained encoder
        verb("extract", "--dataset", wav_dir, "--out", emb2, "--ckpt",
             exp_dir, "--batch_size", EXTRACT_BATCH, tag="extract --ckpt")
        for f in files:
            e = np.load(emb2 / f.relative_to(wav_dir).with_suffix(".npy"))
            require(e.shape == embs[f].shape and np.isfinite(e).all()
                    and not np.array_equal(e, embs[f]),
                    f"extract --ckpt: {f.name} equals the default "
                    "encoder's or is not finite")

        # ---- generate: config 4's defaults, conditioned on a wav
        gcfg = file_exp.generate
        gen_dir = CLI_WORK / "gen"
        dt, _, _, n = verb("generate", "--ckpt", exp_dir, "--out", gen_dir,
                           "--cond-wav", wav0)
        outs = sorted(gen_dir.glob("gen_*.wav"))
        require(len(outs) == gcfg.n_seqs and all(
            read_wav(o)[0].shape == (gcfg.length,) for o in outs),
            f"generate: {len(outs)} wavs")
        want = decode_launches(cfg, gcfg.length)
        want["gemm_bias"] += cfg.frame_sizes[0]        # the MLP fold
        check_counts(n, {**want, **zero4, "codec_decode": 1}, "generate")
        gen_sps = gcfg.n_seqs * gcfg.length / dt
        print(f"cli generate: {gcfg.n_seqs} x {gcfg.length} samples at "
              f"T={gcfg.temperature}, conditioned on {wav0.name}: {dt:.2f} "
              f"s wall, {gen_sps:,.0f} samples/s (restore, embedding, "
              f"generation, K7 decode and {gcfg.n_seqs} wav files); "
              f"launches exact")
        # four greedy lanes continuing a seed wav, against one lane primed
        # and generated here
        seed_dir = CLI_WORK / "gen_seed"
        dt, _, _, n = verb("generate", "--ckpt", exp_dir, "--out", seed_dir,
                           "--n_seqs", 4, "--length", 4096, "--seed-wav",
                           wav0, "--temperature", 0, tag="generate seeded")
        # no --cond-wav: the lanes decode without conditioning rows
        want = decode_launches(dataclasses.replace(cfg, cond_dim=0), 4096)
        verb.uncond_k2 += want["gemm_bias"]
        want["gemm_bias"] += cfg.frame_sizes[0]
        check_counts(n, {**want, "gru_sequence_fwd": cfg.n_tiers,
                         "gru_sequence_bwd": 0, "codec_decode": 1},
                     "generate --seed-wav")
        lanes = [pcm(seed_dir / f"gen_{i:03d}.wav") for i in range(4)]
        exp = C.load_config(exp_dir / "config.json")
        payload = CheckpointManager(exp_dir / "ckpt").restore()["params"]
        params = tree_map(lambda v: v.to(dev), payload["joint"]["srnn"])
        pp, bn, _ = absorb_legacy_bias(payload["joint"]["pase"],
                                       payload["bn"])
        emb0 = extract.extract_embeddings(pp, bn, exp.pase, [wavs[wav0]],
                                          device=dev)[0]
        lv = _quantize_host(wavs[wav0], cfg.q_levels, cfg.codec)
        states, hist = tgen.prime(params, cfg, lv[None], cond=emb0[None],
                                  device=dev)
        one_lane = tgen.generate_levels(params, cfg, 1, 4096, None,
                                        initial_states=states, hist=hist,
                                        device=dev)
        write_wav(CLI_WORK / "seed_ref.wav", tgen.decode_waveform(
            one_lane, cfg)[0].cpu().numpy())
        ref = pcm(CLI_WORK / "seed_ref.wav")
        require(all(np.array_equal(x, ref) for x in lanes),
                "generate --seed-wav: the 4 greedy lanes differ from each "
                "other or from one lane primed and generated in process")
        print(f"cli generate --seed-wav, 4 greedy lanes of 4096: {dt:.2f} s "
              f"wall; the lanes equal each other and one lane primed and "
              f"generated in process ({len(lv)} seed samples)")

        # ---- stream: a pinned key, three loops
        sargs = ["--ckpt", exp_dir, "--cond-wav", wav0, "--seconds", 2,
                 "--stream-key", STREAM_KEY, "--temperature", 1.0]
        streams, lat = {}, {}
        for tag, extra in (("enqueue-ahead", ["--chunk-ms", 64]),
                           ("blocked", ["--chunk-ms", 64, "--blocked"]),
                           ("chunks-per-call 2", ["--chunk-ms", 128,
                                                  "--chunks-per-call", 2])):
            path = CLI_WORK / f"stream_{len(streams)}.wav"
            dt, _, err, _ = verb("stream", "--out", path, *sargs, *extra,
                                 tag=f"stream {tag}")
            streams[tag] = pcm(path)
            line = [s for s in err.splitlines() if s.startswith("[stream]")]
            m = re.search(r"median ([\d.]+) ms/chunk, worst ([\d.]+) ms",
                          line[-1] if line else "")
            require(m is not None, f"stream {tag}: no latency line")
            lat[tag] = (float(m.group(1)), float(m.group(2)), dt)
        first = streams["enqueue-ahead"]
        require(len(first) == 32_768 and all(
            np.array_equal(s, first) for s in streams.values()),
            "stream: the three loops' audio differs")
        pool = StreamPool(params, cfg, n_lanes=4, temperature=1.0, seed=11,
                          device=dev)
        others = list(embs.values())
        pool.start(cond=others[1])
        pool.start(cond=others[2])
        lane = pool.start(cond=emb0, stream_key=int_key(STREAM_KEY))
        levels = torch.cat([pool.emit(C4_CHUNK)[lane]
                            for _ in range(len(first) // C4_CHUNK)])
        write_wav(CLI_WORK / "pool.wav",
                  tgen.decode_waveform(levels, cfg).cpu().numpy())
        require(np.array_equal(pcm(CLI_WORK / "pool.wav"), first),
                "stream --stream-key differs from a StreamPool lane "
                "started with the same words")
        print("cli stream, 2 s at T=1.0, --stream-key 7: "
              + "; ".join(f"{k}: median {a:.1f} ms a chunk, worst {w:.1f} "
                          f"ms, {dt:.2f} s wall" for k, (a, w, dt) in
                          lat.items())
              + "; the three equal, and equal a StreamPool lane started "
              "with int_key(7) beside two other lanes")

        # ---- serve: the extracted embeddings on 128 lanes
        served = CLI_WORK / "served"
        dt, out, _, n = verb("serve", "--ckpt", exp_dir, "--out", served,
                             "--jobs-dir", emb1, "--lanes", BATCH,
                             "--chunk-ms", 64, tag="serve --jobs-dir")
        stats = json.loads(out.strip().splitlines()[-1])
        require(stats == json.loads((served / "serve_stats.json").read_text())
                and set(stats) == {"jobs", "chunks", "chunk", "lanes",
                                   "generated", "dispatched", "utilization",
                                   "wall_s", "sample_rate", "realtime_x"},
                f"serve: stats {stats}")
        for f, e in embs.items():
            x = read_wav(served / f"{f.stem}.wav")[0]
            require(x.shape == (len(e) * cfg.cond_rate,),
                    f"serve: {f.stem}.wav has {x.shape} samples")
        want = {}
        for _ in range(stats["chunks"]):
            want = add_counts(want, decode_launches(cfg, C4_CHUNK, True))
        want["gemm_bias"] += cfg.frame_sizes[0]
        check_counts(n, {**want, **zero4, "codec_decode": len(embs)},
                     "serve --jobs-dir")
        print(f"cli serve --jobs-dir: {stats['jobs']} jobs on "
              f"{stats['lanes']} lanes, {stats['chunks']} chunks of "
              f"{stats['chunk']}: {dt:.2f} s wall (run_jobs "
              f"{stats['wall_s']:.3f} s), {stats['generated']:,} samples, "
              f"{stats['generated'] / stats['wall_s']:,.0f} samples/s in "
              f"run_jobs, {stats['generated'] / dt:,.0f} over the verb, "
              f"utilization {stats['utilization']:.4f}; launches exact")
        # a mixed manifest: seconds and length, cond (relative and
        # absolute), cond_wav, seed_wav, an int id, int stream keys
        npys = sorted(emb1.rglob("*.npy"))
        jobs = [
            {"id": "sec", "seconds": 0.5, "cond": str(npys[0])},
            {"id": "len", "length": 5000,
             "cond": str(npys[1].relative_to(CLI_WORK))},
            {"id": "natural", "cond": str(npys[2].relative_to(CLI_WORK))},
            {"id": "wav", "cond_wav": str(wav0), "length": 3000},
            {"id": "seeded", "cond": str(npys[3]), "length": 4096,
             "seed_wav": str(files[5])},
            {"id": "keyed", "cond_wav": str(wav0), "seconds": 1.0,
             "stream_key": STREAM_KEY},
            {"id": "keyed9", "cond": str(npys[4]), "length": 2048,
             "stream_key": 9},
            {"id": 7, "cond": str(npys[5]), "seconds": 0.25},
        ]
        lengths = {"sec": 8000, "len": 5000,
                   "natural": len(np.load(npys[2])) * cfg.cond_rate,
                   "wav": 3000, "seeded": 4096, "keyed": 16_000,
                   "keyed9": 2048, "job_007": 4000}
        manifest = CLI_WORK / "jobs.json"
        manifest.write_text(json.dumps(jobs))
        mixed = CLI_WORK / "served_mixed"
        dt, out, _, n = verb("serve", "--ckpt", exp_dir, "--out", mixed,
                             "--jobs", manifest, "--lanes", BATCH,
                             "--chunk-ms", 64, tag="serve --jobs")
        require(sorted(p.stem for p in mixed.glob("*.wav")) == sorted(
            lengths), f"serve --jobs: wrote {list(mixed.glob('*.wav'))}")
        for jid, length in lengths.items():
            require(pcm(mixed / f"{jid}.wav").shape == (length,),
                    f"serve --jobs: {jid} is not {length} samples")
        require(np.array_equal(pcm(mixed / "keyed.wav"), first[:16_000]),
                "serve: the job with stream_key 7 differs from the stream")
        want = {}
        for _ in range(json.loads(out.strip().splitlines()[-1])["chunks"]):
            want = add_counts(want, decode_launches(cfg, C4_CHUNK, True))
        want["gemm_bias"] += cfg.frame_sizes[0]
        # the seeded job's join primes its lane: one K4 forward per tier
        check_counts(n, {**want, "gru_sequence_fwd": cfg.n_tiers,
                         "gru_sequence_bwd": 0, "codec_decode": len(jobs)},
                     "serve --jobs")
        bad = CLI_WORK / "bad.json"
        bad.write_text(json.dumps(jobs + [{"id": "../x", "length": 8,
                                           "cond": str(npys[0])}]))
        try:
            verb("serve", "--ckpt", exp_dir, "--out", CLI_WORK / "bad",
                 "--jobs", bad, tag="serve bad")
            raised = False
        except SmokeFailure:
            raised = True
        require(raised and not (CLI_WORK / "bad").exists(),
                "serve: a bad manifest did not exit before writing")
        print(f"cli serve --jobs: {len(jobs)} mixed jobs, {dt:.2f} s wall; "
              f"each at its length, the stream_key 7 job equal to the "
              f"stream's first 16,000 samples; a bad manifest exited "
              f"before any wav")
    print("cli verbs, wall seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in verb.wall.items()) + f"; on {card}")
    return verb.total, verb.folds, verb.uncond_k2


MESH_WORK = ROOT / "build" / "mesh"   # phase 20's experiment directory
MESH_JOBS = 64                        # phase 20's run_jobs manifest
MESH_TIMEOUT = 600                    # seconds a rank may take in all
# config 4's joint step sharded against whole, from one start: the NLL
# within 1e-4; each half's gradient (the norm of the difference over its
# norm) in float32 within 3x its own conditioning floor (phase 16's rule:
# the unsharded gradient under a 1e-7 relative nudge of the parameters),
# in bf16 within JOINT_BF16_GRAD_BAR (the split moves the encoder's
# gradient by 0.103 on the H100); a gradient not summed over data reads
# 0.5-0.8.  The epoch's NLLs drift apart as Adam compounds the bf16
# difference (up to 9.94e-3 bits in three runs on the H100): the bar over
# the whole epoch leaves room for it.
JOINT_BF16_GRAD_BAR = 0.25
JOINT_NLL_BAR = 0.05


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launches_now() -> dict:
    """Every kernel's launch count since its module's last reset."""
    from samplernn_pase_tpu_torch.ops.kernels import codec as kcodec
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    return {**kdec.LAUNCHES, **rt.LAUNCHES, **kcodec.LAUNCHES}


def reset_all_launches():
    from samplernn_pase_tpu_torch.ops.kernels import codec as kcodec
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    for mod in (kdec, rt, kcodec):
        mod.reset_launches()


def tree_rel(torch, ga, gb) -> float:
    """The norm of two gradient trees' difference over the second's."""
    from samplernn_pase_tpu_torch.tree import tree_leaves
    la, lb = tree_leaves(ga), tree_leaves(gb)
    num = sum((a.float() - b.float()).square().sum() for a, b in zip(la, lb))
    return (num / sum(b.float().square().sum() for b in lb)).sqrt().item()


def grads_rel(torch, ga, gb) -> float:
    """The worst relative norm of a gradient's difference, leaf by leaf."""
    from samplernn_pase_tpu_torch.tree import tree_leaves
    return max(((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip(tree_leaves(ga), tree_leaves(gb))
               if b.float().norm() > 0)


def train_grads(torch, cfg, params, x, r, mesh, dev):
    """One step's global NLL and gradients (summed over ``data``, the MLP
    shards gathered whole) of this rank's part of the whole batch."""
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.parallel import mesh as pm
    from samplernn_pase_tpu_torch.train.trainer import _grads
    from samplernn_pase_tpu_torch.tree import tree_map

    sh = pm.batch_sharding(mesh)
    p = tree_map(lambda t: t.detach().requires_grad_(True),
                 pm.shard_params(params, mesh))
    xs = sh.shard(x)
    h = pm.shard_state(mesh, samplernn.initial_state(params, cfg,
                                                     x.shape[0]))
    nll, _ = samplernn.loss_fn(p, cfg, xs, xs[:, cfg.lookback:],
                               samplernn.reset_state(params, cfg, h,
                                                     sh.shard(r)),
                               mesh=mesh)
    g = _grads(nll, p, mesh)
    return (samplernn.global_nll(nll, mesh).item(),
            pm.unshard_params(g, mesh))


def joint_grads(torch, mcfg, pcfg, params, bn, x, r, mesh):
    """One joint step's global NLL and gradients (summed over ``data``)
    of this rank's part of the whole batch, at the step's start."""
    from samplernn_pase_tpu_torch.models import pase, samplernn
    from samplernn_pase_tpu_torch.parallel import mesh as pm
    from samplernn_pase_tpu_torch.train.joint import joint_cond
    from samplernn_pase_tpu_torch.train.trainer import _grads
    from samplernn_pase_tpu_torch.tree import tree_map

    sh = pm.batch_sharding(mesh)
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    xs = sh.shard(x)
    h = pm.shard_state(mesh, samplernn.initial_state(params["srnn"], mcfg,
                                                     x.shape[0]))
    with pase.conv_numerics():
        cond, _ = joint_cond(p["pase"], bn, mcfg, pcfg, xs, train=True,
                             mesh=mesh)
        nll, _ = samplernn.loss_fn(
            p["srnn"], mcfg, xs, xs[:, mcfg.lookback:],
            samplernn.reset_state(params["srnn"], mcfg, h, sh.shard(r)),
            cond, mesh=mesh)
        g = _grads(nll, p, mesh)
    return samplernn.global_nll(nll, mesh).item(), g


def mesh_rank(rank: int, world: int, spec: dict) -> dict:
    """Phase 20b on one of two ranks sharing the card over gloo (spawned
    by ``parallel.launch.run_ranks``): each part's numbers, this rank's
    launches by part, and the results the parent holds against each
    other."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch

    from samplernn_pase_tpu_torch import cli
    from samplernn_pase_tpu_torch.data.dataset import WavCorpus
    from samplernn_pase_tpu_torch.models.pase import conv_numerics
    from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    from samplernn_pase_tpu_torch.parallel import dryrun
    from samplernn_pase_tpu_torch.parallel import mesh as pm
    from samplernn_pase_tpu_torch.serve import run_jobs
    from samplernn_pase_tpu_torch.train.joint import JointTrainer, init_joint
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    from samplernn_pase_tpu_torch.train.trainer import Plugin, make_train_step

    kdec.plain_numerics()
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = pm.make_mesh()
    out = {"device": str(dev), "launches": {}, "wall": {}}
    b, seq_len, chunk = spec["batch"], spec["seq_len"], spec["chunk"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def part(name, fn):
        reset_all_launches()
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out["wall"][name] = time.perf_counter() - t0
        out["launches"][name] = launches_now()
        return res

    # (1) the flagship's train step at B=128, 64 a rank: float32 at a
    # small width within 1e-5; bf16 at full width against phase 4's bars,
    # its steps timed (K4 twice a step on each rank)
    small = dataclasses.replace(spec["flagship"], dim=64, embed_dim=32,
                                compute_dtype="float32")
    ps = samplernn.init_params(torch.Generator().manual_seed(21), small,
                               "cpu")
    rng = np.random.default_rng(21)
    x_small = rng.integers(0, 256, (b, small.lookback * 5), np.int32)
    ones = np.ones((b,), np.float32)
    with conv_numerics():       # deterministic cuDNN: the MLP's window
        got = part("f32_small", lambda: dryrun.train_step(
            small, ps, x_small, ones, mesh=mesh, device=dev))
        want = dryrun.train_step(small, ps, x_small, ones, device=dev)
    out["f32_nll"] = (got[0], want[0])
    out["f32_err"] = tree_diff(torch, tree_map(torch.as_tensor, got[1:]),
                               tree_map(torch.as_tensor, want[1:]))
    out["f32_ok"] = all(np.allclose(u, v, atol=1e-5, rtol=1e-5) for u, v in
                        zip(tree_leaves(got[1:]), tree_leaves(want[1:])))
    cfg = spec["flagship"]
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg, dev)
    x = torch.from_numpy(rng.integers(0, 256, (b, cfg.lookback + seq_len),
                                      np.int32)).to(dev)
    r = torch.ones(b, device=dev)
    nll_s, g_s = train_grads(torch, cfg, params, x, r, mesh, dev)
    nll_u, g_u = train_grads(torch, cfg, params, x, r, None, dev)
    out["bf16_dp"] = (nll_s, nll_u, grads_rel(torch, g_s, g_u))
    tx = make_optimizer(1e-3, 1.0)
    step = make_train_step(cfg, tx, mesh)
    sh = pm.batch_sharding(mesh)
    xs = sh.shard(x)
    state = [params, tx.init(params),
             samplernn.initial_state(params, cfg, b // world)]

    def steps(n):
        for _ in range(n):
            state[0], state[1], state[2], _ = step(
                *state, xs, xs[:, cfg.lookback:], sh.shard(r))
    steps(1)
    part("bf16_dp_steps", lambda: steps(3))
    out["bf16_dp_ms"] = out["wall"]["bf16_dp_steps"] / 3 * 1e3

    # (2) the flagship on a (1, 2) mesh: the MLP split 512/512
    mesh2 = pm.make_mesh((1, 2), ("data", "model"))
    out["mlp_split"] = tuple(pm.shard_params(params, mesh2)["mlp"]["w_h"]
                             .shape)
    nll_t, g_t = part("bf16_tp", lambda: train_grads(
        torch, cfg, params, x, r, mesh2, dev))
    out["bf16_tp"] = (nll_t, nll_u, grads_rel(torch, g_t, g_u))
    del g_s, g_u, g_t, state

    # (3) config 4's joint step: its gradients at the start, sharded and
    # whole, in bf16 and float32 (the encoder's and SampleRNN's sums over
    # data); then JointTrainer.run, one epoch, B=32 (16 a rank)
    exp4 = spec["exp4"]
    tcfg = dataclasses.replace(exp4.train, epochs=1)
    corpus = WavCorpus.from_folder(spec["wav_dir"])
    jp, jb = init_joint(torch.Generator().manual_seed(19), exp4.model,
                        exp4.pase, device=dev)
    bj = tcfg.batch_size
    xj = torch.from_numpy(rng.integers(
        0, 256, (bj, exp4.model.lookback + tcfg.seq_len), np.int32)).to(dev)
    rj = torch.ones(bj, device=dev)
    halves = ("pase", "srnn")
    for dt in ("bfloat16", "float32"):
        mc = dataclasses.replace(exp4.model, compute_dtype=dt)
        pc = dataclasses.replace(exp4.pase, compute_dtype=dt)
        nll_s, g_s = part(f"joint_grads_{dt}", lambda: joint_grads(
            torch, mc, pc, jp, jb, xj, rj, mesh))
        nll_u, g_u = joint_grads(torch, mc, pc, jp, jb, xj, rj, None)
        rec = {"nll": (nll_s, nll_u),
               "rel": [tree_rel(torch, g_s[h], g_u[h]) for h in halves],
               "leaf": [grads_rel(torch, g_s[h], g_u[h]) for h in halves]}
        if dt == "float32":
            ng = torch.Generator(device=dev).manual_seed(23)
            nudged = tree_map(lambda a: a * (1 + 1e-7 * torch.randn(
                a.shape, device=dev, generator=ng)), jp)
            g_n = joint_grads(torch, mc, pc, nudged, jb, xj, rj, None)[1]
            rec["floor"] = [tree_rel(torch, g_n[h], g_u[h]) for h in halves]
        out[f"joint_grads_{dt}"] = rec
    del g_s, g_u

    def joint_run(m):
        rec = []

        class Rec(Plugin):
            def on_step(self, t, s, metrics):
                rec.append(metrics["nll_bits"])
        t = JointTrainer(exp4.model, exp4.pase, tcfg, corpus, [Rec()],
                         params=jp, bn_state=jb, device=dev, mesh=m)
        t.run()
        bn = {k: v.cpu().numpy() for k, v in t.bn_state["proj"].items()}
        digest = hashlib.sha256()
        for leaf in tree_leaves(t.params):
            digest.update(leaf.detach().float().cpu().numpy().tobytes())
        return rec, bn, digest.hexdigest()

    out["joint"] = part("joint", lambda: joint_run(mesh))
    if rank == 0:
        t0 = time.perf_counter()
        out["joint_plain"] = joint_run(None)
        out["wall"]["joint_plain"] = time.perf_counter() - t0

    # (4) run_jobs: 128 lanes (64 a rank) over MESH_JOBS of phase 17's
    # jobs, greedy and with pinned keys
    cfg4 = exp4.model
    params4 = samplernn.init_params(torch.Generator().manual_seed(9), cfg4,
                                    dev)
    kw = dict(n_lanes=b, chunk=chunk, seed=7, device=dev)
    greedy = [{k: v for k, v in j.items() if k != "stream_key"}
              for j in spec["jobs"]]
    pinned = [dict(j, stream_key=j.get("stream_key", spec["keys"][i]))
              for i, j in enumerate(spec["jobs"])]
    for name, jobs, temp in (("jobs_greedy", greedy, None),
                             ("jobs_pinned", pinned, 1.0)):
        res, stats = part(name, lambda: run_jobs(
            params4, cfg4, jobs, temperature=temp, mesh=mesh, **kw))
        out[name] = (res, stats["chunks"])
        if rank == 0:
            reset_all_launches()
            plain, pstats = run_jobs(params4, cfg4, jobs, temperature=temp,
                                     **kw)
            out[name + "_plain"] = (plain, pstats["chunks"],
                                    launches_now())

    # (5) the CLI's train --joint on the group this script initialized
    exp_dir = Path(spec["work"]) / "cli_joint"
    part("cli", lambda: cli.main([
        "--platform", dev.type, "train", "--joint", "--config",
        spec["config"], "--dataset", spec["wav_dir"], "--exp-dir",
        str(exp_dir), "--epochs", "1"]))
    if rank == 0:
        lines = [json.loads(s) for s in
                 (exp_dir / "metrics.jsonl").read_text().splitlines()]
        out["cli"] = ([m["nll_bits"] for m in lines
                       if m.get("split") == "train"],
                      sorted(p.name for p in (exp_dir / "ckpt").glob(
                          "*.pt")))
    return out


def mesh_phase(torch, dev, exp4, embs, wav_dir, card):
    """Phase 20: the mesh on the card, (a) ``nccl_mesh`` then (b)
    ``gloo_mesh``.  Returns the sharded runs' launches, summed over
    ranks."""
    return add_counts(nccl_mesh(torch, dev, card),
                      gloo_mesh(torch, exp4, embs, wav_dir, card))


def nccl_mesh(torch, dev, card):
    """Phase 20a: a one-rank NCCL mesh in this process (its collectives
    run through NCCL on the card): the float32 flagship through
    ``Trainer.run`` with ``mesh=`` against ``mesh=None``, per-step NLLs,
    parameters and hiddens within 1e-5, with deterministic cuDNN (the
    MLP's window convolution; a second ``mesh=None`` run gives the
    run-to-run floor).  Returns the mesh run's launches."""
    import torch.distributed as dist

    from samplernn_pase_tpu_torch.config import SampleRNNConfig, TrainConfig
    from samplernn_pase_tpu_torch.data.dataset import synthetic_corpus
    from samplernn_pase_tpu_torch.models.pase import conv_numerics
    from samplernn_pase_tpu_torch.parallel import mesh as pm
    from samplernn_pase_tpu_torch.train import trainer as tr

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        cfg32 = SampleRNNConfig(frame_sizes=(16, 4), dim=1024, embed_dim=256,
                                compute_dtype="float32")
        # more utterances than lanes: the held-out tenth leaves every lane
        # one or two
        corpus = synthetic_corpus(n_utts=BATCH + 32, length=2 * SEQ_LEN,
                                  seed=3)
        tcfg = TrainConfig(batch_size=BATCH, seq_len=SEQ_LEN, epochs=1)

        def run(m):
            rec = []

            class Rec(tr.Plugin):
                def on_step(self, t, s, metrics):
                    rec.append(metrics["nll_bits"])
            t = tr.Trainer(cfg32, tcfg, corpus, [Rec()], seed=5, device=dev,
                           mesh=m)
            with conv_numerics():
                t.run()
            return rec, (t.params, list(t.hiddens))
        mesh1 = pm.make_mesh()
        reset_all_launches()
        got = run(mesh1)
        torch.cuda.synchronize()
        launches = launches_now()
        want, again = run(None), run(None)
        err = max(abs(a - b) for a, b in zip(got[0], want[0]))
        perr = tree_diff(torch, got[1], want[1])
        floor = tree_diff(torch, again[1], want[1])
        print(f"phase 20a, one NCCL rank (backend {dist.get_backend()}, "
              f"mesh {dict(zip(mesh1.mesh_dim_names, mesh1.shape))}): the "
              f"float32 flagship through Trainer.run, {len(got[0])} steps "
              f"at B={BATCH}, seq_len {SEQ_LEN}: NLLs within {err:.2e} of "
              f"mesh=None, parameters and hiddens within {perr:.2e} (bound "
              f"1e-5; two mesh=None runs {floor:.2e} apart); "
              f"{time.perf_counter() - t0:.1f} s")
        require(len(got[0]) == len(want[0]) > 0 and err <= 1e-5
                and perr <= 1e-5, "the one-rank NCCL mesh differs from "
                "mesh=None")
    finally:
        dist.destroy_process_group()
    return launches


def gloo_mesh(torch, exp4, embs, wav_dir, card):
    """Phase 20b: two ranks sharing the card over gloo (``mesh_rank``,
    spawned with a deadline; a rank's failure fails the phase): the
    flagship's train step at B=128 sharded over ``data`` (float32 small
    within 1e-5, bf16 full width within phase 4's bars) and over a (1, 2)
    mesh (the MLP split 512/512); config 4 through ``JointTrainer.run`` at
    B=32 for one epoch (per-step NLLs within 0.01 bits of the unsharded
    run's, BatchNorm state equal on both ranks); ``run_jobs`` on 128
    lanes over MESH_JOBS jobs, greedy and with pinned keys, bit-equal to
    the unsharded run, with exact K1 counts per rank; ``cli.main(["train",
    "--joint", ...])`` on both ranks.  The numbers measure gloo's staging
    through the host, not scaling.  Returns the sharded runs' launches,
    summed over ranks."""
    import numpy as np

    from samplernn_pase_tpu_torch.config import SampleRNNConfig
    from samplernn_pase_tpu_torch.ops.kernels.noise import lane_key
    from samplernn_pase_tpu_torch.parallel.launch import run_ranks

    total = {}
    cfg4 = exp4.model
    rows = list(embs.values())
    rng = np.random.default_rng(51)
    jobs = []
    for i in range(MESH_JOBS):
        job = {"id": f"job{i:03d}", "cond": rows[i % len(rows)]}
        if i % 16 == 1:
            job["stream_key"] = lane_key(61, i, 0)
        if i % 16 == 2:
            job["seed_levels"] = rng.integers(0, cfg4.q_levels, 1024)
            job["seed_cond"] = rows[(i + 1) % len(rows)][:7]
        jobs.append(job)
    spec = {"wav_dir": str(wav_dir), "jobs": jobs,
            "keys": [lane_key(62, i, 0) for i in range(MESH_JOBS)],
            "device": "cuda", "batch": BATCH, "seq_len": SEQ_LEN,
            "chunk": C4_CHUNK, "exp4": exp4, "work": str(MESH_WORK),
            "config": str(ROOT / "configs" / "c4_tts_conditioned.json"),
            "flagship": SampleRNNConfig(frame_sizes=(16, 4), dim=1024,
                                        embed_dim=256,
                                        compute_dtype="bfloat16")}
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, 2, (spec,), device=torch.device("cuda", 0),
                      timeout=MESH_TIMEOUT)
    wall_b = time.perf_counter() - t0
    r0, r1 = ranks
    require(r0["device"] == r1["device"] == "cuda:0",
            f"ranks on {r0['device']} and {r1['device']}, not both on cuda:0")
    # (1) the flagship's step
    print(f"phase 20b, two gloo ranks on {r0['device']}: float32 flagship "
          f"(dim 64) step at B={BATCH}, 64 a rank: NLL {r0['f32_nll'][0]:.6f}"
          f" vs {r0['f32_nll'][1]:.6f} unsharded; parameters and hiddens "
          f"within {r0['f32_err']:.2e} (bound 1e-5 + 1e-5 relative)")
    require(r0["f32_ok"] and r1["f32_ok"], "the float32 sharded step "
            "differs from the unsharded step")
    for key, what in (("bf16_dp", "(2,) data"), ("bf16_tp", "(1, 2) "
                      f"(data, model), w_h split {r0['mlp_split']}")):
        for r in ranks:
            ns, nu, rel = r[key]
            require(abs(ns - nu) <= 0.01 and rel <= 0.1,
                    f"{key}: NLL {ns} vs {nu} or gradient {rel} over phase "
                    "4's bars")
        ns, nu, rel = r0[key]
        print(f"  bf16 flagship step at full width on a {what} mesh: NLL "
              f"{ns:.5f} vs {nu:.5f} unsharded (bound 0.01), worst gradient "
              f"relative norm {rel:.4f} (bound 0.1)")
    require(r0["mlp_split"] == (1024, 512), "the MLP is not split 512/512")
    for r in ranks:
        k4 = {k: r["launches"]["bf16_dp_steps"][k]
              for k in ("gru_sequence_fwd", "gru_sequence_bwd")}
        require(k4 == {"gru_sequence_fwd": 6, "gru_sequence_bwd": 6},
                f"K4 launches {k4} in 3 steps on a rank, expected 2 a step")
    print(f"  bf16 flagship step, B=64 a rank: {r0['bf16_dp_ms']:.2f} and "
          f"{r1['bf16_dp_ms']:.2f} ms a step on the two ranks (K4 twice a "
          f"step on each; gloo's host staging, not scaling) on {card}")
    # (3) joint training: the first step's gradients, then the epoch
    for dt in ("bfloat16", "float32"):
        for r in ranks:
            rec = r[f"joint_grads_{dt}"]
            (ns, nu), bars = rec["nll"], (
                [3 * f for f in rec["floor"]] if "floor" in rec
                else [JOINT_BF16_GRAD_BAR] * 2)
            require(abs(ns - nu) <= 1e-4 and all(
                x <= bar for x, bar in zip(rec["rel"], bars)),
                f"config 4's joint step in {dt}: NLL {ns} vs {nu} (bound "
                f"1e-4), gradient relative norms (encoder, SampleRNN) "
                f"{rec['rel']} (bounds {bars})")
        rec = r0[f"joint_grads_{dt}"]
        (rp, rs), (lp, ls) = rec["rel"], rec["leaf"]
        bound = (f"3x the unsharded step's own under a 1e-7 nudge of the "
                 f"params, {rec['floor'][0]:.2e} and {rec['floor'][1]:.2e}"
                 if "floor" in rec else f"{JOINT_BF16_GRAD_BAR}")
        print(f"  config 4 joint step at B=32 (16 a rank), {dt}, from the "
              f"same start: NLL {rec['nll'][0]:.6f} vs {rec['nll'][1]:.6f} "
              f"unsharded (bound 1e-4); gradient relative norm, encoder "
              f"{rp:.2e}, SampleRNN {rs:.2e} (bound {bound}); worst leaf "
              f"{lp:.2e} and {ls:.2e}")
    (nll_s, bn0, p0), (nll_s1, bn1, p1) = r0["joint"], r1["joint"]
    nll_u = r0["joint_plain"][0]
    diffs = [abs(a - b) for a, b in zip(nll_s, nll_u)]
    jerr = max(diffs)
    bn_eq = all(np.array_equal(bn0[k], bn1[k]) for k in bn0)
    print(f"  config 4 JointTrainer.run, one epoch, B=32 (16 a rank): "
          f"{len(nll_s)} steps, NLL {nll_s[0]:.4f} -> {nll_s[-1]:.4f}; "
          f"step 0 within {diffs[0]:.2e} bits of the unsharded run (bound "
          f"1e-4), every step within {jerr:.2e} (bound {JOINT_NLL_BAR}; "
          f"step by step {', '.join(f'{d:.1e}' for d in diffs)}); "
          f"parameters bit-equal on both ranks: {p0 == p1}; "
          f"BatchNorm state equal on both ranks: {bn_eq}; "
          f"{r0['wall']['joint'] / len(nll_s) * 1e3:.1f} ms a step sharded, "
          f"{r0['wall']['joint_plain'] / len(nll_u) * 1e3:.1f} unsharded "
          f"(wall, set-up included)")
    require(nll_s == nll_s1 and len(nll_s) == len(nll_u) > 0
            and diffs[0] <= 1e-4 and jerr <= JOINT_NLL_BAR and p0 == p1
            and bn_eq, "sharded joint training differs")
    # (4) run_jobs
    for name in ("jobs_greedy", "jobs_pinned"):
        (res0, ch0), (res1, ch1) = r0[name], r1[name]
        plain, chp, plain_launch = r0[name + "_plain"]
        same = (set(res0) == set(plain) == set(res1) and all(
            np.array_equal(res0[j], plain[j])
            and np.array_equal(res1[j], plain[j]) for j in plain))
        k1 = [r["launches"][name]["frame_decode_lane_keys"] for r in ranks]
        want_k1 = (decode_launches(cfg4, C4_CHUNK, True)[
            "frame_decode_lane_keys"] * ch0 if name == "jobs_pinned" else 0)
        wall = r0["wall"][name]
        print(f"  run_jobs {name[5:]}: {len(res0)} jobs, {ch0} chunks of "
              f"{C4_CHUNK} on {BATCH} lanes (64 a rank), bit-equal to the "
              f"unsharded run: {same}; K1 lane-key launches per rank {k1} "
              f"(expected {want_k1}, unsharded "
              f"{plain_launch['frame_decode_lane_keys']}); {wall:.2f} s, "
              f"{wall / ch0 * 1e3:.1f} ms a chunk")
        require(same and ch0 == ch1 == chp, f"{name}: sharded jobs differ")
        require(k1 == [want_k1, want_k1] and plain_launch[
            "frame_decode_lane_keys"] == want_k1,
            f"{name}: K1 lane-key launches {k1}, expected {want_k1}")
    # (5) the CLI
    nlls, ckpts = r0["cli"]
    print(f"  cli train --joint on both ranks: {len(nlls)} logged steps, "
          f"NLL {nlls[0]:.4f} -> {nlls[-1]:.4f}, checkpoints {ckpts}; "
          f"{r0['wall']['cli']:.1f} s")
    require(nlls and all(np.isfinite(nlls)) and ckpts,
            "the CLI's train under the world wrote no metrics or checkpoint")
    for r in ranks:
        for counts in r["launches"].values():
            total = add_counts(total, counts)
    print(f"phase 20b: {wall_b:.1f} s (two ranks spawned, each part's wall: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in r0["wall"].items())
          + f") on {card}")
    return total


COUNTED = """import json, runpy, sys
out, mod = sys.argv[1], sys.argv[2]
sys.argv = [mod] + sys.argv[3:]
from samplernn_pase_tpu_torch.ops.kernels import codec, decode, rnn_train
code = 0
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code or 0
with open(out, "w") as f:
    json.dump({**decode.LAUNCHES, **rnn_train.LAUNCHES, **codec.LAUNCHES}, f)
sys.exit(code)
"""


def start_counted(module: str, args=()):
    """Start ``run_module`` through a wrapper that writes the process's
    kernel launches; ``finish_counted`` waits for it."""
    MESH_WORK.mkdir(parents=True, exist_ok=True)
    path = MESH_WORK / f"{module.rsplit('.', 1)[-1]}.launches.json"
    proc = subprocess.Popen([sys.executable, "-c", COUNTED, str(path),
                             module, *args], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return module, args, path, proc, time.perf_counter()


def finish_counted(started, timeout: int = 600):
    """(stdout lines, launches) of a ``start_counted`` process, or
    SmokeFailure on a non-zero exit; the process is killed at the
    timeout (TimeoutExpired)."""
    module, args, path, proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = out.strip().splitlines()
    require(proc.returncode == 0, f"{module} exited {proc.returncode}: "
            + "\n".join((lines + err.strip().splitlines())[-15:]))
    print(f"{module} {' '.join(args)}: {time.perf_counter() - t0:.1f} s")
    return lines, json.loads(path.read_text())


# perf_floor's metrics by the model they run, one process each, so that
# each process's K2 launches are booked to the path whose shapes they have
PERF_FLOOR_GROUPS = (
    ("flagship", ("gen_flagship_2tier_gru", "train_step_ms_b128_seq1024")),
    ("c2", ("gen_3tier_lstm", "train_lstm3_step_ms_b64_seq1024")),
    ("c4", ("gen_conditioned_tts", "train_joint_step_ms_b32_seq1280")))


def twins_phase(card):
    """Phase 21: the bench_host and perf_floor twins and the four
    examples, each in its own process on the card (the examples side by
    side): each prints its line
    with no skip, perf_floor exits 0 (every floor holds).  Returns their
    launches by path: "flagship" (bench_host and perf_floor's flagship
    metrics), "c2" and "c4" (perf_floor's metrics on config 2's and config
    4's models) and "examples" (their own small models)."""
    lines, flagship = finish_counted(start_counted(
        "samplernn_pase_tpu_torch.scripts.bench_host"))
    rec = json.loads(lines[-1])
    print(json.dumps(rec))
    require("skipped" not in rec and rec["headroom_native_x"] > 4,
            "bench_host: skipped, or host batching under 4x the card's rate")
    by = {}
    for path, names in PERF_FLOOR_GROUPS:
        lines, n = finish_counted(start_counted(
            "samplernn_pase_tpu_torch.scripts.perf_floor",
            [a for m in names for a in ("--metric", m)]))
        recs = [json.loads(s) for s in lines if s.startswith("{")]
        for rec in recs:
            print(json.dumps(rec))
        require([r["metric"] for r in recs] == list(names)
                and all(r.get("ok") for r in recs),
                f"perf_floor {names}: a floor did not hold, or a line is "
                "missing")
        by[path] = n
    by["flagship"] = add_counts(by["flagship"], flagship)
    # the examples hold no time, so the four run side by side
    by["examples"] = {}
    checks = (("train_and_generate", "bits/sample over"),
              ("tts_speakers", "wrote 4 wavs"),
              ("serving_stream", "conditioned stream == one-shot"),
              ("pool_serving", "sampled pool lane A == solo"))
    started = []
    try:
        for name, _ in checks:
            out = MESH_WORK / f"example_{name}"
            started.append(start_counted(
                f"samplernn_pase_tpu_torch.examples.{name}",
                (str(out if name in ("train_and_generate", "tts_speakers")
                     else out.with_suffix(".wav")),)))
        for (name, ok), proc in zip(checks, started):
            lines, n = finish_counted(proc)
            print("  " + " | ".join(lines[-3:]))
            require(any(ok in s for s in lines)
                    and "device: cuda" in lines[0],
                    f"example {name} did not print its check on the card")
            by["examples"] = add_counts(by["examples"], n)
    finally:
        for *_, proc, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for path, n in by.items():
        print(f"phase 21 launches, {path}: {n} on {card}")
    return by


def check_bounds(entries):
    """No ``kernels`` entry, and no ``by_path`` or ``projection``
    sub-entry, may read faster than its bound: such a time is a
    measurement fault.  Raises SmokeFailure naming each."""
    low = []
    for e in entries:
        subs = [(e["name"], e)]
        subs += [(f"{e['name']}.by_path.{p}", s)
                 for p, s in e.get("by_path", {}).items()]
        if "projection" in e:
            subs.append((f"{e['name']}.projection", e["projection"]))
        low += [f"{n} ms {s['ms']} < bound_ms {s['bound_ms']}"
                for n, s in subs if s["ms"] < s["bound_ms"]]
    require(not low, "kernels entries below their bound: " + "; ".join(low))


def run_module(module: str, args=(), timeout: int = 600) -> list[str]:
    """``python -m module args`` from the repo root, as a user runs it:
    its stdout lines, or SmokeFailure on a non-zero exit."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    lines = res.stdout.strip().splitlines()
    require(res.returncode == 0, f"{module} exited {res.returncode}: "
            + "\n".join((lines + res.stderr.strip().splitlines())[-15:]))
    print(f"{module} {' '.join(args)}: {time.perf_counter() - t0:.1f} s")
    return lines


def entry_points(card):
    """Phases 13-14: the quality smoke's full mode and the two bench
    twins, each in its own process on the card."""
    lines = run_module("samplernn_pase_tpu_torch.scripts.quality_smoke")
    for line in lines:
        print(f"  {line}")
    require("quality smoke OK" in lines,
            "the quality smoke did not print OK")
    out = {}
    for module in ("samplernn_pase_tpu_torch.bench",
                   "samplernn_pase_tpu_torch.scripts.bench_train"):
        rec = json.loads(run_module(module)[-1])
        print(json.dumps(rec))
        require("skipped" not in rec and rec.get("value", 0) > 0,
                f"{module}: {rec}")
        out[module] = rec
    print(f"bench twins on {card}: " + "; ".join(
        f"{r['metric']} {r['value']:,}" for r in out.values()))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    if not (ROOT / "samplernn_pase_tpu_torch" / "ops" / "kernels").is_dir():
        return fail(f"the port (samplernn_pase_tpu_torch) is not beside "
                    f"{Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.config import (
        SampleRNNConfig, load_config, preset)
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
        regs, spills, fn = [], [], ""
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = kernel_name(line.split("for", 1)[1].strip())
            elif "spill stores" in line and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores"):
                spills.append(f"{fn}: {line.strip()}")
            elif "Used" in line and "registers" in line:
                regs.append(int(line.split("Used")[1].split()[0]))
        print(f"  {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}; spills: "
              + ("; ".join(spills) if spills else "none"))
    # config 2 (the 3-tier LSTM): the preset's model (mlp_hidden 0 means
    # dim), the JSON's training and generation settings
    import dataclasses
    exp2 = load_config(ROOT / "configs" / "c2_3tier_lstm.json")
    model2 = preset("c2_3tier_lstm").model
    if dataclasses.replace(exp2.model, mlp_hidden=0) != model2:
        return fail("configs/c2_3tier_lstm.json and preset('c2_3tier_lstm') "
                    "disagree on the model")
    exp2 = dataclasses.replace(exp2, model=model2)
    c2_tiers = tuple(exp2.train.seq_len // s for s in exp2.model.tier_spans)
    # config 4 (conditioned TTS), checked the same way
    exp4 = load_config(ROOT / "configs" / "c4_tts_conditioned.json")
    model4 = preset("c4_tts_conditioned").model
    if dataclasses.replace(exp4.model, mlp_hidden=0) != model4:
        return fail("configs/c4_tts_conditioned.json and "
                    "preset('c4_tts_conditioned') disagree on the model")
    exp4 = dataclasses.replace(exp4, model=model4)
    # the stacked flagship: c5_gen_b128's model with two GRU layers per
    # tier and weight norm (samplernn-pytorch's default model)
    cfg5 = dataclasses.replace(
        load_config(ROOT / "configs" / "c5_gen_b128.json").model, n_rnn=2,
        weight_norm=True)

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
    t0 = time.perf_counter()
    params2 = samplernn.init_params(torch.Generator().manual_seed(5),
                                    exp2.model, dev)
    weights2 = tgen.prepare_weights(params2, exp2.model, dev)
    torch.cuda.synchronize()
    print(f"config 2 params and kernel weights: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    params4 = samplernn.init_params(torch.Generator().manual_seed(9),
                                    exp4.model, dev)
    weights4 = tgen.prepare_weights(params4, exp4.model, dev)
    torch.cuda.synchronize()
    print(f"config 4 params and kernel weights: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    params5 = samplernn.init_params(torch.Generator().manual_seed(13), cfg5,
                                    dev)
    weights5 = tgen.prepare_weights(params5, cfg5, dev)
    torch.cuda.synchronize()
    print(f"stacked flagship params and kernel weights: "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    t0w = time.perf_counter()

    # ---- 2a. K2 gemm_bias at both decode paths' shapes ----
    # launches are counted over each path's run in phase 3 / 5: three
    # requests (two generate_levels, one make_generator, which prepares
    # the MLP once) of LENGTH / C2_LENGTH samples
    t0t = weights["tiers"][0]
    cases, h, win = k2_cases(torch, dev, gen, cfg, params, weights, b,
                             3 * LENGTH // cfg.lookback)
    cases2, _, _ = k2_cases(torch, dev,
                            torch.Generator(device=dev).manual_seed(8),
                            exp2.model, params2, weights2, b,
                            3 * C2_LENGTH // exp2.model.lookback)
    cases5, _, _ = k2_cases(torch, dev,
                            torch.Generator(device=dev).manual_seed(14),
                            cfg5, params5, weights5, b,
                            3 * LENGTH // cfg5.lookback)
    try:
        k2 = {"flagship": check_gemm(torch, dev, kdec, cases, "flagship"),
              "c2_3tier_lstm": check_gemm(torch, dev, kdec, cases2,
                                          "config 2"),
              "stacked_flagship": check_gemm(torch, dev, kdec, cases5,
                                             "stacked")}
        for cs, path in ((cases, "flagship"), (cases2, "config 2")):
            check_rows_independent(torch, kdec, cs, path)
        # K2's epilogue terms one at a time, beside addmm
        from samplernn_pase_tpu_torch.scripts import gemm_ablation
        ablation = gemm_ablation.run(dev)
    except (SmokeFailure, RuntimeError) as err:
        return fail(str(err))

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
    # config 4's modes, f32 small: K1 lane keys, and the conditioned
    # whole path (K2's epilogue) with lane keys and per-lane positions
    from samplernn_pase_tpu_torch.ops.kernels.noise import lane_key
    skeys = [lane_key(6, i, 0) for i in range(8)]
    spos = torch.arange(8, device=dev) * 5
    got = kdec.frame_decode(swin, scond, None, smw, 0.9, None, 0, 50,
                            lane_keys=skeys, lane_pos=spos)
    want = kdec.frame_decode_plain(swin, scond, None, smw, 0.9, None, 0, 50,
                                   lane_keys=skeys, lane_pos=spos)
    err1k = (got - want).abs().max().item()
    if not torch.equal(got, want):
        return fail("frame_decode f32 lane keys: samples differ")
    small4 = dataclasses.replace(small, cond_dim=16, cond_rate=12)
    sp4 = samplernn.init_params(torch.Generator().manual_seed(3), small4, dev)
    sw4 = tgen.prepare_weights(sp4, small4, dev)
    scpos = torch.arange(8, device=dev) * 7
    proj = tgen.project_cond(
        sw4, small4, torch.randn(8, 6, 16, device=dev, generator=gen),
        scpos, 4 * small4.lookback)
    for temp in (0.0, 0.9):
        kw = dict(n_top=4, weights_dtype="float32", pos0=spos,
                  lane_keys=skeys, cond_rate=proj[2], ext_proj=proj[0],
                  cond_phase=proj[1])
        got, gs = megagen.generate_full(sw, sst, temp, sp4["tiers"],
                                        sp4["mlp"], **kw)
        want, ws = megagen.generate_full_plain(sw, sst, temp, sp4["tiers"],
                                               sp4["mlp"], **kw)
        serr = max((x - y).abs().max().item() for x, y in zip(gs, ws))
        if not torch.equal(got, want) or serr > 1e-5:
            return fail(f"conditioned generate_full f32 T={temp}: samples "
                        f"differ or state err {serr} > 1e-5")
    print("K1/K2/K3 f32 small shapes: samples equal to the plain versions "
          "(K1 with lane keys, conditioned generate_full with K2's "
          "epilogue, states within 1e-5)")

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
    plan1 = kdec.frame_plan(hdim, q, f1, torch.bfloat16)
    print(f"K1 frame_decode [B={b}, f1={f1}] bf16 plan {tuple(plan1)}: "
          f"rescoring agreement greedy {k1[0.0]:.4f} sampled "
          f"{k1[0.95]:.4f}; {ms1 * 1e3:.1f} us (wall per call "
          f"{wall1 * 1e3:.1f} us), {ms1 * 1e3 / f1:.2f} us per step, "
          f"plain {pms1 * 1e3:.1f} us, bound "
          f"{b1 * 1e3:.2f} us ({by1}, {rows} W' rows)")

    # ---- 2d-2f. K4 and K5 forward and backward, K6 ----
    try:
        k4 = check_sequence(torch, dev, rt, "gru", BATCH,
                            tuple(SEQ_LEN // s for s in cfg.tier_spans),
                            cfg.dim)
        k5 = check_sequence(torch, dev, rt, "lstm", exp2.train.batch_size,
                            c2_tiers, exp2.model.dim)
        k6 = check_lstm_gates(torch, dev, kdec, BATCH, exp2.model.dim)
        # phase 7's calls: 4 requests and one split in 4, 5 requests' worth
        k2c, k2p, k1c = c4_kernel_checks(torch, dev, kdec, tgen, exp4.model,
                                         weights4, BATCH, 5)
        # this slice's kernels and the kernel route's wider scope
        k7 = codec_checks(torch, dev)
        k89 = roofline_checks(torch, dev)
        scope_checks(torch, dev)
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
    want = {k: 3 * v for k, v in decode_launches(cfg, LENGTH).items()}
    want["gemm_bias"] += f1                   # make_generator's MLP fold
    if launches != want:
        return fail(f"flagship launches {launches}, expected {want}")
    if launches["gemm_bias"] != k2["flagship"]["launches"]:
        return fail(f"gemm_bias: {launches['gemm_bias']} launches on the "
                    f"flagship path, expected {k2['flagship']['launches']}")
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
        g = kernel_group(key, groups)
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
    # bench.py's request: 16,384 samples, B=128, T=0.95
    kdec.reset_launches()
    t0 = time.perf_counter()
    long = tgen.generate_levels(params, cfg, b, BENCH_LENGTH, 0.95, seed=2,
                                device=dev, kernel_weights=weights)
    torch.cuda.synchronize()
    t_long = time.perf_counter() - t0
    want = decode_launches(cfg, BENCH_LENGTH)
    if dict(kdec.LAUNCHES) != want:
        return fail(f"16,384-sample request: launches {dict(kdec.LAUNCHES)},"
                    f" expected {want}")
    if (long.shape != (b, BENCH_LENGTH) or long.min().item() < 0
            or long.max().item() >= q):
        return fail(f"16,384-sample request: shape {tuple(long.shape)} or "
                    "levels out of range")
    print(f"bench.py's request (B={b}, {BENCH_LENGTH} samples, T=0.95): "
          f"{b * BENCH_LENGTH / t_long:,.0f} samples/s ({t_long:.3f} s, "
          f"{t_long * 1e3 / (BENCH_LENGTH // cfg.lookback):.3f} ms per top "
          f"frame) on {card}")

    # ---- 4. the training path at full width ----
    t0 = time.perf_counter()
    try:
        k4_launches = train_path(torch, dev, cfg, params, card)
    except SmokeFailure as err:
        return fail(str(err))
    print(f"phase 4 (training path): {time.perf_counter() - t0:.1f} s")

    # ---- 5-6. config 2: generation and training ----
    t0 = time.perf_counter()
    try:
        c2_launches = c2_generation(torch, dev, exp2, params2, weights2,
                                    k2["c2_3tier_lstm"]["launches"], card)
        print(f"phase 5 (config 2 generation): "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        k5_launches = c2_train_path(torch, dev, exp2, card)
    except SmokeFailure as err:
        return fail(str(err))
    print(f"phase 6 (config 2 training): {time.perf_counter() - t0:.1f} s")

    # ---- 7-8. config 4: conditioned generation and stream serving ----
    t0 = time.perf_counter()
    try:
        c4_launches = c4_generation(torch, dev, exp4, params4, weights4, card)
        print(f"phase 7 (config 4 generation): "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pool_launches = c4_serving(torch, dev, exp4, params4, card)
    except SmokeFailure as err:
        return fail(str(err))
    print(f"phase 8 (config 4 serving): {time.perf_counter() - t0:.1f} s")
    c4_all = add_counts(c4_launches, pool_launches)

    # ---- 9-11. the stacked flagship, and the roofline entry point ----
    t0 = time.perf_counter()
    try:
        s5_launches = stacked_generation(
            torch, dev, cfg5, params5, weights5,
            k2["stacked_flagship"]["launches"], card)
        s5_pool = stacked_serving(torch, dev, cfg5, params5, card)
        print(f"phase 9 (stacked flagship generation and serving): "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        s5_train = train_path(torch, dev, cfg5, params5, card,
                              name="stacked flagship", entry=False)
        print(f"phase 10 (stacked flagship training): "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        k89_launches, _ = roofline_path(torch, dev)
    except SmokeFailure as err:
        return fail(str(err))
    print(f"phase 11 (roofline entry point): {time.perf_counter() - t0:.1f} s")
    s5_all = add_counts(s5_launches, s5_pool)

    # ---- 12-14. config 4 through Trainer.run; the measured entry points
    t0 = time.perf_counter()
    try:
        c12 = c4_trainer(torch, dev, exp4, params4, card)
        print(f"phase 12 (config 4 through Trainer.run, resume): "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entry_points(card)
    except (SmokeFailure, subprocess.TimeoutExpired) as err:
        return fail(str(err))
    print(f"phases 13-14 (quality smoke, bench twins): "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 15-18. config 4's TTS pipeline: extraction (config 3's
    # encoder), joint training, batch synthesis; the bench_pool twin
    import shutil
    t0 = time.perf_counter()
    try:
        exp3 = load_config(ROOT / "configs" / "c3_pase_extract.json")
        require(exp3.pase == preset("c3_pase_extract").pase == exp4.pase,
                "configs 3 and 4 and the presets disagree on the encoder")
        wav_dir = tts_corpus(exp4.model, exp4.train.seq_len)
        embs = c3_extraction(torch, dev, exp3.pase, wav_dir, card)
        print(f"phase 15 (config 3 extraction): "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        c16, joint_ms = c4_joint(torch, dev, exp4, wav_dir, card)
        print(f"phase 16 (config 4 through JointTrainer.run, resume): "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        c17 = c4_jobs(torch, dev, exp4, params4, embs, card)
        print(f"phase 17 (run_jobs): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bench_pool_twin(card)
        print(f"phase 18 (bench_pool twin): "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        c19, c19_folds, c19_uncond = c4_cli(torch, dev, exp3, wav_dir, card,
                                            joint_ms)
        print(f"phase 19 (config 4's TTS pipeline through the CLI): "
              f"{time.perf_counter() - t0:.1f} s")
        # ---- 20-21. the mesh on the card; the remaining twins ----
        shutil.rmtree(MESH_WORK, ignore_errors=True)
        t0 = time.perf_counter()
        c20 = mesh_phase(torch, dev, exp4, embs, wav_dir, card)
        print(f"phase 20 (the mesh: one NCCL rank, two gloo ranks on the "
              f"card): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        c21 = twins_phase(card)
        print(f"phase 21 (bench_host, perf_floor, the four examples): "
              f"{time.perf_counter() - t0:.1f} s")
    except (SmokeFailure, subprocess.TimeoutExpired, RuntimeError) as err:
        return fail(str(err))
    finally:
        shutil.rmtree(TTS_WORK, ignore_errors=True)
        shutil.rmtree(MESH_WORK, ignore_errors=True)
    # phases 20-21's launches; their K2 launches by the path that made
    # them: phase 20's (its run_jobs) and perf_floor's config 4 metrics
    # are config 4's, with one MLP fold per pool on each rank (two pools)
    # and one for perf_floor's generator; the examples' small models are
    # counted but weigh in no K2 time
    c2021 = add_counts(c20, {})
    for n in c21.values():
        c2021 = add_counts(c2021, n)
    c4_mesh = add_counts(c20, c21["c4"])
    mesh_folds = 2 * 2 + 1
    ex = c21["examples"]
    ex_k2 = {"gemm_bias": ex["gemm_bias"] - ex["gemm_bias_cond"],
             "gemm_bias_cond": ex["gemm_bias_cond"]}
    if (c4_mesh["gemm_bias"] - 4 * c4_mesh["gemm_bias_cond"]
            < mesh_folds * exp4.model.frame_sizes[0]):
        return fail(f"config 4's K2 launches in phases 20-21 {c4_mesh} hold "
                    "fewer than 3 projections a conditioned tier step and "
                    "the MLP folds")
    # config 4's paths of phases 7, 8, 12, 16, 17 and 19, and their MLP
    # folds (one per request or pool, two in phase 7; phase 19 counts its
    # own)
    c4_all = add_counts(add_counts(add_counts(c4_all, c12),
                                   add_counts(c16, c17)), c19)
    c4_folds = 5 + c19_folds
    # generation without lane keys: phases 12 and 16, phase 19's generate
    c4_gen = add_counts(c12, c16)
    c19_gen = c19["frame_decode"] - c19["frame_decode_lane_keys"]

    # ---- 22. the result lines ----
    # K2 over the decode paths, each case weighted by its launches there;
    # phase 19's tier steps without conditioning rows are the flagship's
    # products (config 4's model has the flagship's widths)
    k2_runs = {"flagship": launches["gemm_bias"] + c19_uncond
               + c21["flagship"]["gemm_bias"],
               "c2_3tier_lstm": c2_launches["gemm_bias"]
               + c21["c2"]["gemm_bias"],
               "stacked_flagship": s5_launches["gemm_bias"]}
    k2n = sum(k2_runs.values())
    if c21["flagship"]["gemm_bias_cond"] or c21["c2"]["gemm_bias_cond"]:
        return fail("conditioned K2 launches on an unconditioned path")
    k2_all = {key: sum(k2[p][key] * k2_runs[p] for p in k2) / k2n
              for key in ("ms", "plain", "lib", "bound")}
    k2_by = {}
    for st in k2.values():
        for by, cnt in st["by"].items():
            k2_by[by] = k2_by.get(by, 0) + cnt
    line = {"kernels": [
        {"name": "frame_decode", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/frame_decode.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/decode.py:218",
         "launches": launches["frame_decode"] + s5_all["frame_decode"]
         + c4_gen["frame_decode"] + c19_gen + c2021["frame_decode"]
         - c2021["frame_decode_lane_keys"],
         "max_abs_err": err1,
         "ms": ms1, "plain_ms": pms1, "bound_ms": b1, "bound_by": by1,
         "library_ms": None, "us_per_step": ms1 * 1e3 / f1},
        {"name": "gemm_bias", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/gemm_bias.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/megagen.py:496",
         "launches": k2n + ex_k2["gemm_bias"],
         "unweighted_launches": {"examples": ex_k2["gemm_bias"]},
         "max_abs_err": max(st["err"] for st in k2.values()),
         "ms": k2_all["ms"], "plain_ms": k2_all["plain"],
         "bound_ms": k2_all["bound"], "bound_by": max(k2_by, key=k2_by.get),
         "library_ms": k2_all["lib"],
         "ablation": ablation,
         "by_path": {p: {"launches": k2_runs[p], "ms": st["ms"],
                         "plain_ms": st["plain"], "bound_ms": st["bound"],
                         "library_ms": st["lib"]} for p, st in k2.items()}},
        {"name": "gru_gates", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/gru_gates.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/decode.py:153",
         "launches": launches["gru_gates"] + s5_all["gru_gates"]
         + c4_gen["gru_gates"] + c17["gru_gates"] + c19["gru_gates"]
         + c2021["gru_gates"],
         "max_abs_err": err3,
         "ms": ms3, "plain_ms": pms3, "bound_ms": b3, "bound_by": by3,
         "library_ms": lms3},
        {"name": "lstm_gates", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/lstm_gates.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/decode.py:153",
         "launches": c2_launches["lstm_gates"] + c2021["lstm_gates"],
         "max_abs_err": k6[0],
         "ms": k6[1], "plain_ms": k6[2], "bound_ms": k6[4],
         "bound_by": k6[5], "library_ms": k6[3]},
        # config 4's modes of the megakernel (megagen.py:196-220 tier_in,
        # :139-166 and :397-415 host noise), counted over phases 7, 8, 12,
        # 16, 17 and 19
        {"name": "gemm_bias_cond", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/gemm_bias.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/megagen.py:496",
         "launches": c4_all["gemm_bias_cond"] + c4_mesh["gemm_bias_cond"]
         + ex_k2["gemm_bias_cond"],
         "unweighted_launches": {"examples": ex_k2["gemm_bias_cond"]},
         "max_abs_err": k2c["err"],
         "ms": k2c["ms"], "plain_ms": k2c["plain"],
         "bound_ms": k2c["bound"], "bound_by": max(k2c["by"],
                                                   key=k2c["by"].get),
         "library_ms": k2c["lib"],
         # the other K2 launches of those phases: per tier step 3 more
         # than the conditioned input, and the MLP folds
         "projection": {"launches": c4_all["gemm_bias"]
                        + c4_mesh["gemm_bias"]
                        - 4 * (c4_all["gemm_bias_cond"]
                               + c4_mesh["gemm_bias_cond"])
                        - (c4_folds + mesh_folds)
                        * exp4.model.frame_sizes[0] - c19_uncond,
                        "max_abs_err": k2p["err"], "ms": k2p["ms"],
                        "plain_ms": k2p["plain"], "bound_ms": k2p["bound"],
                        "library_ms": k2p["lib"]}},
        {"name": "frame_decode_lane_keys", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/frame_decode.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/megagen.py:496",
         "launches": c4_all["frame_decode_lane_keys"]
         + c2021["frame_decode_lane_keys"], "max_abs_err": err1k,
         "max_abs_err_at": "float32 B=8 f1=4 H=64",
         "rescore_bf16": k1c["agree"], "ms": k1c["ms"],
         "plain_ms": k1c["plain"], "bound_ms": k1c["bound"],
         "bound_by": k1c["by"], "library_ms": None},
        # this slice's kernels: the codec on the stacked flagship's
        # generate() path, the roofline pair on the script's own
    ] + [
        {"name": f"codec_{d}", "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/codec.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/codec.py:35",
         "launches": s5_launches[f"codec_{d}"] + c4_gen[f"codec_{d}"]
         + c17[f"codec_{d}"] + c19[f"codec_{d}"] + c2021[f"codec_{d}"],
         "max_abs_err": k7[d]["err"], "ms": k7[d]["ms"],
         "plain_ms": k7[d]["plain"], "bound_ms": k7[d]["bound"],
         "bound_by": k7[d]["by"], "library_ms": None}
        for d in ("encode", "decode")
    ] + [
        {"name": name, "route": "cuda",
         "source": "samplernn_pase_tpu_torch/ops/kernels/csrc/roofline.cu",
         "replaces": f"scripts/vpu_ceiling.py:{line}",
         "launches": k89_launches[name], "max_abs_err": k89[name]["err"],
         "ms": k89[name]["ms"], "plain_ms": k89[name]["plain"],
         "bound_ms": k89[name]["bound"], "bound_by": k89[name]["by"],
         "library_ms": k89[name]["lib"]}
        for name, line in (("vpu_tail", 95), ("mxu_stream", 146))
    ] + [
        {"name": f"{cell}_sequence_{d}", "route": "cuda",
         "source": f"samplernn_pase_tpu_torch/ops/kernels/csrc/"
                   f"{cell}_sequence.cu",
         "replaces": "samplernn_pase_tpu/ops/pallas/rnn_train.py:"
                     f"{SEQ[cell]['pallas'][d == 'bwd']}",
         "launches": seq_launches[f"{cell}_sequence_{d}"],
         "max_abs_err": st[d]["err"],
         "max_abs_err_at": "float32 N=6 B=4 H=128",
         "max_rel_err_bf16": st[d]["rel_bf16"],
         "max_rel_err_bf16_at": f"bfloat16 N={tiers}, B={nb}, H=1024 (the "
                                "timed shapes), of max|plain|",
         "ms": st[d]["ms"],
         "plain_ms": st[d]["plain"], "bound_ms": st[d]["bound"],
         "bound_by": max(st[d]["by"], key=st[d]["by"].get),
         "library_ms": st[d]["lib"]}
        for cell, st, seq_launches, tiers, nb in (
            ("gru", k4, add_counts(add_counts(k4_launches, s5_train),
                                   add_counts(add_counts(c4_gen, c17),
                                              add_counts(c19, c2021))),
             "64 and 16", BATCH),
            ("lstm", k5, add_counts(k5_launches, c2021), "64, 16 and 4",
             exp2.train.batch_size))
        for d in ("fwd", "bwd")
    ]}
    print(json.dumps(line))
    try:
        check_bounds(line["kernels"])
    except SmokeFailure as err:
        return fail(str(err))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
