"""K8 and K9, the roofline microkernels for K1, and the script that times
them on the card: the counterpart of ``scripts/vpu_ceiling.py``.

    python -m samplernn_pase_tpu_torch.scripts.vpu_ceiling [--smoke]
    python -m samplernn_pase_tpu_torch.scripts.vpu_ceiling --trace
                                                  [--root DIR]

K1 (``csrc/frame_decode.cu``) takes most of the device time on every
generation path.  Its per-step instruction stream has two halves, timed
here in isolation at the flagship's shapes (B=128, H=1024, q=256, f1=16,
bf16 weights), as the reference times its megakernel's:

* K8 ``vpu_tail`` (``csrc/roofline.cu``): the serial sampler tail, per
  frame the Gumbel block (Philox, the port's in-kernel noise, or the
  supplied ``gum``), then f1 steps of ``logits + T*g``, argmax over q and
  a one-hot bf16 write into the ``[B, f1*q]`` ring.  Producer warps draw
  the noise into a ring of shared-memory slots ahead of the chain warp;
  ``vpu_plan`` (a pure function of q and f1) sets their count, the slot
  depth and the ring.
* K9 ``mxu_stream``: the per-step product stream, bf16 in and float32
  accumulate: the window head and tail ``[B,(f1-1)q]x[(f1-1)q,H] +
  [B,q]x[q,H]``, ``[B,H]x[H,H]``, ``[B,H]x[H,q]`` and the per-frame hoist
  ``[B,H]x[H,f1*H]``.

The script prints one JSON line per component (us per generated step),
the real path's (the flagship's sampled generation through K1-K3, per
step), and a summary with the envelope [max, sum] of the two halves.
K1's real stream is not this one (``k1_differs`` in the summary).
``--smoke`` runs the plain versions on the CPU at the flagship's shapes.

``--trace`` prints where a step of K8 goes instead, at the flagship's
shape with Philox noise over ``N_STEPS // F1`` frames: the launch runs the
kernel's traced instantiation (``srnn_vpu_tail_trace``), in which block 0
writes ``clock64()`` at each phase of the first ``TRACE_FRAMES`` frames,
and the script prints the mean us (cycles over the SM clock, read from
``%globaltimer`` beside ``clock64`` at block 0's entry and exit) of each
phase per frame and per step over frames 1 .. TRACE_FRAMES - 1, in the
chain's order: ``scores`` (the scores and the lane's max), ``noise`` (the
next step's noise: the wait for its slot where one starts, the loads
issued), ``reduce`` (the warp's argmax), ``store`` (the ring) and
``roll`` (the window kept); the producers' mean wait for a free slot and
fill per slot; then K8's device us per call, untraced and traced (after
``WARM_S`` seconds of calls), and ``CHECKED_CALLS`` calls timed one by one
(CUDA events), each call's samples and ring held bit-equal to the plain
version.  ``--root DIR`` also times ``DIR``'s K8 (a checkout holding
``samplernn_pase_tpu_torch``, e.g. a ``git archive`` of the parent under
``build/``) through its own wrapper in a subprocess on the same inputs, in
the order root, this tree, this tree, root.  The last line is one JSON
object.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.  A run without ``--smoke`` needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from samplernn_pase_tpu_torch.ops.kernels import _build
from samplernn_pase_tpu_torch.ops.kernels.decode import gemm_plan
from samplernn_pase_tpu_torch.ops.kernels.noise import gumbel_block

B, H, Q, F1 = 128, 1024, 256, 16
HEAD = (F1 - 1) * Q            # fused-embed window head rows
N_STEPS = 4096                 # samples per timed call
N_REP = 4
TEMPERATURE = 0.9              # the reference's vpu_tail temperature

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"vpu_tail": 0, "mxu_stream": 0}
# K8's phase trace (csrc/roofline.cu): TRACE_PER int64 per traced frame,
# block 0's entry and exit clocks, three per traced chunk; a step's
# points, in order
TRACE_FRAMES, TRACE_PER, TRACE_CHUNKS = 16, 168, 64
TRACE_WORDS = TRACE_FRAMES * TRACE_PER + 4 + 3 * TRACE_CHUNKS
PHASES = ("scores", "noise", "reduce", "store", "roll")
TRACE_REPS = 10

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "vpu_tail": ("srnn_vpu_tail", [_P, _P, _I, ctypes.c_uint64,
                                   ctypes.c_float, _I, _P, _P] + [_I] * 7
                 + [_P]),
    "mxu_stream": ("srnn_mxu_stream", [_P] * 10 + [_I] * 5 + [_P, _P]),
}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launch(name, *args):
    err = _build.function("roofline", *_SIGNATURES[name])(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ----------------------------------------------------------------- K8 --

VPU_SMEM_MAX = 232448     # dynamic shared memory a block can have (227 KiB)
VPU_SMEM_ALONE = 118784   # more than half an SM's 228 KiB (less 1 KiB a
                          # block): one block per SM
VPU_MAX_WARPS = 16        # the kernel's launch bound (csrc: MAX_WARPS)
VPU_PRODUCERS = 6         # producer warps beside the chain warp (counts
                          # 3-12 ran within 2% on the card: PERF.md)
VPU_SLOT_STEPS = 16       # at most this many steps of noise per slot


def vpu_warps(producers: int) -> int:
    """K8's warps per block: the chain warp, the producers, and the warps
    left idle so that no producer shares the chain's SM sub-partition
    (every fourth warp; csrc: vpu_warps)."""
    return producers + 1 + (producers - 1) // 3


class VpuPlan(NamedTuple):
    """How K8 runs a lane: ``producers`` warps draw the noise beside the
    chain warp into a ring of ``slots`` slots of ``steps`` steps each
    (``steps`` divides f1, so a frame's steps fill whole slots); ``smem``:
    dynamic shared memory bytes per block (the ring and two mbarriers per
    slot, and never less than ``VPU_SMEM_ALONE``, so that no two lanes'
    chains share an SM)."""
    producers: int
    steps: int
    slots: int
    smem: int


def vpu_plan(q: int, f1: int) -> VpuPlan:
    """K8's plan: a pure function of q and f1 (never of the batch: each
    lane runs the same instructions whatever B is).  ``VPU_PRODUCERS``
    producer warps; the ring holds two slots per producer; a slot is the
    largest divisor of f1 up to
    ``VPU_SLOT_STEPS`` steps for which they fit in ``VPU_SMEM_MAX``.
    Shapes K8 does not take raise ValueError with the reason."""
    if q % 128 or not 128 <= q <= 1024:
        raise ValueError(f"vpu_plan: q={q} must be a multiple of 128 up to "
                         "1024 (the chain warp holds q/32 levels per lane "
                         "in 16-byte groups)")
    if not 1 <= f1 <= 32:
        raise ValueError(f"vpu_plan: f1={f1} must be in 1..32 (one chain "
                         "lane per ring slot)")
    slots = 2 * VPU_PRODUCERS
    for steps in range(min(VPU_SLOT_STEPS, f1), 0, -1):
        smem = max(VPU_SMEM_ALONE, slots * steps * q * 4 + 16 * slots)
        if f1 % steps == 0 and smem <= VPU_SMEM_MAX:
            return VpuPlan(VPU_PRODUCERS, steps, slots, smem)
    raise ValueError(f"vpu_plan: {slots} slots of one step at q={q} do not "
                     f"fit in {VPU_SMEM_MAX} bytes")


def vpu_tail_plain(logits, gum, seed, *, n_frames, use_prng):
    """Plain version of K8 -> (samples [B, f1] int32, ring [B, f1*q]
    bf16)."""
    b, q = logits.shape
    f1 = gum.shape[0]
    ring = torch.zeros((b, f1 * q), dtype=torch.bfloat16,
                       device=logits.device)
    blk = torch.zeros((b, f1), dtype=torch.int32, device=logits.device)
    levels = torch.arange(q, device=logits.device)
    for t in range(n_frames):
        g = (gumbel_block(int(seed), b, t * f1, f1, q, logits.device)
             if use_prng else gum)
        for i in range(f1):
            sample = torch.argmax(logits + TEMPERATURE * g[i], dim=-1)
            slot = (t + i) % f1
            ring[:, slot * q:(slot + 1) * q] = (
                levels == sample[:, None]).to(torch.bfloat16)
            blk = torch.cat([blk[:, 1:], sample[:, None].to(torch.int32)], 1)
    return blk, ring


def vpu_tail(logits, gum, seed, *, n_frames, use_prng, return_ring=False):
    """K8: the serial sampler tail over ``n_frames`` frames, at the
    reference's temperature (0.9).

    logits [B, q] float32; gum [f1, B, q] float32, the noise of every frame
    (read when ``use_prng`` is False); with ``use_prng`` the noise of step
    i of frame t is Philox keyed by ``seed`` at position t*f1 + i
    (``noise.gumbel_block``).  Returns the last f1 samples [B, f1] int32
    (and the one-hot ring [B, f1*q] bf16 with ``return_ring``).  The
    kernel runs under ``vpu_plan(q, f1)``."""
    if logits.device.type == "cpu":
        out, ring = vpu_tail_plain(logits, gum, seed, n_frames=n_frames,
                                   use_prng=use_prng)
        return (out, ring) if return_ring else out
    b, q = logits.shape
    f1 = gum.shape[0]
    for name, t, shape in (("logits", logits, (b, q)),
                           ("gum", gum, (f1, b, q))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != logits.device):
            raise ValueError(f"vpu_tail: {name} must be float32 {shape} "
                             f"contiguous on {logits.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    plan = vpu_plan(q, f1)
    out = torch.empty((b, f1), dtype=torch.int32, device=logits.device)
    ring = torch.empty((b, f1 * q), dtype=torch.bfloat16,
                       device=logits.device)
    _launch("vpu_tail", logits.data_ptr(), gum.data_ptr(), int(use_prng),
            int(seed) & 0xFFFFFFFFFFFFFFFF, TEMPERATURE,
            int(n_frames), ring.data_ptr(), out.data_ptr(), b, q, f1,
            *plan, _stream(logits))
    return (out, ring) if return_ring else out


# ----------------------------------------------------------------- K9 --

def mxu_stream_plain(ebuf, w1, w2, wh, wo, wup, *, n_frames):
    """Plain version of K9: the same products, bf16 values multiplied and
    summed in float32 -> the [B, q] float32 accumulator."""
    def f32(t):
        return t.to(torch.bfloat16).to(torch.float32)

    e, w1, w2, wh, wo, wup = map(f32, (ebuf, w1, w2, wh, wo, wup))
    hdim, q = wh.shape[0], wo.shape[1]
    head = w1.shape[0]
    acc = torch.zeros((e.shape[0], q), dtype=torch.float32, device=e.device)
    for _ in range(n_frames):
        acc = acc + torch.matmul(e[:, :hdim], wup)[:, :q]
        for _ in range(e.shape[1] // q):
            xm = (torch.matmul(e[:, :head], w1)
                  + torch.matmul(e[:, head:head + q], w2))
            hm = f32(torch.relu(xm))
            h2 = f32(torch.relu(torch.matmul(hm, wh)))
            acc = acc + torch.matmul(h2, wo)
    return acc


def mxu_stream(ebuf, w1, w2, wh, wo, wup, *, n_frames):
    """K9: the product stream of ``n_frames`` frames of f1 steps.

    ebuf [B, f1*q] (the one-hot ring), w1 [(f1-1)*q, H], w2 [q, H], wh
    [H, H], wo [H, q], wup [H, f1*H]; each in bf16, or cast to it here as
    the reference does.  Returns the [B, q] float32 accumulator of every
    step's logits and every frame's hoist (its first q columns)."""
    if ebuf.device.type == "cpu":
        return mxu_stream_plain(ebuf, w1, w2, wh, wo, wup,
                                n_frames=n_frames)
    b, ring = ebuf.shape
    hdim, q = wo.shape
    f1 = ring // q
    shapes = {"ebuf": (b, f1 * q), "w1": ((f1 - 1) * q, hdim),
              "w2": (q, hdim), "wh": (hdim, hdim), "wo": (hdim, q),
              "wup": (hdim, f1 * hdim)}
    args = {}
    for name, t in zip(shapes, (ebuf, w1, w2, wh, wo, wup)):
        if tuple(t.shape) != shapes[name] or t.device != ebuf.device:
            raise ValueError(f"mxu_stream: {name} {tuple(t.shape)} on "
                             f"{t.device}, expected {shapes[name]} on "
                             f"{ebuf.device}")
        args[name] = t.to(torch.bfloat16).contiguous()
    if b % 64 or hdim % 64 or q % 64 or hdim > f1 * q:
        raise ValueError(f"mxu_stream: B={b}, H={hdim} and q={q} must be "
                         f"multiples of 64, H at most f1*q={f1 * q}")
    acc = torch.zeros((b, q), dtype=torch.float32, device=ebuf.device)
    hoist = torch.empty((b, f1 * hdim), dtype=torch.float32,
                        device=ebuf.device)
    hm = torch.empty((b, hdim), dtype=torch.bfloat16, device=ebuf.device)
    h2 = torch.empty_like(hm)
    # each product's plan (K, N): the hoist, the window head and tail, the
    # hidden and the output products
    plans = (ctypes.c_int * 12)(*(v for k, n in (
        (hdim, f1 * hdim), (f1 * q, hdim), (hdim, hdim), (hdim, q))
        for v in gemm_plan(k, n)[:3]))
    _launch("mxu_stream", *(t.data_ptr() for t in args.values()),
            acc.data_ptr(), hoist.data_ptr(), hm.data_ptr(), h2.data_ptr(),
            b, hdim, q, f1, int(n_frames), ctypes.addressof(plans),
            _stream(ebuf))
    return acc


# ---------------------------------------------------------- the script --

def inputs(device) -> dict:
    """The reference's inputs (``scripts/vpu_ceiling.py:_inputs``, the
    same numpy draws from seed 0), float32 tensors on ``device``."""
    rng = np.random.default_rng(0)
    arrays = dict(
        logits=rng.normal(size=(B, Q)),
        gum=rng.gumbel(size=(F1, B, Q)),
        ebuf=rng.normal(size=(B, F1 * Q)),
        w1=rng.normal(size=(HEAD, H)) * 0.02,
        w2=rng.normal(size=(Q, H)) * 0.02,
        wh=rng.normal(size=(H, H)) * 0.02,
        wo=rng.normal(size=(H, Q)) * 0.02,
        wup=rng.normal(size=(H, F1 * H)) * 0.02,
    )
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in arrays.items()}


def smoke() -> int:
    """The reference's smoke check, on the CPU: the tail's samples are
    the argmax of logits + 0.9 * gum (the last frame's), and the product
    stream runs and is finite."""
    x = inputs("cpu")
    got = vpu_tail(x["logits"], x["gum"], 7, n_frames=2, use_prng=False)
    want = torch.argmax(x["logits"][None] + TEMPERATURE * x["gum"], -1)
    if not torch.equal(got.long(), want[-F1:].T):
        raise AssertionError("vpu_tail: samples differ from the argmax")
    out = mxu_stream(*(x[k] for k in ("ebuf", "w1", "w2", "wh", "wo",
                                      "wup")), n_frames=1)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("mxu_stream: non-finite accumulator")
    print(json.dumps({"smoke": "ok", "device": "cpu"}))
    return 0


def _per_step_us(fn) -> float:
    """CUDA-event time of N_REP back-to-back calls, warm, in us per
    generated step (each call generates N_STEPS steps)."""
    for w in range(3):
        fn(w)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(N_REP):
        fn(10 + i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / N_REP / N_STEPS


def roofline(device) -> list:
    """Time K8 (Philox noise), K9 and the flagship's sampled generation
    per step on the card, N_STEPS steps per call -> the JSON records the
    script prints."""
    from samplernn_pase_tpu_torch import generate
    from samplernn_pase_tpu_torch.config import SampleRNNConfig
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.kernels import megagen
    from samplernn_pase_tpu_torch.ops.mulaw import quantize_zero

    x = inputs(device)
    bf = {k: x[k].to(torch.bfloat16) for k in ("ebuf", "w1", "w2", "wh",
                                                "wo", "wup")}
    n_frames = N_STEPS // F1
    vpu_us = _per_step_us(lambda s: vpu_tail(
        x["logits"], x["gum"], s, n_frames=n_frames, use_prng=True))
    mxu_us = _per_step_us(lambda s: mxu_stream(*bf.values(),
                                               n_frames=n_frames))

    cfg = SampleRNNConfig(frame_sizes=(16, 4), dim=H, embed_dim=256,
                          q_levels=Q, compute_dtype="bfloat16")
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   device)
    weights = generate.prepare_weights(params, cfg, device)
    states = samplernn.initial_state(params, cfg, B)
    window = torch.full((B, cfg.lookback), quantize_zero(Q),
                        dtype=torch.int32, device=device)
    n_top = N_STEPS // cfg.lookback
    full_us = _per_step_us(lambda s: megagen.run(
        weights, window, states, 0.95, n_top, Q, seed=s))

    t_max, t_sum = max(mxu_us, vpu_us), mxu_us + vpu_us
    # the stream's operations per step: the four products and 1/f1 of the
    # hoist, at the tensor cores' bf16 rate
    flops = 2.0 * B * (F1 * Q * H + H * H + H * Q + H * F1 * H / F1)
    return [
        {"component": "vpu_tail", "us_per_step": vpu_us},
        {"component": "mxu_stream", "us_per_step": mxu_us,
         "bound_us_per_step": flops / 989e12 * 1e6},
        {"component": "generation", "us_per_step": full_us,
         "note": "flagship sampled generation (K1-K3), B=128, T=0.95"},
        {"summary": "vpu_inclusive_roofline",
         "mxu_us_per_step": mxu_us, "vpu_us_per_step": vpu_us,
         "envelope_us_per_step": [t_max, t_sum],
         "measured_full_us_per_step": full_us,
         "measured_Msps": B / full_us,
         "conclusion": (
             "below the envelope: K1's own stream is lighter than the "
             "two halves (see k1_differs)" if full_us < t_max * 0.95 else
             "within the envelope of the two halves"
             if full_us <= t_sum * 1.05 else
             "slack remains beyond the measured components"),
         "k1_differs": (
             "K1 gathers f1 rows of W' per step where the TPU multiplies a "
             "one-hot window (K9's head and tail products); its products "
             "run on wgmma tiles across a cluster of 8 blocks; a noise warp "
             "draws its noise two steps ahead (K8: producer warps up to a "
             "ring of slots ahead); its argmax spans the cluster through "
             "distributed shared memory (K8: one warp's redux)"),
         "device": torch.cuda.get_device_name(device)},
    ]


def _trace_buffer(buf):
    _build.function("roofline", "srnn_vpu_tail_trace", [_P])(buf)


def traced(x, n_frames: int) -> list:
    """One flagship-shape K8 call (Philox noise) with block 0's phase
    trace on: the trace buffer as a list."""
    buf = torch.zeros(TRACE_WORDS, dtype=torch.int64,
                      device=x["logits"].device)
    _trace_buffer(buf.data_ptr())
    try:
        vpu_tail(x["logits"], x["gum"], 9, n_frames=n_frames, use_prng=True)
        torch.cuda.synchronize()
    finally:
        _trace_buffer(None)
    return buf.cpu().tolist()


def trace_phases(tr, f1: int) -> dict:
    """Mean us of each phase per frame and per step over the traced frames
    1 .. TRACE_FRAMES - 1 (frame 0 primes the kernel)."""
    base = TRACE_FRAMES * TRACE_PER
    ghz = (tr[base + 2] - tr[base]) / max(1, tr[base + 3] - tr[base + 1])
    frames = range(1, TRACE_FRAMES)

    def point(f, i, k):
        return tr[f * TRACE_PER + 1 + 5 * i + k]

    per_frame = {k: 0.0 for k in PHASES}
    for f in frames:
        prev = tr[f * TRACE_PER]
        for i in range(f1):
            for k, name in enumerate(PHASES):
                per_frame[name] += point(f, i, k) - prev
                prev = point(f, i, k)
    per_frame = {k: v / len(frames) / ghz / 1e3 for k, v in
                 per_frame.items()}
    per_frame["frame"] = sum(per_frame.values())
    # the producers: chunks 4 .. TRACE_CHUNKS - 1 (past the ring's first
    # fill), the wait for a free slot and the fill, per chunk
    chunks = [tr[base + 4 + 3 * c:base + 7 + 3 * c]
              for c in range(4, TRACE_CHUNKS)]
    chunks = [c for c in chunks if c[2]]
    producer = {"wait": sum(c[1] - c[0] for c in chunks),
                "fill": sum(c[2] - c[1] for c in chunks)}
    producer = {k: v / max(1, len(chunks)) / ghz / 1e3
                for k, v in producer.items()}
    return {"ghz": ghz, "per_frame_us": per_frame,
            "per_step_us": {k: v / f1 for k, v in per_frame.items()
                            if k != "frame"} | {
                "step": per_frame["frame"] / f1},
            "per_chunk_us": producer}


WARM_S = 0.2   # seconds of back-to-back calls before a timing


def tail_device_us(fn, reps: int = TRACE_REPS) -> float:
    """Device us per call of fn() (``gemm_ablation.device_us``), after
    WARM_S seconds of calls: the card's clocks are up whatever ran (or
    idled) before."""
    from samplernn_pase_tpu_torch.scripts.gemm_ablation import device_us
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        fn()
        torch.cuda.synchronize()
    return device_us(fn, reps)


# the root checkout's K8 through its own wrapper (its C entry may take
# other arguments than this tree's), timed as tail_device_us times it
_ROOT_TIMER = """
import json, sys, time, torch
from samplernn_pase_tpu_torch.scripts import vpu_ceiling as vc
from samplernn_pase_tpu_torch.scripts.gemm_ablation import device_us
x = vc.inputs("cuda")
n = int(sys.argv[1])
fn = lambda: vc.vpu_tail(x["logits"], x["gum"], 9, n_frames=n, use_prng=True)
t0 = time.perf_counter()
while time.perf_counter() - t0 < float(sys.argv[3]):
    fn()
    torch.cuda.synchronize()
print(json.dumps(device_us(fn, int(sys.argv[2]))))
"""


def root_us(root: str, n_frames: int, reps: int = TRACE_REPS) -> float:
    """``root``'s K8 device us per call at the flagship's shape, from a
    subprocess that imports the port from there."""
    proc = subprocess.run(
        [sys.executable, "-c", _ROOT_TIMER, str(n_frames), str(reps),
         str(WARM_S)],
        cwd=os.path.abspath(root), capture_output=True, text=True,
        timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return float(proc.stdout.strip().splitlines()[-1])


CHECKED_CALLS = 20   # K8 calls timed one by one and checked (--trace)


def checked_calls(x, n_frames: int, calls: int = CHECKED_CALLS):
    """Device us of each of ``calls`` flagship-shape K8 calls (Philox),
    timed one by one with CUDA events after ``WARM_S`` seconds of calls,
    and whether every one of them returned the plain version's samples
    and ring: a fast call is held to the same bar as a slow one."""
    want = vpu_tail_plain(x["logits"], x["gum"], 9, n_frames=n_frames,
                          use_prng=True)

    def fn():
        return vpu_tail(x["logits"], x["gum"], 9, n_frames=n_frames,
                        use_prng=True, return_ring=True)

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        fn()
        torch.cuda.synchronize()
    events, outs = [], []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(fn())
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    us = [s.elapsed_time(e) * 1e3 for s, e in events]
    equal = all(torch.equal(o, w) for out in outs for o, w in zip(out, want))
    return us, equal


def trace(device, root=None) -> dict:
    """K8's phase split and device time at the flagship's shape (Philox
    noise, N_STEPS // F1 frames), and ``CHECKED_CALLS`` calls timed one by
    one and checked against the plain version; with ``root``, that
    checkout's K8 timed in the order root, this tree, this tree, root."""
    x = inputs(device)
    n_frames = N_STEPS // F1

    def this_us():
        return tail_device_us(lambda: vpu_tail(
            x["logits"], x["gum"], 9, n_frames=n_frames, use_prng=True))

    result = {"shape": [B, Q, F1], "n_frames": n_frames,
              "plan": list(vpu_plan(Q, F1))}
    if root:
        result["root_us"] = [root_us(root, n_frames)]
    result["us"] = [this_us()]
    if root:
        result["us"].append(this_us())
        result["root_us"].append(root_us(root, n_frames))
    result["calls_us"], result["calls_equal"] = checked_calls(x, n_frames)
    result["trace"] = trace_phases(traced(x, n_frames), F1)
    # the traced instantiation's own time: what the clock reads cost
    buf = torch.zeros(TRACE_WORDS, dtype=torch.int64, device=device)
    _trace_buffer(buf.data_ptr())
    try:
        result["traced_us"] = this_us()
    finally:
        _trace_buffer(None)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the plain versions on the CPU (no card needed)")
    ap.add_argument("--trace", action="store_true",
                    help="K8's phase split and device time per call")
    ap.add_argument("--root", default=None,
                    help="with --trace: a checkout whose K8 to time beside "
                         "this tree's")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke()
    if not torch.cuda.is_available():
        print("vpu_ceiling: no CUDA device (--smoke runs on the CPU)",
              file=sys.stderr)
        return 1
    # the card's name and power limit, beside every number printed
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    if args.trace:
        result = trace(torch.device("cuda"), args.root)
        per_step = result["trace"]["per_step_us"]
        print(f"K8 [B={B}, q={Q}, f1={F1}] Philox, {result['n_frames']} "
              f"frames: device us per call {result['us']}"
              + (f", root {result['root_us']}" if args.root else "")
              + f", traced {result['traced_us']:.1f}")
        print("per step us: " + ", ".join(
            f"{k} {v:.4f}" for k, v in per_step.items()))
        print("per frame us: " + ", ".join(
            f"{k} {v:.3f}" for k, v in result["trace"][
                "per_frame_us"].items()))
        print("producer per chunk us: " + ", ".join(
            f"{k} {v:.3f}" for k, v in result["trace"][
                "per_chunk_us"].items()))
        calls = sorted(result["calls_us"])
        print(f"{len(calls)} calls timed one by one: us min {calls[0]:.1f}, "
              f"median {calls[len(calls) // 2]:.1f}, max {calls[-1]:.1f}; "
              "samples and ring equal to the plain version in every call: "
              f"{result['calls_equal']}")
        print(json.dumps(result))
        return 0 if result["calls_equal"] else 1
    for record in roofline(torch.device("cuda")):
        print(json.dumps(record))
    print(f"vpu_ceiling: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
