"""K8 and K9, the roofline microkernels for K1, and the script that times
them on the card: the counterpart of ``scripts/vpu_ceiling.py``.

    python -m samplernn_pase_tpu_torch.scripts.vpu_ceiling [--smoke]

K1 (``csrc/frame_decode.cu``) takes most of the device time on every
generation path.  Its per-step instruction stream has two halves, timed
here in isolation at the flagship's shapes (B=128, H=1024, q=256, f1=16,
bf16 weights), as the reference times its megakernel's:

* K8 ``vpu_tail`` (``csrc/roofline.cu``): the serial sampler tail, per
  frame the Gumbel block (Philox, the port's in-kernel noise, or the
  supplied ``gum``), then f1 steps of ``logits + T*g``, argmax over q and
  a one-hot bf16 write into the ``[B, f1*q]`` ring.
* K9 ``mxu_stream``: the per-step product stream, bf16 in and float32
  accumulate: the window head and tail ``[B,(f1-1)q]x[(f1-1)q,H] +
  [B,q]x[q,H]``, ``[B,H]x[H,H]``, ``[B,H]x[H,q]`` and the per-frame hoist
  ``[B,H]x[H,f1*H]``.

The script prints one JSON line per component (us per generated step),
the real path's (the flagship's sampled generation through K1-K3, per
step), and a summary with the envelope [max, sum] of the two halves.
K1's real stream is not this one: K1 gathers f1 rows of W' per step where
the TPU multiplies a one-hot window by the fused first-layer weight,
streams each block's weight columns through a ring and runs the argmax
across a cluster of 8 blocks through distributed shared memory.
``--smoke`` runs the plain versions on the CPU at the flagship's shapes.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.  A run without ``--smoke`` needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time

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

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "vpu_tail": ("srnn_vpu_tail", [_P, _P, _I, ctypes.c_uint64,
                                   ctypes.c_float, _I, _P, _P, _I, _I, _I,
                                   _P]),
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
    (and the one-hot ring [B, f1*q] bf16 with ``return_ring``)."""
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
    if q % 128 or q > 1024 or not 1 <= f1 <= 32:
        raise ValueError(f"vpu_tail: q={q} must be a multiple of 128 up to "
                         f"1024 and f1={f1} in 1..32")
    out = torch.empty((b, f1), dtype=torch.int32, device=logits.device)
    ring = torch.empty((b, f1 * q), dtype=torch.bfloat16,
                       device=logits.device)
    _launch("vpu_tail", logits.data_ptr(), gum.data_ptr(), int(use_prng),
            int(seed) & 0xFFFFFFFFFFFFFFFF, TEMPERATURE,
            int(n_frames), ring.data_ptr(), out.data_ptr(), b, q, f1,
            _stream(logits))
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
             "are float32 FMAs on the CUDA cores, not tensor-core tiles; "
             "it draws its noise per step inside the chain (K8: per "
             "frame); its argmax spans a cluster of 8 blocks through "
             "distributed shared memory (K8: one warp)"),
         "device": torch.cuda.get_device_name(device)},
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the plain versions on the CPU (no card needed)")
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
    for record in roofline(torch.device("cuda")):
        print(json.dumps(record))
    print(f"vpu_ceiling: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
