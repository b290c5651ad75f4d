"""Whole generation on the decode kernels: the counterpart of
``samplernn_pase_tpu/ops/pallas/megagen.py:generate_full_pallas`` for GRU
and LSTM tiers of any ``n_rnn``, greedy or sampled, with or without
conditioning (its resident and ``stream_top`` forms compute the same
samples; here every weight is read from L2 or device memory at each use).
The loop (``run``) takes any number of tiers and f1 >= 1, so it is also
the counterpart of the reference's per-frame route (``_xla_generate``
over ``fused_tier_frame_decode`` or the tier step and
``fused_frame_decode``); ``generate_full`` keeps the megakernel's scope.

The TPU megakernel keeps every weight (~55 MB in bf16) resident in one
core's 128 MiB of VMEM for one launch.  The flagship's bf16 weights are
78.4 MB (39.2 M elements, W' included), above the H100's 50 MB L2 and the
~30 MB of shared memory over its 132 SMs, so that design does not carry
over; a single persistent kernel is later work.  Here the loop over top
frames runs on the host and launches the kernels of ``decode.py``:

* per tier-k step (k > 0): K2 (tier input + upper, + the lane's
  conditioning row), then per stacked layer K2 x2 (gates) and K3 (GRU) or
  K6 (LSTM), then K2 (upsample of the last layer's h, bias added);
* per bottom frame: ``decode.tier_frame``, the counterpart of
  ``fused_tier_frame_decode``: the same cell, K2 (upsample rows, ``b_up``
  added per row by K1), then K1 for the f1 samples.

A tier step takes 2 + 3 * n_rnn launches and a bottom frame one more.  A
flagship top frame (2-tier GRU, frame_sizes (16, 4)) takes 29 launches at
n_rnn=1 and 44 at n_rnn=2 (8 for the top tier, 4 x 9 for the bottom
frames); config 2's (3-tier LSTM, (16, 4, 4)) 121 at n_rnn=1 (5 for tier
2, 4 x 5 for tier 1 and 16 x 6 for the bottom frames) and 184 at n_rnn=2.
Conditioning adds no launch: the megakernel's two-row select
(``tier_in``, ``megagen.py:196-220``) is K2's epilogue on the tier input,
fed the rows the caller projected once per call (``ext_proj``).  Its
per-lane host noise (``gumbel`` under the reference's ``lane_keys``,
``megagen.py:139-166``) is K1's noise mode 3: each lane draws with its
own key at its own positions (``lane_keys``, ``pos0`` a [B] tensor).

Lower tiers recurse as in the megakernel's ``decode``.  The levels go
into one preallocated int32 buffer ``[B, lookback + n_top*lookback]``
whose first ``lookback`` columns are the seed window, so every tier's
input frame (the last ``span_k`` samples) is a strided view of it and K1
writes its samples straight into it.  No chunking is needed: the buffer
is 8 MB at B=128 and 16,000 samples, Philox noise is drawn inside K1, and
a caller-supplied ``gumbel`` ``[n_bottom, f1, B, q]`` is the caller's
memory.

Each call of ``run`` is one span, ``megagen.run`` (attrs ``top_frames``,
``lanes``; ``utils/profiling.py``), recorded while a profiler runs: the
host's time launching a call's kernels, and none per launch.
"""

from __future__ import annotations

import torch

from samplernn_pase_tpu_torch.ops.kernels.decode import (
    KERNELS, PLAIN, CondRows, Ops, decode_state, kernel_lane_keys,
    model_state, prepare_mlp, prepare_tier, tier_cell, tier_frame,
    tier_gates)
from samplernn_pase_tpu_torch.ops.matmul import torch_dtype
from samplernn_pase_tpu_torch.utils.profiling import note, spanned


def prepare(tiers, mlp, dtype, ops: Ops = KERNELS) -> dict:
    """Kernel-form weights for every tier (bottom first) and the MLP."""
    f1 = tiers[0]["b_up"].shape[0]
    return {"tiers": [prepare_tier(t, dtype) for t in tiers],
            "mlp": prepare_mlp(mlp, dtype, f1, ops)}


@spanned("megagen.run")
def run(weights, window, states, temperature, n_top, q_levels,
        ops: Ops = KERNELS, seed: int = 0, pos0=0, gumbel=None,
        cond: tuple | None = None, lane_keys=None):
    """Generate ``n_top`` top frames on prepared weights.

    window [B, lookback] int32; states: per-tier model-layout states,
    [n_rnn, B, H] (GRU) or [n_rnn, 2, B, H] (LSTM) float32; any number of
    tiers.  Returns (levels [B, n_top*lookback] int32, final states, same
    layout).
    ``pos0`` is the noise position of the first sample, an int or a [B]
    int64 tensor (one per lane); noise is Philox keyed by ``seed``, or by
    each lane's ``lane_keys`` [B, 2]; ``gumbel`` [n_bottom, f1, B, q]
    float32 replaces Philox.  ``cond``: (ext_proj, cond_phase, cond_rate)
    with ext_proj a per-tier tuple of [R, B, H] float32 rows, cond_phase
    [B] int32, or None."""
    tiers = weights["tiers"]
    mw = weights["mlp"]
    frame_sizes = [t["b_up"].shape[0] for t in tiers]
    spans = []
    acc = 1
    for f in frame_sizes:
        acc *= f
        spans.append(acc)
    lookback = spans[-1]
    f1 = frame_sizes[0]
    b = window.shape[0]
    note(top_frames=n_top, lanes=b)
    if window.shape != (b, lookback):
        raise ValueError(f"window {tuple(window.shape)} != ({b}, {lookback})")
    if gumbel is not None and gumbel.shape[0] != n_top * lookback // f1:
        raise ValueError(f"gumbel has {gumbel.shape[0]} frames, expected "
                         f"{n_top * lookback // f1}")
    buf = torch.empty((b, lookback + n_top * lookback), dtype=torch.int32,
                      device=window.device)
    buf[:, :lookback] = window
    if len(states) != len(tiers):
        raise ValueError(f"{len(states)} states for {len(tiers)} tiers")
    h = [decode_state(s, t["layers"]) for s, t in zip(states, tiers)]
    tier_cond = [None] * len(tiers)
    if cond is not None:
        ext_proj, phase, rate = cond
        if len(ext_proj) != len(tiers):
            raise ValueError(f"{len(ext_proj)} ext_proj for {len(tiers)} "
                             "tiers")
        tier_cond = [CondRows(e, phase, rate) for e in ext_proj]
    if lane_keys is not None:
        lane_keys = kernel_lane_keys(lane_keys, window.device)
    lane_pos = pos0 if isinstance(pos0, torch.Tensor) else None
    pos_off = 0 if lane_pos is not None else int(pos0)

    def decode(k, upper, p):
        """Tier k's frame starting at generated sample p."""
        start = lookback + p
        frame = buf[:, start - spans[k]:start]
        if k == 0:
            noise = None if gumbel is None else gumbel[p // f1]
            _, h[0] = tier_frame(tiers[0], mw, frame, upper, h[0],
                                 temperature, q_levels, ops, noise, seed,
                                 pos_off + p, buf[:, start:start + f1],
                                 tier_cond[0], p, lane_keys, lane_pos)
            return
        h[k] = tier_cell(tiers[k], frame, upper, h[k], q_levels, ops,
                         tier_cond[k], p)
        top = h[k][-1][0]          # the last layer's h
        cond = ops.gemm(top, tiers[k]["w_up"], tiers[k]["b_up_flat"])
        hdim = top.shape[1]
        for j in range(frame_sizes[k]):
            decode(k - 1, cond[:, j * hdim:(j + 1) * hdim],
                   p + j * spans[k - 1])

    for t in range(n_top):
        decode(len(tiers) - 1, None, t * lookback)
    return buf[:, lookback:], tuple(model_state(x) for x in h)


def _check_scope(tiers, rnn_type):
    """The reference megakernel's scope (``generate._full_kernel_eligible``):
    GRU or LSTM tiers of any n_rnn, 2 or 3 tiers, f1 >= 2 (its pipelined
    window split needs two slots).  ``run`` decodes the rest, as the
    reference's per-frame route does."""
    gates = {"gru": 3, "lstm": 4}.get(rnn_type)
    if gates is None:
        raise NotImplementedError(f"generate_full takes GRU or LSTM tiers, "
                                  f"not {rnn_type!r}")
    for t in tiers:
        for layer in t["rnn"]:
            w = layer["w_hh"]
            if tier_gates(w) != gates:
                raise ValueError(f"rnn_type={rnn_type!r} but a tier's w_hh "
                                 f"is {tuple(w.shape)}")
    if len(tiers) not in (2, 3):
        raise ValueError(
            f"generate_full takes 2 or 3 tiers, as the megakernel, got "
            f"{len(tiers)}; generate.generate_levels decodes any count")
    if tiers[0]["b_up"].shape[0] < 2:
        raise ValueError(
            "generate_full needs frame_sizes[0] >= 2, as the megakernel; "
            "generate.generate_levels decodes f1=1")


def generate_full(window, states, temperature, tiers, mlp, *, n_top: int,
                  q_levels: int = 256, rnn_type: str = "gru",
                  weights_dtype="bfloat16", seed: int = 0, pos0=0,
                  gumbel=None, cond_rate: int = 0, ext_proj=None,
                  cond_phase=None, lane_keys=None, ops: Ops = KERNELS):
    """Counterpart of ``generate_full_pallas``, in the scope of the
    megakernel route (``_check_scope``).

    window [B, lookback] int32 seed context; states: tuple of per-tier
    model-layout states, [n_rnn, B, H] (GRU) or [n_rnn, 2, B, H] (LSTM)
    float32;
    tiers: tier params bottom -> top; temperature 0 = greedy.  Sampling
    draws Philox noise from ``seed``, or from each lane's ``lane_keys``
    [B, 2], at positions ``pos0 ..`` (an int, or a [B] tensor of per-lane
    first positions), or reads ``gumbel`` [n_bottom, f1, B, q] (the Pallas
    kernel's host-noise input).  Conditioning as the Pallas kernel's:
    ``cond_rate``, ``ext_proj`` (per tier [R, B, H] float32 projected rows,
    each lane's from its own row origin) and ``cond_phase`` [B] (each
    lane's first position modulo ``cond_rate``).  Returns
    (levels [B, n_top*lookback] int32 -- the Pallas kernel's
    [n_top, B, lookback] blocks laid end to end per lane -- and the final
    states)."""
    _check_scope(tiers, rnn_type)
    dt = torch_dtype(weights_dtype)
    weights = prepare(tiers, mlp, dt, ops)
    cond = None
    if cond_rate:
        dev = window.device
        cond = (tuple(torch.as_tensor(e, dtype=torch.float32, device=dev)
                      for e in ext_proj),
                torch.as_tensor(cond_phase, device=dev).to(
                    torch.int32).reshape(-1).contiguous(), int(cond_rate))
    return run(weights, window.to(torch.int32), states, temperature, n_top,
               q_levels, ops, seed, pos0, gumbel, cond, lane_keys)


def generate_full_plain(window, states, temperature, tiers, mlp, **kw):
    """``generate_full`` through the plain versions of K1, K2, K3 and K6
    (the same arithmetic in PyTorch), to hold the kernel path against on
    the card."""
    return generate_full(window, states, temperature, tiers, mlp,
                         ops=PLAIN, **kw)
