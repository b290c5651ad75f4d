"""Decode kernels K1-K3 and K6, their plain PyTorch versions, and the
per-frame counterparts of ``samplernn_pase_tpu/ops/pallas/decode.py``.

Kernels (CUDA C++ under ``csrc/``, built for sm_90a by ``_build``):

* K1 ``frame_decode`` (``csrc/frame_decode.cu``): one bottom frame, f1
  autoregressive sample-MLP steps for every lane, Gumbel-max sampling
  with supplied, shared-seed or per-lane-key noise; bf16 weights at dim
  1024, q_levels 256 on the tensor-core kernel, float32 and every other width
  on the CUDA-core one (``frame_plan``).
* K2 ``gemm_bias`` (``csrc/gemm_bias.cu``): ``round(A) @ W + bias (+ add)
  (+ the lane's conditioning row)`` for every product outside the MLP,
  with int32 levels dequantized on load; bf16 weights on the split-K
  wgmma core ``csrc/skinny_gemm.cuh`` by ``gemm_plan``.
* K3 ``gru_gates`` (``csrc/gru_gates.cu``): the GRU gate math.
* K6 ``lstm_gates`` (``csrc/lstm_gates.cu``): the LSTM gate math, on the
  gate sum that K2 forms in one buffer (its ``add`` input).

Each wrapper checks its tensors, allocates its outputs with
``torch.empty``, launches on the current stream and adds one to its
count in ``LAUNCHES``.  On CPU tensors it runs its plain version instead
(that is how the CPU tests run); on CUDA tensors it launches the kernel
or raises.  The plain versions repeat the kernels' arithmetic in the same
order and dtypes: activations rounded to the weight dtype before each
product, float32 accumulation, the float32 adds of ``upper`` and ``b_up``,
and the fused-embedding first layer.  Turn TF32 off (``plain_numerics``)
before running a plain version on the card.

``fused_frame_decode`` and ``fused_tier_frame_decode`` are the
counterparts of the Pallas kernels of the same names: the first is K1;
the second is K2 (tier input + ``upper``), K2 twice (the gates), K3 (GRU)
or K6 (LSTM), K2 (the upsample) and K1.  A tier of ``n_rnn`` stacked
layers (the megakernel's static cell stack, ``megagen.py:224-240``) runs
the gate products and the cell once per layer, layer i feeding layer
i+1, and upsamples the last layer's ``h``.  A tier's decode state is a
tuple with one entry per layer, each a tuple of float32 [B, H] tensors:
``(h,)`` for a GRU, ``(h, c)`` for an LSTM; ``decode_state`` and
``model_state`` convert it from and to the model layout [n_rnn, (2,) B,
H].  Conditioned decode passes each tier a ``CondRows`` (its projected
conditioning rows, each lane's phase and the cond rate), which K2's
epilogue adds to the tier input.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from samplernn_pase_tpu_torch.ops import weight_norm as wnorm
from samplernn_pase_tpu_torch.ops.kernels import _build
from samplernn_pase_tpu_torch.ops.kernels.noise import (
    as_lane_keys, gumbel_block, lane_gumbel_block)
from samplernn_pase_tpu_torch.ops.matmul import torch_dtype

# kernel name -> launches since the last reset_launches(); the
# "<kernel>_<mode>" entries count the launches of a kernel that took that
# mode (K2's conditioning epilogue, K1's per-lane keys), within its own
# count
LAUNCHES = {"frame_decode": 0, "gemm_bias": 0, "gru_gates": 0,
            "lstm_gates": 0, "gemm_bias_cond": 0,
            "frame_decode_lane_keys": 0}

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
_SIGNATURES = {
    "gemm_bias": ("srnn_gemm_bias",
                  [_P, _I, _I64, _P, _I, _P, _P, _I64, _P, _I64, _I, _I, _I,
                   _F, _P, _I64, _I64, _I, _P, _I, _I, _I, _I, _I, _I, _P]),
    "gru_gates": ("srnn_gru_gates",
                  [_P, _I64, _P, _I64, _P, _I64, _P, _I, _I, _P]),
    "lstm_gates": ("srnn_lstm_gates",
                   [_P, _I64, _P, _I64, _P, _P, _I, _I, _P]),
    "lstm_gates_vec": ("srnn_lstm_gates_vec",
                       [_P, _I64, _P, _I64, _P, _P, _I, _I, _P]),
    "frame_decode": ("srnn_frame_decode_planned",
                     [_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                      _F, ctypes.c_uint64, _P, _I64, _P, _P, _P, _I64, _I, _I,
                      _I, _I, _I, _P, _P]),
}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def plain_numerics():
    """Full float32 products for plain versions run on the card, and
    float32 reductions in 16-bit products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _launch(name, *args, mode=None, entry=None):
    err = _build.function(name, *_SIGNATURES[entry or name])(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1
    if mode:
        LAUNCHES[f"{name}_{mode}"] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_cpu(*tensors) -> bool:
    """True when the tensors are on the CPU (plain version); False on one
    CUDA device (kernel).  Anything else raises."""
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(t, name, dtypes, shape=None, rows_strided=False):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    ok = (t.dim() == 2 and t.stride(1) == 1) if rows_strided \
        else t.is_contiguous()
    if not ok:
        raise ValueError(f"{name}: layout {t.stride()} not supported")


_W_DTYPES = (torch.float32, torch.bfloat16)


# ----------------------------------------------------------------- K2 --

# The skinny wgmma core (csrc/skinny_gemm.cuh) that K2's bf16 route and K9
# run on: its shapes, mirrored here so that the plan can be checked on the
# CPU.
TILE_M = 128                    # rows per CTA, two 64-row warpgroups
STAGE_K = 64                    # W rows per ring stage
SMEM_MAX = 231424               # dynamic shared memory per CTA: the H100's
                                # 227 KB less 1 KB of static (mbarriers)
STAGES = {64: 10, 128: 6}       # ring stages per tile width
MIN_SLICE = 256                 # rows of W per CTA before K is split


class GemmPlan(NamedTuple):
    """How the core runs one product: ``split`` CTAs of a thread-block
    cluster, one K-slice each (``k_slices``); output tiles ``bn`` columns
    wide, walked by ``groups`` column groups (group g takes tiles g, g +
    groups, ..); ``smem`` bytes of shared memory per CTA; ``ctas`` per
    128-row block."""
    split: int
    bn: int
    groups: int
    smem: int
    ctas: int


def _plan_smem(bn: int) -> int:
    """Shared memory of a CTA: alignment, the W ring, two bf16 A panels and
    the larger of the float32 partial tile and two staged A panels
    (``skinny_gemm.cuh:smem_bytes``)."""
    return 1024 + STAGES[bn] * STAGE_K * bn * 2 + 2 * TILE_M * 128 \
        + max(TILE_M * (bn + 8) * 4, 2 * TILE_M * 64 * 4)


def k_slices(k: int, split: int) -> list:
    """The K-slices of the ``split`` CTAs of a cluster, in rank order:
    [start, end) in rows of W, multiples of 16 covering K rounded up to 16
    (rows past K are zero)."""
    k16 = -(-k // 16)
    return [(16 * (r * k16 // split), 16 * ((r + 1) * k16 // split))
            for r in range(split)]


def _resident(split: int) -> int:
    """CTAs the H100 holds at once for the core, clusters of ``split``
    (``cudaOccupancyMaxActiveClusters`` on the card: 132 clusters of 1,
    66 of 2, 30 of 4, 15 of 8; one CTA per SM)."""
    return 132 if split <= 2 else 120


def gemm_plan(k: int, n: int, w_dtype=torch.bfloat16) -> GemmPlan | None:
    """The plan of K2's bf16 product [M, k] @ [k, n] (and K9's): a pure
    function of K, N and the weight type, never of M, so that every row
    adds the same partials in the same order whatever the batch (a pool
    lane equals its solo stream bit for bit).  None for float32 weights,
    which take K2's FMA route.

    One output tile per CTA, all CTAs resident at once: the largest split
    that K allows (slices of at least ``MIN_SLICE`` rows: below that the
    cluster's partial sum through distributed shared memory costs more
    than the shorter K loop saves) and that keeps ``split * tiles`` CTAs
    resident; 64-column tiles where that gives more CTAs than 128-column
    ones, else 128.  Where even the 128-column tiles outnumber the SMs,
    clusters of 2 walk them in rounds.  Fitted to the core's sweep on
    the H100 (``scripts/gemm_ablation.py --sweep``, PERF.md)."""
    if w_dtype != torch.bfloat16:
        return None
    if k < 1 or n < 1:
        raise ValueError(f"gemm_plan: K={k}, N={n}")
    k16 = -(-k // 16)
    allow = min(8, 1 << (max(1, k16 * 16 // MIN_SLICE).bit_length() - 1))

    def resident(bn):
        """(split, tiles) with every tile's CTAs resident, or None."""
        tiles = -(-n // bn)
        fits = [s for s in (1, 2, 4, 8)
                if s <= allow and s * tiles <= _resident(s)]
        return (max(fits), tiles) if fits else None

    wide, narrow = resident(128), resident(64)
    if narrow and (not wide or narrow[0] * narrow[1] > wide[0] * wide[1]):
        bn, (split, groups) = 64, narrow
    elif wide:
        bn, (split, groups) = 128, wide
    else:
        tiles = -(-n // 128)
        bn, split = 128, min(2, allow)
        rounds = -(-tiles // (_resident(split) // split))
        groups = -(-tiles // rounds)
    return GemmPlan(split, bn, groups, _plan_smem(bn), split * groups)


def _ext_base(ext, pos: int, cond_rate: int) -> int:
    """The row K2's conditioning epilogue starts from at ``pos``; raises
    when ``ext`` does not hold it."""
    if cond_rate <= 0 or pos < 0:
        raise ValueError(f"cond_rate={cond_rate}, pos={pos}")
    base = pos // cond_rate
    if base >= ext.shape[0]:
        raise ValueError(f"conditioning row {base} (pos {pos}, cond_rate "
                         f"{cond_rate}) past the {ext.shape[0]} rows given")
    return base


def gemm_bias_plain(a, w, bias=None, add=None, levels_q=0, ext=None,
                    cphase=None, pos=0, cond_rate=0):
    if levels_q:
        a = a.to(torch.float32) / (levels_q / 2.0) - 1.0
    c = torch.matmul(a.to(w.dtype).to(torch.float32), w.to(torch.float32))
    if bias is not None:
        c = c + bias
    if add is not None:
        c = c + add
    if ext is not None:
        base = _ext_base(ext, pos, cond_rate)
        bump = cphase.to(torch.int64) + pos % cond_rate >= cond_rate
        hi = min(base + 1, ext.shape[0] - 1)
        c = c + torch.where(bump[:, None], ext[hi], ext[base])
    return c


def gemm_bias(a, w, bias=None, add=None, levels_q=0, ext=None, cphase=None,
              pos=0, cond_rate=0, plan=None, out=None, pdl=False):
    """K2: ``round(A) @ W + bias (+ add) (+ ext row)`` -> float32 ``[M, N]``.

    a [M, K] float32 (or int32 levels when ``levels_q`` is the level
    count: dequantized as ``l/(q/2) - 1``), rows may be strided; w [K, N]
    float32/bf16 contiguous; bias [N] float32 or None; add [M, N] float32
    (rows may be strided) or None.  Conditioning: ext [R, M, N] float32
    (last axis contiguous) with cphase [M] int32, ``pos`` and
    ``cond_rate``: row m adds ``ext[r, m]``, r = ``pos // cond_rate``, or
    ``min(that + 1, R - 1)`` when ``cphase[m] + pos % cond_rate >=
    cond_rate`` (``megagen.py:211-219``).  ``plan``: the core's plan for
    bf16 weights, ``gemm_plan(K, N)`` when None (another is for timing
    sweeps: rows stay bit-equal across batch sizes under any one plan).
    ``out``: a contiguous float32 [M, N] tensor to write into, else
    allocated.  ``pdl``: launch as a programmatic dependent of the kernel
    before it on the stream (K1, which lets it start once resident, or
    another product so launched), so that it runs beside K1; it must read
    nothing that kernel writes, and whatever reads ``out`` must wait on
    K1 and on this launch itself (``megagen.beside_k1``).  No effect on
    the CPU."""
    if _on_cpu(a, w, bias, add, ext, cphase, out):
        c = gemm_bias_plain(a, w, bias, add, levels_q, ext, cphase, pos,
                            cond_rate)
        return c if out is None else out.copy_(c)
    m, k = a.shape
    n = w.shape[1]
    _check(a, "a", (torch.int32,) if levels_q else (torch.float32,),
           rows_strided=True)
    _check(w, "w", _W_DTYPES, (k, n))
    if bias is not None:
        _check(bias, "bias", (torch.float32,), (n,))
    if add is not None:
        _check(add, "add", (torch.float32,), (m, n), rows_strided=True)
    ext_args = (None, 0, 0, 0, None, 0, 0)
    if ext is not None:
        if (ext.dtype != torch.float32 or ext.dim() != 3
                or tuple(ext.shape[1:]) != (m, n) or ext.stride(2) != 1):
            raise ValueError(f"ext: {ext.dtype} {tuple(ext.shape)} strides "
                             f"{ext.stride()}, expected float32 [R, {m}, "
                             f"{n}] with contiguous rows")
        _check(cphase, "cphase", (torch.int32,), (m,))
        _ext_base(ext, pos, cond_rate)
        ext_args = (ext.data_ptr(), ext.stride(0), ext.stride(1),
                    ext.shape[0], cphase.data_ptr(), int(pos), int(cond_rate))
    if plan is None or w.dtype != torch.bfloat16:
        plan = gemm_plan(k, n, w.dtype)
    if out is None:
        c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    else:
        _check(out, "out", (torch.float32,), (m, n))
        c = out
    _launch("gemm_bias", a.data_ptr(), int(bool(levels_q)), a.stride(0),
            w.data_ptr(), int(plan is not None), _ptr(bias),
            _ptr(add), 0 if add is None else add.stride(0), c.data_ptr(), n,
            m, n, k, (levels_q or 2) / 2.0, *ext_args,
            *(plan[:3] if plan else (0, 0, 0)), int(pdl), _stream(a),
            mode="cond" if ext is not None else None)
    return c


# ----------------------------------------------------------------- K3 --

def gru_gates_plain(xg, hg, h):
    hdim = h.shape[-1]
    xr, xz, xn = xg[:, :hdim], xg[:, hdim:2 * hdim], xg[:, 2 * hdim:]
    hr, hz, hn = hg[:, :hdim], hg[:, hdim:2 * hdim], hg[:, 2 * hdim:]
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_gates(xg, hg, h):
    """K3: GRU gates from xg/hg [B, 3H] (r, z, n) and h [B, H] -> h' [B, H],
    all float32."""
    if _on_cpu(xg, hg, h):
        return gru_gates_plain(xg, hg, h)
    b, hdim = h.shape
    _check(xg, "xg", (torch.float32,), (b, 3 * hdim), rows_strided=True)
    _check(hg, "hg", (torch.float32,), (b, 3 * hdim), rows_strided=True)
    _check(h, "h", (torch.float32,), (b, hdim), rows_strided=True)
    out = torch.empty((b, hdim), dtype=torch.float32, device=h.device)
    _launch("gru_gates", xg.data_ptr(), xg.stride(0), hg.data_ptr(),
            hg.stride(0), h.data_ptr(), h.stride(0), out.data_ptr(), b, hdim,
            _stream(h))
    return out


# ----------------------------------------------------------------- K6 --

def lstm_gates_plain(g, c):
    hdim = c.shape[-1]
    i = torch.sigmoid(g[:, :hdim])
    f = torch.sigmoid(g[:, hdim:2 * hdim])
    gg = torch.tanh(g[:, 2 * hdim:3 * hdim])
    o = torch.sigmoid(g[:, 3 * hdim:])
    c_new = f * c + i * gg
    return o * torch.tanh(c_new), c_new


LSTM_VEC = 2   # units per thread on K6's vector route (csrc: VEC)


def lstm_gates_route(hdim: int, ldg: int, ldc: int, g_offset: int,
                     c_offset: int) -> str:
    """K6's route, by shape alone: "vector" (``LSTM_VEC`` consecutive
    units per thread, 8-byte loads and stores) where ``hdim`` and both row
    strides (``ldg``, ``ldc``, in floats) are multiples of ``LSTM_VEC``
    and both tensors start on an 8-byte boundary (``g_offset``,
    ``c_offset``: their first element's offset in floats from a 16-byte
    boundary, ``data_ptr() % 16 // 4``); else "scalar" (one unit per
    thread).  Both routes are K6, with the same arithmetic."""
    aligned = all(v % LSTM_VEC == 0
                  for v in (hdim, ldg, ldc, g_offset, c_offset))
    return "vector" if aligned else "scalar"


def lstm_gates(g, c):
    """K6: LSTM gates from g [B, 4H] (i, f, g, o; the sum xg + hg) and c
    [B, H] -> (h' [B, H], c' [B, H]), all float32; rows of g and c may be
    strided (``lstm_gates_route`` picks the kernel's instantiation)."""
    if _on_cpu(g, c):
        return lstm_gates_plain(g, c)
    b, hdim = c.shape
    _check(g, "g", (torch.float32,), (b, 4 * hdim), rows_strided=True)
    _check(c, "c", (torch.float32,), (b, hdim), rows_strided=True)
    h_out = torch.empty((b, hdim), dtype=torch.float32, device=c.device)
    c_out = torch.empty_like(h_out)
    route = lstm_gates_route(hdim, g.stride(0), c.stride(0),
                             g.data_ptr() % 16 // 4, c.data_ptr() % 16 // 4)
    _launch("lstm_gates", g.data_ptr(), g.stride(0), c.data_ptr(),
            c.stride(0), h_out.data_ptr(), c_out.data_ptr(), b, hdim,
            _stream(c), entry="lstm_gates_vec" if route == "vector" else None)
    return h_out, c_out


# ----------------------------------------------------------------- K1 --

# K1's two kernels (csrc/frame_decode.cu), mirrored here so that the plan
# can be checked on the CPU.
FMA_CLUSTER, FMA_LANES, FMA_THREADS = 8, 8, 256   # the CUDA-core kernel
BOX_ROWS = 128               # one TMA box of weights: 128 rows x 64
BOX = BOX_ROWS * 64 * 2      # columns of bf16
K1_SMEM_MAX = 231936         # dynamic shared memory of the tc kernel:
                             # the H100's 227 KB less 512 bytes of static
                             # (its mbarriers and ring order)
K1_MIN_STAGES = 8            # ring slots the tc kernel takes (tc_box_order)
K1_MAX_STAGES = 24           # and has mbarriers for
# the one shape the tc kernel is built for (tcd::CL, LT, HC): a tile of
# 16 lanes on a cluster of 8 blocks of 128 columns, and the widths it
# takes, those of every preset that generates
K1_TC = (8, 16, 128)
K1_TC_WIDTHS = (1024, 256)   # (dim, q_levels)


class FramePlan(NamedTuple):
    """How K1 decodes a frame.  ``route``: "tc" (bf16 at dim 1024,
    q_levels 256: the tensor-core kernel) or "fma" (float32 and every
    other width: the CUDA-core kernel).  A tile of ``lanes`` lanes (B
    padded up to a multiple) is one thread-block cluster of ``cluster``
    blocks; block r owns ``cols`` columns of W_h (and of h1, h2) and, on
    the tc route, one 64-column tile of W_out over 1/``out_split`` of
    its K (on the fma route q/cluster logit columns over all of K).
    ``stages``: ring slots of one weight box (``BOX`` bytes) each, the
    boxes streamed at every step; ``smem``: dynamic shared memory bytes
    per block."""
    route: str
    cluster: int
    lanes: int
    cols: int
    out_split: int
    stages: int
    smem: int


def _fma_smem(hdim: int, q: int, f1: int, vec: int) -> int:
    """The CUDA-core kernel's shared memory (``frame_decode.cu``'s
    ``smem_floats``): h1 and h2, the K-slice partials, the layer slice,
    the argmax partials and the window, float32."""
    cl, lt = FMA_CLUSTER, FMA_LANES

    def ksplit(groups):
        return 1 if groups >= FMA_THREADS else FMA_THREADS // groups

    hc, qc = hdim // cl, q // cl
    red = max(ksplit(hc // vec) * lt * hc, ksplit(qc // vec) * lt * qc)
    return 4 * (2 * lt * hdim + red + lt * max(hc, qc) + 2 * cl * lt
                + lt * f1)


def _tc_plan(hdim: int, q: int, f1: int) -> FramePlan:
    """The tensor-core kernel's plan at its widths (``K1_TC_WIDTHS``): as
    many ring slots as fit beside h1, h2, the argmax partials, the noise,
    layer 2's K-half sums and the window (``tcd::smem_bytes``)."""
    cluster, lanes, cols = K1_TC
    tiles = q // 64
    xsum = 8 * 32 * 8 * 4      # 8 consumer warps x 32 threads x 8 float32
    fixed = 1024 + 2 * lanes * hdim * 2 + tiles * lanes * 8 \
        + 2 * lanes * 64 * 4 + xsum + -(-lanes * f1 * 2 // 16) * 16
    stages = min(K1_MAX_STAGES, (K1_SMEM_MAX - fixed) // BOX)
    return FramePlan("tc", cluster, lanes, cols, cluster // tiles, stages,
                     fixed + stages * BOX)


def tc_box_order(stages: int):
    """Layer 2's 16 weight boxes of a step in the tensor-core kernel's
    ring order for a ring of ``stages`` slots (``tcd::box_order``,
    mirrored to be checked on the CPU): entry x is 4 g + r, the r-th box
    (in K order) of group g = 2 K-half + tile, which the group's two warps
    read.  Every base b < stages (boxes b, b + stages, ...) goes to one
    group, the next in turn with room for all of them, so that the box
    before a box in its slot was read by the same warps.  None where no
    group has room."""
    boxes = 16
    per = boxes // 4
    count, base, nxt = [0] * 4, [], 0
    for b in range(min(stages, boxes)):
        m = (boxes - 1 - b) // stages + 1
        for k in range(4):
            if count[(nxt + k) % 4] + m <= per:
                break
        else:
            return None
        g = (nxt + k) % 4
        base.append(g)
        count[g] += m
        nxt = (g + 1) % 4
    r, order = [0] * 4, []
    for x in range(boxes):
        g = base[x % stages]
        order.append(4 * g + r[g])
        r[g] += 1
    return order


def frame_plan(hdim: int, q: int, f1: int,
               w_dtype=torch.bfloat16) -> FramePlan:
    """K1's plan: a pure function of the widths, f1 and the weight type,
    never of the batch, so that a lane's samples are bit-equal whatever
    the batch and whatever lanes share its tile (a pool lane equals its
    solo stream).  bf16 weights at ``K1_TC_WIDTHS`` take the tensor-core
    kernel; float32 weights, and every other bf16 width, the CUDA-core
    kernel.  Widths neither takes raise ValueError with the reason."""
    if w_dtype not in _W_DTYPES:
        raise ValueError(f"frame_plan: weight dtype {w_dtype}")
    if hdim < 64 or q < 64 or hdim % 64 or q % 64 or f1 < 1:
        raise ValueError(f"frame_plan: dim {hdim} and q_levels {q} must be "
                         "multiples of 64 (8 blocks per cluster, 16-byte "
                         f"weight loads), f1 {f1} >= 1")
    if w_dtype == torch.bfloat16 and (hdim, q) == K1_TC_WIDTHS:
        plan = _tc_plan(hdim, q, f1)
        if plan.stages >= K1_MIN_STAGES:   # else too small a ring
            return plan
    smem = _fma_smem(hdim, q, f1, 8 if w_dtype == torch.bfloat16 else 4)
    if smem > K1_SMEM_MAX:
        raise ValueError(f"frame_plan: dim {hdim}, q_levels {q}, f1 {f1} "
                         f"need {smem} bytes of shared memory per block, "
                         f"more than the {K1_SMEM_MAX} the H100 gives")
    return FramePlan("fma", FMA_CLUSTER, FMA_LANES, hdim // FMA_CLUSTER, 1,
                     0, smem)


def frame_columns(plan: FramePlan, hdim: int, q: int) -> list:
    """What block r of a tile computes under ``plan``, in rank order: its
    columns of W_h [start, end) and its block of W_out (columns [start,
    end), rows [start, end))."""
    out = []
    for r in range(plan.cluster):
        h = (r * plan.cols, (r + 1) * plan.cols)
        if plan.route == "fma":
            qc = q // plan.cluster
            o = ((r * qc, (r + 1) * qc), (0, hdim))
        else:
            t, s = divmod(r, plan.out_split)
            rows = hdim // plan.out_split
            o = ((64 * t, 64 * t + 64), (s * rows, (s + 1) * rows))
        out.append((h, o))
    return out


def noise_mode(temperature, noise, lane_keys) -> int:
    """K1's noise mode: 0 greedy, 1 the supplied ``noise``, 3 per-lane
    keys, 2 the shared seed."""
    return (0 if not temperature else 1 if noise is not None
            else 3 if lane_keys is not None else 2)


def frame_noise(temperature, noise, seed, pos0, lane_keys, lane_pos, b,
                f1, q, device):
    """The [f1, B, q] noise block K1 reads, drawn in PyTorch: the supplied
    one (mode 1), per-lane keys (mode 3) or the shared seed (mode 2) at
    positions ``pos0 (+ lane_pos) + i``; None when greedy."""
    if not temperature:
        return None
    if noise is not None:
        return noise
    pos = pos0 if lane_pos is None else lane_pos.to(torch.int64) + pos0
    if lane_keys is not None:
        return lane_gumbel_block(lane_keys, pos, f1, q, device)
    if isinstance(seed, torch.Tensor):
        seed = int(seed.item()) & 0xFFFFFFFFFFFFFFFF
    return gumbel_block(seed, b, pos, f1, q, device)


def frame_decode_plain(window, cond, bup, mw, temperature, noise=None,
                       seed=0, pos0=0, out=None, lane_keys=None,
                       lane_pos=None, *, forced=None):
    """Plain version of K1 (see ``frame_decode``).  With ``forced`` [B, f1]
    the window rolls with those samples instead of its own, so the result
    is the argmax each step would take on that history (rescoring)."""
    b, f1 = window.shape
    hdim = mw["b_in"].shape[0]
    q = mw["b_out"].shape[0]
    wf = mw["w_fused"].view(f1, q, hdim)
    wt = wf.dtype
    cond = cond.reshape(b, f1, hdim)
    noise = frame_noise(temperature, noise, seed, pos0, lane_keys, lane_pos,
                        b, f1, q, window.device)
    slots = torch.arange(f1, device=window.device)[None, :]
    win = window.to(torch.int64)
    samples = []
    for i in range(f1):
        rows = wf[slots, win].to(torch.float32)        # [B, f1, H]
        x = rows[:, 0]
        for j in range(1, f1):
            x = x + rows[:, j]
        x = x + mw["b_in"]
        c = cond[:, i] if bup is None else cond[:, i] + bup[i]
        h = torch.relu(x + c).to(wt)
        h = torch.relu(torch.matmul(h.to(torch.float32),
                                    mw["w_h"].to(torch.float32))
                       + mw["b_h"]).to(wt)
        scores = torch.matmul(h.to(torch.float32),
                              mw["w_out"].to(torch.float32)) + mw["b_out"]
        if temperature:
            scores = scores + temperature * noise[i]
        sample = torch.argmax(scores, dim=-1)
        samples.append(sample)
        nxt = sample if forced is None else forced[:, i].to(torch.int64)
        win = torch.cat([win[:, 1:], nxt[:, None]], dim=1)
    samples = torch.stack(samples, dim=1).to(torch.int32)
    if out is None:
        return samples
    out.copy_(samples)
    return out


def kernel_lane_keys(lane_keys, device=None) -> torch.Tensor:
    """Lane keys in the form K1 reads them: int32 [B, 2] holding the bits
    of the 32-bit words (``noise.as_lane_keys`` reads them back).  A loop
    converts once per call, not per launch."""
    keys = as_lane_keys(lane_keys, device)
    return torch.where(keys >= 1 << 31, keys - (1 << 32),
                       keys).to(torch.int32).contiguous()


def frame_decode(window, cond, bup, mw, temperature, noise=None, seed=0,
                 pos0=0, out=None, lane_keys=None, lane_pos=None, plan=None):
    """K1: decode one bottom frame for every lane -> int32 [B, f1].

    window [B, f1] int32 levels (rows may be strided); cond [B, f1*H]
    float32 conditioning rows (rows may be strided); bup [f1, H] float32
    added to row i at use, or None; mw: ``prepare_mlp`` weights;
    temperature 0 = greedy (noise is then never read); noise [f1, B, q]
    float32 Gumbel block, or None to draw Philox noise in the kernel:
    keyed by ``seed`` (an int, or an int64 [1] tensor holding its 64 bits
    on the device, read by the kernel at run time, so that a captured
    graph takes a new seed) and the lane index, or with ``lane_keys``
    [B, 2] (see ``noise.as_lane_keys``) by each lane's own key; step i of
    lane b is at position ``pos0 + i``, plus ``lane_pos[b]`` when a [B]
    tensor of per-lane offsets is given.  ``out``: an int32 [B, f1] view (rows
    may be strided) to write into, else allocated.  ``plan``: the kernel's
    plan, ``frame_plan(H, q, f1, dtype)`` when None (another ring depth
    is for timing sweeps: a lane's samples stay bit-equal across batch
    sizes under any one plan)."""
    if _on_cpu(window, cond, mw["w_fused"], lane_keys, lane_pos, seed):
        return frame_decode_plain(window, cond, bup, mw, temperature, noise,
                                  seed, pos0, out, lane_keys, lane_pos)
    b, f1 = window.shape
    hdim = mw["b_in"].shape[0]
    q = mw["b_out"].shape[0]
    wt = mw["w_fused"].dtype
    _check(window, "window", (torch.int32,), rows_strided=True)
    _check(cond, "cond", (torch.float32,), (b, f1 * hdim), rows_strided=True)
    if bup is not None:
        _check(bup, "bup", (torch.float32,), (f1, hdim))
    _check(mw["w_fused"], "w_fused", (wt,), (f1 * q, hdim))
    _check(mw["w_h"], "w_h", (wt,), (hdim, hdim))
    _check(mw["w_out"], "w_out", (wt,), (hdim, q))
    for name, size in (("b_in", hdim), ("b_h", hdim), ("b_out", q)):
        _check(mw[name], name, (torch.float32,), (size,))
    if wt not in _W_DTYPES:
        raise TypeError(f"frame_decode: weight dtype {wt}")
    if plan is None:
        plan = frame_plan(hdim, q, f1, wt)
    elif plan.route == "tc" and wt != torch.bfloat16:
        raise ValueError("frame_decode: the tc route takes bf16 weights")
    if plan.route == "tc" and (cond.stride(0) % 4
                               or cond.data_ptr() % 16):
        cond = cond.contiguous()     # its rows are read 16 bytes at a time
    mode = noise_mode(temperature, noise, lane_keys)
    if mode == 1:
        _check(noise, "noise", (torch.float32,), (f1, b, q))
    keys = None
    if mode == 3:
        keys = lane_keys
        if not (isinstance(keys, torch.Tensor) and keys.dtype == torch.int32
                and keys.device == window.device):
            keys = kernel_lane_keys(keys, window.device)
        _check(keys, "lane_keys", (torch.int32,), (b, 2))
    if lane_pos is not None and mode >= 2:
        _check(lane_pos, "lane_pos", (torch.int64,), (b,))
    seed_dev = None
    if isinstance(seed, torch.Tensor):
        _check(seed, "seed", (torch.int64,), (1,))
        seed_dev, seed = seed, 0
    if out is None:
        out = torch.empty((b, f1), dtype=torch.int32, device=window.device)
    _check(out, "out", (torch.int32,), (b, f1), rows_strided=True)
    _launch("frame_decode", window.data_ptr(), window.stride(0),
            cond.data_ptr(), cond.stride(0), _ptr(bup),
            mw["w_fused"].data_ptr(), mw["b_in"].data_ptr(),
            mw["w_h"].data_ptr(), mw["b_h"].data_ptr(),
            mw["w_out"].data_ptr(), mw["b_out"].data_ptr(),
            _ptr(noise) if mode == 1 else None, mode,
            float(temperature or 0.0), int(seed) & 0xFFFFFFFFFFFFFFFF,
            _ptr(seed_dev) if mode == 2 else None, int(pos0), _ptr(keys),
            _ptr(lane_pos) if mode >= 2 else None,
            out.data_ptr(), out.stride(0), b, f1, hdim, q,
            int(wt == torch.bfloat16), ctypes.addressof(_plan_words(plan)),
            _stream(window), mode="lane_keys" if mode == 3 else None)
    return out


@functools.lru_cache(maxsize=None)
def _plan_words(plan: FramePlan):
    """A plan as the five ints ``srnn_frame_decode_planned`` reads (route,
    cluster, lanes, out_split, stages), made once per plan."""
    return (ctypes.c_int * 5)(int(plan.route == "tc"), plan.cluster,
                              plan.lanes, plan.out_split, plan.stages)


# --------------------------------------------------- composite ops --

class CondRows(NamedTuple):
    """A tier's conditioning in a decode call, the megakernel's
    ``ext_proj[k]``/``cond_phase``/``cond_rate``: ext [R, B, H] float32
    projected rows, each lane's from its own origin; phase [B] int32, each
    lane's first position modulo ``rate``."""
    ext: torch.Tensor
    phase: torch.Tensor
    rate: int


class Ops(NamedTuple):
    """The ops a decode path calls: the kernel wrappers, or their plain
    versions (to hold a path against its plain twin on the card)."""
    gemm: object
    gru_gates: object
    lstm_gates: object
    frame: object


KERNELS = Ops(gemm_bias, gru_gates, lstm_gates, frame_decode)
PLAIN = Ops(gemm_bias_plain, gru_gates_plain, lstm_gates_plain,
            frame_decode_plain)


def prepare_tier(tier, dtype) -> dict:
    """A GRU or LSTM tier's weights in kernel form: weight-norm resolved,
    matrices in ``dtype`` and contiguous, biases float32 (``b_up`` also
    flat).  ``layers`` holds one entry per stacked layer (``w_ih``/``w_hh``
    [H, 3H] or [H, 4H], ``b_ih``/``b_hh``) beside the tier's ``w_in``,
    ``w_up`` and, where the tier has one, ``w_cond`` [cond_dim, H]."""
    dt = torch_dtype(dtype)
    f32 = torch.float32
    layers = tuple({
        "w_ih": rnn["w_ih"].to(dt).contiguous(),
        "b_ih": rnn["b_ih"].to(f32).contiguous(),
        "w_hh": rnn["w_hh"].to(dt).contiguous(),
        "b_hh": rnn["b_hh"].to(f32).contiguous(),
    } for rnn in tier["rnn"])
    return {
        "w_in": wnorm.resolve(tier["w_in"]).to(dt).contiguous(),
        "b_in": tier["b_in"].to(f32).contiguous(),
        "layers": layers,
        "w_up": wnorm.resolve(tier["w_up"]).to(dt).contiguous(),
        "b_up": tier["b_up"].to(f32).contiguous(),
        "b_up_flat": tier["b_up"].to(f32).reshape(-1).contiguous(),
    } | ({"w_cond": tier["w_cond"].to(dt).contiguous()}
         if "w_cond" in tier else {})


def prepare_mlp(mlp, dtype, f1: int, ops: Ops = KERNELS) -> dict:
    """The sample MLP in kernel form.  The embedding is folded into the
    first layer: ``W'[j*q:(j+1)*q] = embed @ w_in[j*E:(j+1)*E]`` computed
    in float32 by ``ops.gemm`` (f1 launches of K2), then cast to ``dtype``
    (the megakernel's fused-embedding form)."""
    dt = torch_dtype(dtype)
    f32 = torch.float32
    embed = mlp["embed"].to(f32).contiguous()
    e = embed.shape[1]
    w_in = wnorm.resolve(mlp["w_in"]).to(f32).contiguous()
    fused = torch.cat([ops.gemm(embed, w_in[j * e:(j + 1) * e])
                       for j in range(f1)])
    return {
        "w_fused": fused.to(dt).contiguous(),
        "b_in": mlp["b_in"].to(f32).contiguous(),
        "w_h": wnorm.resolve(mlp["w_h"]).to(dt).contiguous(),
        "b_h": mlp["b_h"].to(f32).contiguous(),
        "w_out": wnorm.resolve(mlp["w_out"]).to(dt).contiguous(),
        "b_out": mlp["b_out"].to(f32).contiguous(),
    }


def tier_gates(w_hh) -> int:
    """A tier's gate count from its w_hh: 3 for a GRU's [H, 3H], 4 for an
    LSTM's [H, 4H]; anything else raises ValueError."""
    hdim, n = w_hh.shape
    if n not in (3 * hdim, 4 * hdim):
        raise ValueError(f"w_hh {tuple(w_hh.shape)} is neither a GRU's "
                         "[H, 3H] nor an LSTM's [H, 4H]")
    return n // hdim


def decode_state(s, layers):
    """A tier's model-layout state -> its decode state, float32: [n_rnn, B,
    H] -> ``((h,), ...)`` for a GRU tier, [n_rnn, 2, B, H] -> ``((h, c),
    ...)`` for an LSTM tier, one entry per layer of ``layers`` (the
    tier's prepared ``layers``; GRU and LSTM told apart by ``w_hh``).  Any
    other layout raises ValueError."""
    w_hh = layers[0]["w_hh"]
    hdim = w_hh.shape[0]
    n = len(layers)
    lead = (n,) if tier_gates(w_hh) == 3 else (n, 2)
    if tuple(s.shape[:-2]) != lead or s.shape[-1] != hdim:
        kind = "GRU" if len(lead) == 1 else "LSTM"
        raise ValueError(f"the {kind} tier of {n} layers with w_hh "
                         f"{tuple(w_hh.shape)} takes a state "
                         f"{list(lead) + ['B', hdim]}, got {tuple(s.shape)}")
    s = s.to(torch.float32)
    return tuple(tuple(layer.reshape(-1, *s.shape[-2:])) for layer in s)


def model_state(state):
    """A decode state -> the model layout: ``((h,), ...)`` -> [n_rnn, B, H],
    ``((h, c), ...)`` -> [n_rnn, 2, B, H]."""
    return torch.stack([layer[0] if len(layer) == 1 else torch.stack(layer)
                        for layer in state])


def tier_cell(tw, frame, upper, state, q_levels, ops: Ops = KERNELS,
              cond: CondRows | None = None, pos: int = 0, hg=None):
    """One tier step in kernels: K2 (levels -> dequantized frame @ w_in +
    b_in + upper, + the lane's conditioning row), then per stacked layer
    K2 (the input gates ``xg`` of the tier input or of the layer below's
    new ``h``) and for a GRU K2 (``hg``) and K3, for an LSTM K2 with ``xg``
    as its ``add`` (``(h @ w_hh + b_hh) + xg``, the reference's ``xg +
    hg`` in one buffer) and K6.  frame [B, span] int32 levels; upper
    [B, H] float32 or None; state: one ``(h,)`` (GRU) or ``(h, c)`` (LSTM)
    per layer, from ``decode_state``; cond: this tier's ``CondRows`` or
    None, read at ``pos``, the frame's first-sample offset within the
    call; hg: for a GRU tier, each layer's ``h @ w_hh + b_hh`` of this
    ``state`` [B, 3H] float32, computed ahead by the same K2 (the whole
    generation loop runs it beside K1: ``megagen._frames``), or None to
    compute it here -> the new state, same form.  Either way each K3
    reads the same bits."""
    kw = {} if cond is None else dict(ext=cond.ext, cphase=cond.phase,
                                      pos=pos, cond_rate=cond.rate)
    x = ops.gemm(frame, tw["w_in"], tw["b_in"], upper, levels_q=q_levels,
                 **kw)
    new = []
    for i, (lw, s) in enumerate(zip(tw["layers"], state, strict=True)):
        xg = ops.gemm(x, lw["w_ih"], lw["b_ih"])
        h = s[0]
        if len(s) == 1:
            g = (ops.gemm(h, lw["w_hh"], lw["b_hh"]) if hg is None
                 else hg[i])
            s = (ops.gru_gates(xg, g, h),)
        else:
            s = ops.lstm_gates(ops.gemm(h, lw["w_hh"], lw["b_hh"], xg), s[1])
        new.append(s)
        x = s[0]
    return tuple(new)


def tier_frame(tw, mw, window, upper, state, temperature, q_levels,
               ops: Ops = KERNELS, noise=None, seed=0, pos0=0, out=None,
               cond: CondRows | None = None, pos: int = 0, lane_keys=None,
               lane_pos=None):
    """The bottom tier's whole frame on prepared weights: the tier cell
    (with ``cond`` read at ``pos``), the upsample of the last layer's
    ``h' @ w_up`` (K2, ``b_up`` added per row in K1) and the f1 MLP steps
    (K1, noise as ``frame_decode`` takes it).  Returns (samples [B, f1],
    the new state)."""
    state = tier_cell(tw, window, upper, state, q_levels, ops, cond, pos)
    rows = ops.gemm(state[-1][0], tw["w_up"])
    samples = ops.frame(window, rows, tw["b_up"], mw, temperature, noise,
                        seed, pos0, out, lane_keys, lane_pos)
    return samples, state


def fused_frame_decode(window, cond, temperature, mlp_params, *,
                       q_levels: int = 256, weights_dtype="bfloat16",
                       noise=None, seed: int = 0, pos0: int = 0):
    """Counterpart of ``ops/pallas/decode.py:fused_frame_decode``.

    window [B, f1] int32; cond [B, f1, H] float32 conditioning rows (b_up
    already added); temperature 0 = greedy; noise [f1, B, q] float32, or
    None for Philox noise from ``seed`` at positions ``pos0 ..``.
    Returns samples [B, f1] int32."""
    b, f1 = window.shape
    mw = prepare_mlp(mlp_params, torch_dtype(weights_dtype), f1)
    if mw["b_out"].shape[0] != q_levels:
        raise ValueError(f"q_levels={q_levels} but the MLP has "
                         f"{mw['b_out'].shape[0]} outputs")
    cond2 = cond.to(torch.float32).reshape(b, -1)
    return frame_decode(window.to(torch.int32), cond2, None, mw,
                        temperature, noise, seed, pos0)


def fused_tier_frame_decode(window, upper_cond, h_prev, temperature,
                            tier_params, mlp_params, *, q_levels: int = 256,
                            rnn_type: str = "gru", weights_dtype="bfloat16",
                            noise=None, seed: int = 0, pos0: int = 0,
                            cond: CondRows | None = None, pos: int = 0,
                            lane_keys=None, lane_pos=None):
    """Counterpart of ``ops/pallas/decode.py:fused_tier_frame_decode``,
    in its scope: a tier of one layer (``n_rnn=1``; stacked tiers decode
    through ``tier_frame``): the bottom tier's GRU or LSTM step, its
    upsample and the f1 MLP steps.

    window [B, f1] int32; upper_cond [B, H] float32; h_prev [1, B, H]
    (GRU) or [2, B, H] (LSTM: h, c) float32.  The reference adds the
    conditioning projection to ``upper_cond`` outside its kernel; here
    ``cond``/``pos`` give K2 the projected rows instead (``tier_cell``),
    and ``lane_keys``/``lane_pos`` take the place of its per-lane noise
    block (``frame_decode``).  Returns (samples [B, f1] int32, h_new in
    h_prev's layout, float32)."""
    if len(tier_params["rnn"]) != 1:
        raise ValueError(f"fused_tier_frame_decode takes a tier of one "
                         f"layer (n_rnn=1), got {len(tier_params['rnn'])}")
    gates = tier_gates(tier_params["rnn"][0]["w_hh"])
    if gates != {"gru": 3, "lstm": 4}[rnn_type]:
        raise ValueError(f"rnn_type={rnn_type!r} but the tier has {gates} "
                         "gates")
    f1 = window.shape[1]
    dt = torch_dtype(weights_dtype)
    tw = prepare_tier(tier_params, dt)
    mw = prepare_mlp(mlp_params, dt, f1)
    # the reference's h_prev is the model layout without its n_rnn axis
    # for an LSTM ([2, B, H]), and the model layout itself for a GRU
    state = decode_state(h_prev[None] if gates == 4 else h_prev,
                         tw["layers"])
    samples, state = tier_frame(
        tw, mw, window.to(torch.int32), upper_cond.to(torch.float32), state,
        temperature, q_levels, KERNELS, noise, seed, pos0, None, cond, pos,
        lane_keys, lane_pos)
    return samples, torch.stack(state[0])
