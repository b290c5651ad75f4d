"""K7, the mu-law codec kernels, and their plain versions: the
counterparts of ``samplernn_pase_tpu/ops/pallas/codec.py``'s
``mu_law_encode_fused`` and ``mu_law_decode_fused`` (``csrc/codec.cu``).

``mu_law_encode``: float32 [rows, cols] waveform -> int32 levels;
``mu_law_decode``: int32 [rows, cols] levels -> float32 waveform; any
``q_levels >= 2``.  Rows may be strided, the last axis is contiguous.  On
CPU tensors each wrapper runs its plain version, ``ops/mulaw.py``'s
function of the same name; on a CUDA tensor it launches the kernel or
raises.  The kernel repeats the plain version's operations in its order,
each rounded on its own, so on the card the two agree bit for bit.

How a launch runs is ``codec_plan``'s, a pure function of the shapes, the
pointers' offsets within 16 bytes and the card's resident blocks: it
never reads the data.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from samplernn_pase_tpu_torch.ops import mulaw
from samplernn_pase_tpu_torch.ops.kernels import _build

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"codec_encode": 0, "codec_decode": 0}

THREADS = 256          # csrc/codec.cu THREADS
TABLE_CAP = 4096       # csrc/codec.cu TABLE_CAP: decode's table, 16 KB

_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p]

mu_law_encode_plain = mulaw.mu_law_encode
mu_law_decode_plain = mulaw.mu_law_decode


class CodecPlan(NamedTuple):
    """How K7 runs one call.  ``vec``: elements per access, 4 (float4 /
    int4, where every row's input and output agree mod 16 bytes; a row's
    first and last 0-3 elements are scalar) or 1; ``vpt``: accesses each
    thread issues before it uses any, 1 or 4; ``threads`` per block;
    ``blocks``: one wave, at most the card's resident blocks, each walking
    a flat range of (row, column chunk) items; ``table``: decode through a
    shared-memory table of the q levels (never for encode)."""
    vec: int
    vpt: int
    threads: int
    blocks: int
    table: bool


def codec_plan(rows: int, cols: int, ld_in: int, ld_out: int, q_levels: int,
               align_in: int, align_out: int, resident: int, sms: int, *,
               decode: bool) -> CodecPlan:
    """K7's plan for [rows, cols] with leading dimensions ``ld_in`` and
    ``ld_out`` (elements), input and output pointers at ``align_in`` and
    ``align_out`` bytes past a 16-byte boundary, on a card that holds
    ``resident`` blocks of ``THREADS`` per SM on each of ``sms`` SMs, for
    decode (else encode).

    16-byte accesses where every row's input and output start at the same
    offset within 16 bytes, else scalar ones.  A chunk (an item) is
    ``THREADS * vpt`` accesses of one row, at least one per row; 16-byte
    routes take 1 access a thread where those items fit one wave (a short
    row: more would only add accesses past its end), else 4; the scalar
    route takes 4.  Decode reads a table iff ``q_levels <= TABLE_CAP``."""
    if q_levels < 2:
        raise ValueError(f"codec: q_levels={q_levels} (needs >= 2)")
    if min(rows, cols, resident, sms) < 0 or min(resident, sms) == 0:
        raise ValueError(f"codec: rows={rows} cols={cols} resident="
                         f"{resident} sms={sms}")
    vec = 4 if (align_in % 16 == align_out % 16
                and (ld_in - ld_out) % 4 == 0) else 1
    width = cols // vec

    def items(vpt):
        return rows * max(1, -(-width // (THREADS * vpt)))

    wave = resident * sms
    vpt = 1 if vec == 4 and items(1) <= wave else 4
    return CodecPlan(vec, vpt, THREADS, max(1, min(items(vpt), wave)),
                     decode and q_levels <= TABLE_CAP)


@functools.lru_cache(maxsize=None)
def card(index: int, decode: bool) -> tuple[int, int]:
    """(resident blocks per SM, SMs) of CUDA device ``index`` for one
    direction's kernels (``srnn_codec_resident``), asked once."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        err = _build.function("codec", "srnn_codec_resident",
                              [ctypes.c_int, ctypes.c_void_p])(
            int(decode), out)
    if err or out[0] < 1:
        raise RuntimeError(f"srnn_codec_resident: CUDA error {err}, "
                           f"{out[0]} blocks per SM")
    return out[0], out[1]


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def plan_for(x: torch.Tensor, out: torch.Tensor, q_levels: int,
             decode: bool) -> CodecPlan:
    """The plan of one call on the card: ``x`` in, ``out`` out."""
    index = x.device.index
    if index is None:
        index = torch.cuda.current_device()
    return codec_plan(x.shape[0], x.shape[1], x.stride(0), out.stride(0),
                      q_levels, x.data_ptr() % 16, out.data_ptr() % 16,
                      *card(index, decode), decode=decode)


def _run(name, symbol, x, dtype_in, dtype_out, q_levels):
    if x.dim() != 2 or x.dtype != dtype_in or x.stride(1) != 1:
        raise ValueError(f"{name}: expects a {dtype_in} [rows, cols] tensor "
                         f"with a contiguous last axis, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if q_levels < 2:
        raise ValueError(f"{name}: q_levels={q_levels}")
    rows, cols = x.shape
    out = torch.empty((rows, cols), dtype=dtype_out, device=x.device)
    plan = plan_for(x, out, q_levels, name == "codec_decode")
    args = (ctypes.c_int * 5)(plan.vec, plan.vpt, plan.threads, plan.blocks,
                              int(plan.table))
    err = _build.function("codec", symbol, _ARGS)(
        x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0), rows, cols,
        int(q_levels), args, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"(plan {tuple(plan)})")
    LAUNCHES[name] += 1
    return out


def mu_law_encode(x: torch.Tensor, q_levels: int = 256) -> torch.Tensor:
    """K7 encode: float32 [rows, cols] in [-1, 1] -> int32 levels."""
    if x.device.type == "cpu":
        return mu_law_encode_plain(x, q_levels)
    return _run("codec_encode", "srnn_mu_law_encode", x, torch.float32,
                torch.int32, q_levels)


def mu_law_decode(levels: torch.Tensor, q_levels: int = 256) -> torch.Tensor:
    """K7 decode: int32 [rows, cols] levels -> float32 waveform."""
    if levels.device.type == "cpu":
        return mu_law_decode_plain(levels, q_levels)
    return _run("codec_decode", "srnn_mu_law_decode", levels, torch.int32,
                torch.float32, q_levels)
