"""K7, the mu-law codec kernels, and their plain versions: the
counterparts of ``samplernn_pase_tpu/ops/pallas/codec.py``'s
``mu_law_encode_fused`` and ``mu_law_decode_fused`` (``csrc/codec.cu``).

``mu_law_encode``: float32 [rows, cols] waveform -> int32 levels;
``mu_law_decode``: int32 [rows, cols] levels -> float32 waveform; any
``q_levels``.  Rows may be strided, the last axis is contiguous.  On CPU
tensors each wrapper runs its plain version, ``ops/mulaw.py``'s function
of the same name; on a CUDA tensor it launches the kernel or raises.  The
kernel repeats the plain version's operations in its order, each rounded
on its own, so on the card the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from samplernn_pase_tpu_torch.ops import mulaw
from samplernn_pase_tpu_torch.ops.kernels import _build

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"codec_encode": 0, "codec_decode": 0}

_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

mu_law_encode_plain = mulaw.mu_law_encode
mu_law_decode_plain = mulaw.mu_law_decode


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _run(name, symbol, x, dtype_in, dtype_out, q_levels):
    if x.dim() != 2 or x.dtype != dtype_in or x.stride(1) != 1:
        raise ValueError(f"{name}: expects a {dtype_in} [rows, cols] tensor "
                         f"with a contiguous last axis, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if q_levels < 2:
        raise ValueError(f"{name}: q_levels={q_levels}")
    rows, cols = x.shape
    out = torch.empty((rows, cols), dtype=dtype_out, device=x.device)
    err = _build.function("codec", symbol, _ARGS)(
        x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0), rows, cols,
        int(q_levels), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
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
