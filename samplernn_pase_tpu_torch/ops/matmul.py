"""The reference's matmul precision rules, written once.

JAX's ``jnp.matmul(x.astype(dt), w.astype(dt),
preferred_element_type=float32)`` multiplies values rounded to the
compute dtype and accumulates in float32.  ``matmul_f32`` does the same
by upcasting the rounded operands: float32 products of bf16 values are
exact, so only the order of the float32 sum can differ.  Without
``preferred_element_type`` JAX returns the compute dtype: ``matmul_dt``
rounds the float32 result once; on the card, where a 16-bit product
accumulates in float32 (cuBLAS's compute type, with reduced-precision
reductions off: ``decode.plain_numerics``), it is that one product.
These serve the model modules; the products of the reference's Pallas
kernels run in the CUDA kernels of ``ops.kernels``.
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` (a config's compute_dtype) -> ``torch.bfloat16``."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def matmul_f32(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    dt = torch_dtype(dt)
    return torch.matmul(x.to(dt).to(torch.float32),
                        w.to(dt).to(torch.float32))


def matmul_dt(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    dt = torch_dtype(dt)
    if x.is_cuda and dt != torch.float32:
        return torch.matmul(x.to(dt), w.to(dt))
    return matmul_f32(x, w, dt).to(dt)
