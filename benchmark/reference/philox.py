"""Philox4x32-10 Gumbel noise, a frozen copy of the arithmetic the port's
sampler draws with (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC 2011), so that the reference can replay a sampled token.

* shared-seed mode: key = (seed low word, seed high word), counter =
  (level // 4, position low, position high, lane);
* lane-key mode: key = the lane's two 32-bit words, counter = (level // 4,
  position low, position high, 0);
* level ``n`` takes word ``n % 4``; bits -> ``u = (bits & 0x7fffff) *
  2**-23 + 1e-7`` clamped to ``1 - 2**-24``, noise ``-log(-log(u))``,
  all float32.

Words are held in int64 tensors; products are split into 16-bit halves.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    b_lo, b_hi = b & 0xFFFF, b >> 16
    p_lo, p_hi = a * b_lo, a * b_hi
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox(ctr, key):
    """Four output words of Philox4x32-10 for counter words ``ctr`` and
    key words ``key`` (int64 tensors or ints that broadcast)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def gumbel(key, lane, pos, q_levels: int) -> torch.Tensor:
    """Noise float32 [B, T, q_levels] for positions ``pos`` ([B, T] int64)
    of lanes keyed by ``key`` (two [B, 1] int64 word tensors) with counter
    word 3 ``lane`` ([B, 1] int64: the lane index in shared-seed mode, 0 in
    lane-key mode)."""
    groups = -(-q_levels // 4)
    b, t = pos.shape
    grp = torch.arange(groups, dtype=torch.int64, device=pos.device)
    shape = (b, t, groups)
    ctr = (grp.view(1, 1, groups).expand(shape),
           (pos & _MASK)[..., None].expand(shape),
           (pos >> 32)[..., None].expand(shape),
           lane.view(b, 1, 1).expand(shape))
    k = (key[0].view(b, 1, 1), key[1].view(b, 1, 1))
    words = philox(ctr, k)
    bits = torch.stack(words, dim=-1).reshape(b, t, groups * 4)[..., :q_levels]
    u = (bits & 0x7FFFFF).to(torch.float32) * (1.0 / (1 << 23)) + 1e-7
    u = torch.clamp(u, max=1.0 - 2.0 ** -24)
    return -torch.log(-torch.log(u))
