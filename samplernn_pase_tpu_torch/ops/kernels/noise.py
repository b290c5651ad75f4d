"""Counter-based Gumbel noise: the plain PyTorch twin of the Philox4x32-10
draw inside ``csrc/frame_decode.cu``.

The TPU megakernel draws its Gumbel noise on-core
(``samplernn_pase_tpu/ops/pallas/megagen.py``, ``pltpu.prng_random_bits``);
those bits cannot be reproduced on another machine.  The port draws from
Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC 2011) instead:

* key = (seed & 0xffffffff, seed >> 32);
* counter = (level // 4, position & 0xffffffff, position >> 32, lane),
  and level ``n`` takes word ``n % 4`` of the output;
* bits -> noise as the megakernel does: keep the low 23 bits, scale by
  2**-23, add 1e-7, then ``-log(-log(u))``, all float32; except that ``u``
  is clamped to ``1 - 2**-24``.  Without the clamp the largest 23-bit
  word gives ``u = 1.0f`` and +inf noise, a uniform pick in place of a
  Gumbel one, once in 2**23 draws (the reference's transform,
  ``megagen.py:417-421``, has that flaw).

``position`` is the absolute sample index, so a lane's noise is a pure
function of (seed, lane, position, level): it does not depend on how a
generation is chunked.

Per-lane keys (``lane_gumbel_block``, K1's noise mode 3) are the port's
counterpart of the reference's ``lane_keys`` (``generate.py:
_lane_gumbel_block``): lane b draws with its own key ``lane_keys[b]``
(two 32-bit words) and counter (level // 4, p low, p high, 0) at its own
position p.  The counter holds no lane index, so a lane's noise is a pure
function of its key and its positions, whatever batch it runs in: a pool
lane equals a solo generator given the same key.  ``lane_key`` derives a
pool lane's default key from (seed, lane, epoch), the counterpart of
``fold_in(fold_in(pool_key, lane), epoch)`` (``serve.py:76-78``).

The arithmetic below uses int64 tensors holding 32-bit words; products are
split into 16-bit halves so no intermediate leaves int64.
"""

from __future__ import annotations

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_KEY_DOMAIN = 0x4B455953      # counter word 3 of lane_key's draw ("KEYS")


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a * b."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    p_lo, p_hi = a * b_lo, a * b_hi          # each < 2**48
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(ctr, key):
    """ctr: 4 int64 tensors of 32-bit words (broadcastable); key: 2 ints
    or int64 tensors that broadcast with ctr.  Returns the 4 output words
    as int64 tensors."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_gumbel(bits: torch.Tensor) -> torch.Tensor:
    u = (bits & 0x7FFFFF).to(torch.float32) * (1.0 / (1 << 23)) + 1e-7
    u = torch.clamp(u, max=1.0 - 2.0 ** -24)
    return -torch.log(-torch.log(u))


def _positions(pos0, n_lanes: int, n_pos: int, device) -> torch.Tensor:
    """int64 [n_pos, n_lanes, 1]: ``pos0 + i``, pos0 an int or a [n_lanes]
    tensor (one first position per lane)."""
    steps = torch.arange(n_pos, dtype=torch.int64, device=device)
    if isinstance(pos0, torch.Tensor):
        pos0 = pos0.to(device=device, dtype=torch.int64).reshape(1, -1)
        if pos0.shape[1] != n_lanes:
            raise ValueError(f"pos0 has {pos0.shape[1]} lanes, expected "
                             f"{n_lanes}")
        return (pos0 + steps[:, None])[..., None]
    return (int(pos0) + steps).view(n_pos, 1, 1).expand(n_pos, n_lanes, 1)


def _draw(key, pos, lane, n_pos: int, n_lanes: int, q_levels: int):
    groups = -(-q_levels // 4)
    grp = torch.arange(groups, dtype=torch.int64,
                       device=pos.device).view(1, 1, groups)
    shape = (n_pos, n_lanes, groups)
    ctr = (grp.expand(shape), (pos & _MASK32).expand(shape),
           (pos >> 32).expand(shape), lane.expand(shape))
    words = philox4x32_10(ctr, key)
    bits = torch.stack(words, dim=-1).reshape(n_pos, n_lanes, groups * 4)
    return bits_to_gumbel(bits[..., :q_levels])


def gumbel_block(seed: int, n_lanes: int, pos0, n_pos: int, q_levels: int,
                 device=None) -> torch.Tensor:
    """Noise for positions ``pos0 .. pos0+n_pos-1`` of lanes
    ``0 .. n_lanes-1``: float32 ``[n_pos, n_lanes, q_levels]``.  ``pos0``
    is an int or a [n_lanes] tensor of per-lane first positions."""
    pos = _positions(pos0, n_lanes, n_pos, device)
    lane = torch.arange(n_lanes, dtype=torch.int64,
                        device=pos.device).view(1, n_lanes, 1)
    return _draw((seed & _MASK32, (seed >> 32) & _MASK32), pos, lane, n_pos,
                 n_lanes, q_levels)


def as_lane_keys(keys, device=None) -> torch.Tensor:
    """Lane keys ([B, 2] 32-bit words: a numpy uint32 array, or a tensor of
    any integer type) -> int64 [B, 2] holding the unsigned words."""
    if isinstance(keys, torch.Tensor):
        t = keys.to(device=device, dtype=torch.int64) & _MASK32
    else:
        t = torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64))
        t = t.to(device)
    if t.dim() != 2 or t.shape[1] != 2:
        raise ValueError(f"lane keys must be [B, 2] 32-bit words, got "
                         f"{tuple(t.shape)}")
    return t


def lane_gumbel_block(lane_keys, pos0, n_pos: int, q_levels: int,
                      device=None) -> torch.Tensor:
    """Per-lane noise: float32 ``[n_pos, B, q_levels]`` where lane b draws
    with key ``lane_keys[b]`` at positions ``pos0_b .. pos0_b+n_pos-1``.
    lane_keys [B, 2] (see ``as_lane_keys``); pos0 an int or a [B] tensor;
    drawn on ``device``, else where the keys are.  The plain twin of K1's
    noise mode 3."""
    if device is None and isinstance(lane_keys, torch.Tensor):
        device = lane_keys.device
    keys = as_lane_keys(lane_keys, device)
    b = keys.shape[0]
    pos = _positions(pos0, b, n_pos, keys.device)
    key = (keys[:, 0].view(1, b, 1), keys[:, 1].view(1, b, 1))
    lane = torch.zeros((1, b, 1), dtype=torch.int64, device=keys.device)
    return _draw(key, pos, lane, n_pos, b, q_levels)


def lane_key(seed: int, lane: int, epoch: int) -> np.ndarray:
    """A pool lane's default noise key: [2] uint32, word 0 and 1 of the
    Philox draw keyed by ``seed`` at counter (lane, epoch, 0, "KEYS").
    Distinct per (lane, epoch) and independent of every other lane."""
    ctr = tuple(torch.tensor([c], dtype=torch.int64)
                for c in (lane & _MASK32, epoch & _MASK32, 0, _KEY_DOMAIN))
    words = philox4x32_10(ctr, (seed & _MASK32, (seed >> 32) & _MASK32))
    return np.array([int(words[0]), int(words[1])], np.uint32)


def int_key(n: int) -> np.ndarray:
    """The [2] uint32 words of the reference's ``jax.random.PRNGKey(n)``
    for an int seed (32-bit JAX, its default): ``[0, n mod 2**32]`` for n
    in the int64 range, ``OverflowError`` outside it, where JAX raises."""
    n = int(np.int64(n))
    return np.array([0, n & _MASK32], np.uint32)
