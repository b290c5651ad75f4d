// Philox4x32-10 Gumbel noise, the device twin of ops/kernels/noise.py
// (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011).
// Shared by K1 (frame_decode.cu) and K8 (roofline.cu).
#pragma once

#include <math.h>
#include <stdint.h>

namespace srnn {

__device__ __forceinline__ uint32_t mulhilo(uint32_t a, uint32_t b,
                                            uint32_t* hi) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  *hi = static_cast<uint32_t>(p >> 32);
  return static_cast<uint32_t>(p);
}

__device__ inline uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    uint32_t hi0, hi1;
    const uint32_t lo0 = mulhilo(0xD2511F53u, c.x, &hi0);
    const uint32_t lo1 = mulhilo(0xCD9E8D57u, c.z, &hi1);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The megakernel's bits -> noise transform (23-bit mask, * 2^-23, + 1e-7,
// -log(-log u)), with u clamped to 1 - 2^-24 so that the largest word
// gives finite noise, not +inf.
__device__ __forceinline__ float bits_gumbel(uint32_t bits) {
  const float u = fminf(
      static_cast<float>(bits & 0x7FFFFFu) * (1.f / 8388608.f) + 1e-7f,
      1.f - 1.f / 16777216.f);
  return -logf(-logf(u));
}

// The four 32-bit words of counter (group, position low, position high,
// word3) under key: levels 4*group .. 4*group+3 take words 0..3.
__device__ __forceinline__ uint4 philox_words(uint2 key, uint32_t word3,
                                              int64_t pos, int group) {
  const uint4 ctr = make_uint4(
      static_cast<uint32_t>(group), static_cast<uint32_t>(pos),
      static_cast<uint32_t>(static_cast<uint64_t>(pos) >> 32), word3);
  return philox4x32_10(ctr, key);
}

// Gumbel noise of `level` at `pos`: counter word 3 is the lane index when
// one seed keys every lane, and 0 under a lane's own key.
__device__ inline float philox_gumbel(uint2 key, uint32_t word3,
                                      int64_t pos, int level) {
  const uint4 o = philox_words(key, word3, pos, level >> 2);
  const int w = level & 3;
  return bits_gumbel(w == 0 ? o.x : w == 1 ? o.y : w == 2 ? o.z : o.w);
}

}  // namespace srnn
