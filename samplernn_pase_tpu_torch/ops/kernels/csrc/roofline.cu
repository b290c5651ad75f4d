// K8 vpu_tail and K9 mxu_stream: the roofline microkernels that measure
// K1's two halves in isolation at the flagship's shapes (B=128, H=1024,
// q=256, f1=16, bf16 weights).
//
// K8 replaces scripts/vpu_ceiling.py:vpu_tail (_vpu_kernel), the serial
// sampler tail of the TPU megakernel: per frame the Gumbel block
// ([f1, B, q]: the supplied one, or Philox4x32-10 keyed by `seed` and
// counted by (level / 4, position, lane) with the port's clamp, in place
// of the TPU's on-core PRNG), then f1 serial steps of
//   scores = logits + T * g[i]   (two roundings, as the plain version)
//   sample = argmax(scores)      (ties to the lowest level)
//   ring[:, ((t + i) % f1) * q : +q] = one_hot(sample) in bf16
// and the sample window rolls by one; the output is the last f1 samples
// of every lane.  One warp per lane, one lane per block: each thread owns
// q/128 groups of 4 consecutive levels (one Philox call, one 16-byte noise
// load, one 8-byte one-hot store per group), the frame's noise sits in
// shared memory, and the argmax is a warp shuffle reduction.  Bound: the
// serial chain of f1 * n_frames argmax reductions, not bytes or
// operations; the bytes and float32 operations give the roofline.
//
// K9 replaces scripts/vpu_ceiling.py:mxu_stream (_mxu_kernel), the
// per-step product stream with bf16 inputs and float32 accumulation:
// per frame the hoist [B,H]x[H,f1*H] (its first q columns added into the
// [B, q] accumulator), then per step the window head and tail
// [B,(f1-1)q]x[(f1-1)q,H] + [B,q]x[q,H] (one K loop over both weight
// matrices), relu to bf16, [B,H]x[H,H], relu to bf16, [B,H]x[H,q] added
// into the accumulator.  The inputs do not change from step to step, as
// in the TPU kernel; every product is computed and kept live all the
// same.  Each product is one launch of the skinny split-K wgmma core that
// K2 uses (skinny_gemm.cuh: K split across a thread-block cluster, W by
// TMA, A staged by TMA, partials summed in rank order
// through distributed shared memory), with K9's epilogue after the sum;
// one call enqueues n_frames * (1 + 3 f1) of them, each on the plan its
// K and N give (decode.gemm_plan, passed in by the wrapper).  Bound:
// operations, 26.8 GFLOP per frame at the flagship's shapes, 27 us at
// 989 TFLOP/s; a product at M = B = 128 is bound by its weight bytes,
// which its plan spreads over 16-128 CTAs.  Needs B, H and q multiples
// of 64.

#include "common.cuh"
#include "philox.cuh"
#include "skinny_gemm.cuh"

namespace {

// ---------------------------------------------------------------- K8 --

constexpr int VPU_THREADS = 32;
constexpr int MAX_GROUPS = 8;   // q <= 1024: 4-level groups per thread

__global__ void __launch_bounds__(VPU_THREADS)
vpu_tail_kernel(const float* __restrict__ logits,
                const float* __restrict__ gum, int use_prng, uint64_t seed,
                float temperature, int n_frames,
                __nv_bfloat16* __restrict__ ring, int32_t* __restrict__ out,
                int b, int q, int f1) {
  extern __shared__ float4 g4[];                 // [f1][q / 4]
  const int t = threadIdx.x, lane = blockIdx.x;
  const int groups = q / (4 * VPU_THREADS);
  const int qg = q / 4;
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  float4 lg[MAX_GROUPS];
#pragma unroll
  for (int j = 0; j < MAX_GROUPS; ++j)
    if (j < groups)
      lg[j] = reinterpret_cast<const float4*>(
          logits + static_cast<int64_t>(lane) * q)[t + VPU_THREADS * j];
  int32_t blk = 0;   // thread i < f1 holds the window's slot i
  for (int frame = 0; frame < n_frames; ++frame) {
    __syncwarp();    // the last frame's steps have read the noise
    for (int e = t; e < f1 * qg; e += VPU_THREADS) {
      const int i = e / qg, grp = e % qg;
      float4 v;
      if (use_prng) {
        const uint4 o = srnn::philox_words(
            key, static_cast<uint32_t>(lane),
            static_cast<int64_t>(frame) * f1 + i, grp);
        v = make_float4(srnn::bits_gumbel(o.x), srnn::bits_gumbel(o.y),
                        srnn::bits_gumbel(o.z), srnn::bits_gumbel(o.w));
      } else {
        v = reinterpret_cast<const float4*>(
            gum + (static_cast<int64_t>(i) * b + lane) * q)[grp];
      }
      g4[e] = v;
    }
    __syncwarp();
    for (int i = 0; i < f1; ++i) {
      float best = -INFINITY;
      int arg = 4 * t;
#pragma unroll
      for (int j = 0; j < MAX_GROUPS; ++j) {
        if (j >= groups) break;
        const int grp = t + VPU_THREADS * j;
        const float4 gv = g4[i * qg + grp];
        const float s[4] = {
            __fadd_rn(lg[j].x, __fmul_rn(temperature, gv.x)),
            __fadd_rn(lg[j].y, __fmul_rn(temperature, gv.y)),
            __fadd_rn(lg[j].z, __fmul_rn(temperature, gv.z)),
            __fadd_rn(lg[j].w, __fmul_rn(temperature, gv.w))};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (s[u] > best) {
            best = s[u];
            arg = 4 * grp + u;
          }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (ov > best || (ov == best && oa < arg)) {
          best = ov;
          arg = oa;
        }
      }
      // the one-hot row into the ring slot, 4 bf16 (8 bytes) per group
      const int slot = (frame + i) % f1;
      uint2* row = reinterpret_cast<uint2*>(
          ring + (static_cast<int64_t>(lane) * f1 + slot) * q);
#pragma unroll
      for (int j = 0; j < MAX_GROUPS; ++j) {
        if (j >= groups) break;
        const int grp = t + VPU_THREADS * j, l0 = 4 * grp;
        const uint32_t one = 0x3F80u;   // bf16 1.0
        row[grp] = make_uint2(
            (l0 == arg ? one : 0u) | (l0 + 1 == arg ? one : 0u) << 16,
            (l0 + 2 == arg ? one : 0u) | (l0 + 3 == arg ? one : 0u) << 16);
      }
      const int32_t next = __shfl_down_sync(0xffffffffu, blk, 1);
      blk = t == f1 - 1 ? arg : next;
    }
  }
  if (t < f1) out[static_cast<int64_t>(lane) * f1 + t] = blk;
}

// ---------------------------------------------------------------- K9 --

// What a product does with its float32 tile (after the cluster's split-K
// sum): store it (f32), store relu(v) rounded to bf16, and/or add it into
// acc's first acc_cols columns.  Four columns at a time; every width is a
// multiple of 64.
struct Epilogue {
  float* store_f32;
  __nv_bfloat16* relu_bf16;
  float* acc;
  int acc_cols;

  struct In {
    float4 acc;
  };

  __device__ __forceinline__ In load(int row, int col, int) const {
    In in{make_float4(0.f, 0.f, 0.f, 0.f)};
    if (acc && col < acc_cols)
      in.acc = *reinterpret_cast<const float4*>(
          acc + static_cast<int64_t>(row) * acc_cols + col);
    return in;
  }

  __device__ __forceinline__ void store(int row, int col, float4 v,
                                        const In& in, int n) const {
    const int64_t at = static_cast<int64_t>(row) * n + col;
    if (store_f32) *reinterpret_cast<float4*>(store_f32 + at) = v;
    if (relu_bf16) {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(relu_bf16 + at);
      dst[0] = __floats2bfloat162_rn(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
      dst[1] = __floats2bfloat162_rn(fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
    }
    if (acc && col < acc_cols)
      *reinterpret_cast<float4*>(acc + static_cast<int64_t>(row) * acc_cols +
                                 col) =
          make_float4(in.acc.x + v.x, in.acc.y + v.y, in.acc.z + v.z,
                      in.acc.w + v.w);
  }
};

// C[M,N] = A[M,K] @ W[K,N] on the skinny core, bf16 in, float32
// accumulate; A's rows are lda apart; W's rows [0, k_split) come from w0
// and [k_split, K) from w1.  The plan (split, bn, groups) comes from
// the wrapper (vpu_ceiling.py, decode.gemm_plan of K and N).
struct Plan {
  int split, bn, groups;
};

int gemm(const __nv_bfloat16* a, int64_t lda, const __nv_bfloat16* w0,
         const __nv_bfloat16* w1, int k_split, int m, int n, int k,
         const Plan& pl, Epilogue epi, cudaStream_t stream) {
  namespace sk = srnn::skinny;
  const sk::Problem p{a, lda, 1.f, 1.f, w0, w1 ? w1 : w0, k_split, m, n, k,
                      pl.split, pl.groups, 0, 0};
  return sk::run<sk::A_BF16>(p, pl.bn, epi, stream);
}

}  // namespace

extern "C" int srnn_vpu_tail(const float* logits, const float* gum,
                             int use_prng, uint64_t seed, float temperature,
                             int n_frames, void* ring, int32_t* out, int b,
                             int q, int f1, void* stream) {
  const size_t smem = sizeof(float) * f1 * q;
  cudaError_t err = cudaFuncSetAttribute(
      vpu_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  vpu_tail_kernel<<<b, VPU_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      logits, gum, use_prng, seed, temperature, n_frames,
      static_cast<__nv_bfloat16*>(ring), out, b, q, f1);
  return static_cast<int>(cudaGetLastError());
}

// plans: [4][3] ints (split, bn, groups) of the hoist, the window head
// and tail, the hidden product and the output product
extern "C" int srnn_mxu_stream(const void* ebuf, const void* w1,
                               const void* w2, const void* wh, const void* wo,
                               const void* wup, float* acc, float* hoist,
                               void* hm, void* h2, int b, int h, int q,
                               int f1, int n_frames, const int* plans,
                               void* stream) {
  using bf = const __nv_bfloat16*;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf e = static_cast<bf>(ebuf);
  const int ring = f1 * q, head = (f1 - 1) * q;
  __nv_bfloat16* hmb = static_cast<__nv_bfloat16*>(hm);
  __nv_bfloat16* h2b = static_cast<__nv_bfloat16*>(h2);
  const Plan up{plans[0], plans[1], plans[2]};
  const Plan win{plans[3], plans[4], plans[5]};
  const Plan hid{plans[6], plans[7], plans[8]};
  const Plan out{plans[9], plans[10], plans[11]};
  for (int frame = 0; frame < n_frames; ++frame) {
    // the hoist reads the ring's first h columns (rows ring apart)
    int err = gemm(e, ring, static_cast<bf>(wup), nullptr, h, b, f1 * h, h,
                   up, Epilogue{hoist, nullptr, acc, q}, s);
    if (err) return err;
    for (int i = 0; i < f1; ++i) {
      // head and tail: the whole ring against w1's then w2's rows
      err = gemm(e, ring, static_cast<bf>(w1), static_cast<bf>(w2), head, b,
                 h, ring, win, Epilogue{nullptr, hmb, nullptr, 0}, s);
      if (!err)
        err = gemm(hmb, h, static_cast<bf>(wh), nullptr, h, b, h, h, hid,
                   Epilogue{nullptr, h2b, nullptr, 0}, s);
      if (!err)
        err = gemm(h2b, h, static_cast<bf>(wo), nullptr, h, b, q, h, out,
                   Epilogue{nullptr, nullptr, acc, q}, s);
      if (err) return err;
    }
  }
  return 0;
}
