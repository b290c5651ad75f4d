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
// of every lane.  Bound: the serial chain of f1 * n_frames argmax
// reductions, not bytes or operations; the bytes and float32 operations
// give the roofline.  The noise depends on (seed, lane, position) alone,
// never on a sample, so it is drawn off the chain: one block per lane,
// one chain warp alone on its SM sub-partition and producer warps on the
// other three that fill a ring of noise slots in shared memory ahead of
// it (mbarriers per slot, full and empty), the block's shared memory
// sized so that no two lanes share an SM.  The chain keeps the logits in
// registers, reduces with two redux.sync per step and writes two bf16 of
// the one-hot ring per step once the ring has been written whole.
// vpu_ceiling.vpu_plan owns the producer count, the slot depth and the
// ring's size; the kernel takes them as arguments.
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

constexpr int MAX_WARPS = 16;   // a block's warps (vpu_warps): 12 producers
// A wait that has not ended after about 10 s (2e10 cycles) traps: the
// launch fails with an error instead of holding the card.
constexpr long long WAIT_LIMIT = 20000000000LL;

// Phase trace (scripts/vpu_ceiling.py --trace): with a buffer set by
// srnn_vpu_tail_trace, the launch runs the kernel's traced instantiation,
// and thread 0 of block 0 (the chain's lane 0) writes clock64() for frame
// f < TRACE_FRAMES at trace[f * TRACE_PER]: the frame's start, and for
// its step i at trace[f * TRACE_PER + 1 + 5 * i + k]: k = 0 the scores
// and the thread's max, 1 the next step's noise (the slot's wait where a
// slot starts, the loads issued), 2 the warp's argmax, 3 the ring
// stored, 4 the window kept.  At trace[TRACE_FRAMES * TRACE_PER + 0..3]:
// clock64 and %globaltimer at block 0's entry and exit; from
// TRACE_FRAMES * TRACE_PER + 4, for chunk c < TRACE_CHUNKS, three clocks
// of its producer's lane 0 in block 0: the wait for its slot begun, the
// slot free, the slot filled.
constexpr int TRACE_FRAMES = 16;
constexpr int TRACE_PER = 168;
constexpr int TRACE_CHUNKS = 64;
unsigned long long* g_vpu_trace = nullptr;   // host side: the next launches'

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}
template <bool kTrace>
__device__ __forceinline__ void vpu_trace_at(unsigned long long* tr,
                                             int frame, int at) {
  if (kTrace && blockIdx.x == 0 && threadIdx.x == 0 &&
      frame < TRACE_FRAMES)
    tr[frame * TRACE_PER + at] = clock64();
}
// the same after `dep` is computed: the compiler does not move a
// phase's arithmetic past the clock read that closes it
template <bool kTrace>
__device__ __forceinline__ void vpu_trace_after(unsigned long long* tr,
                                                int frame, int at,
                                                uint32_t dep) {
  if (kTrace) asm volatile("" :: "r"(dep));
  vpu_trace_at<kTrace>(tr, frame, at);
}
template <bool kTrace>
__device__ __forceinline__ void vpu_trace_block(unsigned long long* tr,
                                                int end) {
  if (kTrace && blockIdx.x == 0 && threadIdx.x == 0) {
    tr[TRACE_FRAMES * TRACE_PER + 2 * end] = clock64();
    tr[TRACE_FRAMES * TRACE_PER + 2 * end + 1] = globaltimer();
  }
}

template <bool kTrace>
__device__ __forceinline__ void vpu_trace_chunk(unsigned long long* tr,
                                                int chunk, int at) {
  if (kTrace && blockIdx.x == 0 && threadIdx.x % 32 == 0 &&
      chunk < TRACE_CHUNKS)
    tr[TRACE_FRAMES * TRACE_PER + 4 + 3 * chunk + at] = clock64();
}

__device__ __forceinline__ bool mbar_ready(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(srnn::sm90::smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  int parity) {
  if (mbar_ready(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_ready(bar, parity))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}

// The producers: warp w (1 .. producers) fills chunks w - 1, w - 1 +
// producers, ... of `steps` steps each into ring slot chunk % slots, once
// the chain has released the slot's previous chunk: the noise scaled by
// the temperature (the first of the scores' two roundings), Philox or the
// supplied rows.  Each lane arrives on the slot's full barrier after its
// own stores.
template <bool kTrace>
__device__ __forceinline__ void vpu_produce(
    float4* noise, uint64_t* full, uint64_t* empty, const float* gum,
    int use_prng, uint2 key, float temperature, int b, int q, int f1,
    int chunks, int producers, int steps, int slots, int first,
    unsigned long long* tr) {
  const int t = threadIdx.x % 32;
  const int lane = blockIdx.x, qg = q / 4;
  for (int c = first; c < chunks; c += producers) {
    const int slot = c % slots, use = c / slots;
    vpu_trace_chunk<kTrace>(tr, c, 0);
    if (use > 0) mbar_wait_or_trap(empty + slot, (use - 1) & 1);
    vpu_trace_chunk<kTrace>(tr, c, 1);
    const int64_t n0 = static_cast<int64_t>(c) * steps;   // its position
    const int i0 = static_cast<int>(n0 % f1);
    float4* dst = noise + static_cast<int64_t>(slot) * steps * qg;
    for (int st = 0; st < steps; ++st) {
      const float4* row = reinterpret_cast<const float4*>(
          gum + (static_cast<int64_t>(i0 + st) * b + lane) * q);
#pragma unroll
      for (int grp = t; grp < qg; grp += 32) {
        float4 v;
        if (use_prng) {
          const uint4 o = srnn::philox_words(
              key, static_cast<uint32_t>(lane), n0 + st, grp);
          v = make_float4(srnn::bits_gumbel(o.x), srnn::bits_gumbel(o.y),
                          srnn::bits_gumbel(o.z), srnn::bits_gumbel(o.w));
        } else {
          v = row[grp];
        }
        dst[st * qg + grp] = make_float4(
            __fmul_rn(temperature, v.x), __fmul_rn(temperature, v.y),
            __fmul_rn(temperature, v.z), __fmul_rn(temperature, v.w));
      }
    }
    vpu_trace_chunk<kTrace>(tr, c, 2);
    srnn::sm90::mbar_arrive(full + slot);
  }
}

// One block per lane: warp 0 is the serial chain, the producer warps
// (vpu_produce) draw the noise ahead of it.  G = q / 128: the chain's
// lane t holds the logits of levels 4 (t + 32 j) .. + 3, j < G, in
// registers.  Per step: the scores (the scaled noise, loaded while the
// step before reduced, added to the logits: the second rounding) and the
// lane's max with ties to its lowest level; the next step's noise loaded
// (the slot just read released to the producers, the next one waited
// for where a slot starts); the warp's argmax: __reduce_max_sync over an
// order-preserving key of the lane's max (-0.0 taken as +0.0, as the
// compare and torch.argmax see them), then __reduce_min_sync over the
// levels of the lanes holding that key; then the one-hot row into ring
// slot (frame + i) % f1: whole rows in frame 0 (the ring starts
// uninitialised), from then on only the zero at the level the slot held
// and the one at the new level, both by lane 0.  Lane i keeps step i's
// sample: the window, written out at the end.
template <int G, bool kTrace>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
vpu_tail_kernel(const float* __restrict__ logits,
                const float* __restrict__ gum, int use_prng, uint64_t seed,
                float temperature, int n_frames,
                __nv_bfloat16* __restrict__ ring, int32_t* __restrict__ out,
                int b, int f1, int producers, int steps, int slots,
                unsigned long long* tr) {
  constexpr int q = 128 * G, qg = q / 4;
  extern __shared__ __align__(16) unsigned char vpu_smem[];
  float4* noise = reinterpret_cast<float4*>(vpu_smem);   // [slots][steps][qg]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      vpu_smem + static_cast<size_t>(slots) * steps * q * sizeof(float));
  uint64_t* empty = full + slots;
  const int t = threadIdx.x % 32, lane = blockIdx.x, warp = threadIdx.x / 32;
  const int chunks = n_frames * (f1 / steps);
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      srnn::sm90::mbar_init(full + s, 32);
      srnn::sm90::mbar_init(empty + s, 1);
    }
  }
  __syncthreads();
  if (warp > 0) {
    // producers 0, 1, 2, ... are warps 1, 2, 3, 5, 6, 7, ...: none shares
    // the chain's SM sub-partition (warp % 4 == 0), whose warps idle
    const int first = warp % 4 ? warp - 1 - warp / 4 : -1;
    if (first >= 0 && first < producers)
      vpu_produce<kTrace>(noise, full, empty, gum, use_prng,
                          make_uint2(static_cast<uint32_t>(seed),
                                     static_cast<uint32_t>(seed >> 32)),
                          temperature, b, q, f1, chunks, producers, steps,
                          slots, first, tr);
    return;
  }

  vpu_trace_block<kTrace>(tr, 0);
  float4 lg[G], tg[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    lg[j] = reinterpret_cast<const float4*>(
        logits + static_cast<int64_t>(lane) * q)[t + 32 * j];
  if (chunks > 0) {
    mbar_wait_or_trap(full, 0);
#pragma unroll
    for (int j = 0; j < G; ++j) tg[j] = noise[t + 32 * j];
  }
  int held = 0, win = 0;   // lane s: the level ring slot s holds; lane i:
                           // step i's sample
  // the chunk being read: its index, ring slot, phase parity, step in it
  // and the next step's row
  int chunk = 0, cslot = 0, cphase = 0, in_chunk = 0;
  const float4* src = noise;
  uint16_t* const ring_lane = reinterpret_cast<uint16_t*>(
      ring + static_cast<int64_t>(lane) * f1 * q);
  for (int frame = 0; frame < n_frames; ++frame) {
    vpu_trace_at<kTrace>(tr, frame, 0);
    int slot = frame % f1;
    uint16_t* row = ring_lane + slot * q;   // ring slot (frame + i) % f1
    for (int i = 0; i < f1; ++i) {
      const int old = __shfl_sync(0xffffffffu, held, slot);
      // the scores and this lane's max, ties to its lowest level
      float bv[4 * G];
      int bi[4 * G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        bv[4 * j] = __fadd_rn(lg[j].x, tg[j].x);
        bv[4 * j + 1] = __fadd_rn(lg[j].y, tg[j].y);
        bv[4 * j + 2] = __fadd_rn(lg[j].z, tg[j].z);
        bv[4 * j + 3] = __fadd_rn(lg[j].w, tg[j].w);
#pragma unroll
        for (int u = 0; u < 4; ++u) bi[4 * j + u] = 4 * (t + 32 * j) + u;
      }
#pragma unroll
      for (int w = 1; w < 4 * G; w *= 2)
#pragma unroll
        for (int v = 0; v + w < 4 * G; v += 2 * w)
          if (bv[v + w] > bv[v]) {
            bv[v] = bv[v + w];
            bi[v] = bi[v + w];
          }
      vpu_trace_after<kTrace>(tr, frame, 1 + 5 * i, bi[0]);
      // the next step's noise; the slot just read goes back to the
      // producers once its last step is scored
      if (++in_chunk == steps) {
        in_chunk = 0;
        __syncwarp();
        if (t == 0) srnn::sm90::mbar_arrive(empty + cslot);
        if (++cslot == slots) {
          cslot = 0;
          cphase ^= 1;
        }
        src = noise + static_cast<int64_t>(cslot) * steps * qg;
        if (++chunk < chunks) mbar_wait_or_trap(full + cslot, cphase);
      } else {
        src += qg;
      }
      if (chunk < chunks) {
#pragma unroll
        for (int j = 0; j < G; ++j) tg[j] = src[t + 32 * j];
      }
      vpu_trace_at<kTrace>(tr, frame, 2 + 5 * i);
      // the warp's argmax: an order-preserving key of the lane's max
      // (-0.0 + 0.0 = +0.0), then the lowest level holding the top key
      const uint32_t u = __float_as_uint(__fadd_rn(bv[0], 0.0f));
      const uint32_t key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
      const uint32_t top = __reduce_max_sync(0xffffffffu, key);
      const int arg = static_cast<int>(__reduce_min_sync(
          0xffffffffu,
          key == top ? static_cast<uint32_t>(bi[0]) : 0xffffffffu));
      vpu_trace_after<kTrace>(tr, frame, 3 + 5 * i, arg);
      if (frame == 0) {
        uint2* row4 = reinterpret_cast<uint2*>(row);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int grp = t + 32 * j, l0 = 4 * grp;
          const uint32_t one = 0x3F80u;   // bf16 1.0
          row4[grp] = make_uint2(
              (l0 == arg ? one : 0u) | (l0 + 1 == arg ? one : 0u) << 16,
              (l0 + 2 == arg ? one : 0u) | (l0 + 3 == arg ? one : 0u) << 16);
        }
      } else if (t == 0) {
        if (old != arg) row[old] = 0;
        row[arg] = 0x3F80u;
      }
      vpu_trace_at<kTrace>(tr, frame, 4 + 5 * i);
      if (t == slot) held = arg;
      if (t == i) win = arg;
      if (++slot == f1) {
        slot = 0;
        row = ring_lane;
      } else {
        row += q;
      }
      vpu_trace_after<kTrace>(tr, frame, 5 + 5 * i, win + held);
    }
    // every lane stored whole rows in frame 0, lane 0 alone rewrites them
    // from frame 1 on: order the two (the step's shuffles and redux do not
    // order memory), once per launch
    if (frame == 0) __syncwarp();
  }
  if (t < f1) out[static_cast<int64_t>(lane) * f1 + t] = win;
  vpu_trace_block<kTrace>(tr, 1);
}

// the block's warps: the chain, the producers, and one idle warp beside
// every three producers from the fourth sub-partition's turn on
constexpr int vpu_warps(int producers) {
  return producers + 1 + (producers - 1) / 3;
}

template <int G, bool kTrace>
int launch_vpu(const float* logits, const float* gum, int use_prng,
               uint64_t seed, float temperature, int n_frames, void* ring,
               int32_t* out, int b, int f1, int producers, int steps,
               int slots, int smem, cudaStream_t stream) {
  auto* kernel = vpu_tail_kernel<G, kTrace>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, 32 * vpu_warps(producers), smem, stream>>>(
      logits, gum, use_prng, seed, temperature, n_frames,
      static_cast<__nv_bfloat16*>(ring), out, b, f1, producers, steps,
      slots, g_vpu_trace);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTrace>
int dispatch_vpu(int q, const float* logits, const float* gum, int use_prng,
                 uint64_t seed, float temperature, int n_frames, void* ring,
                 int32_t* out, int b, int f1, int producers, int steps,
                 int slots, int smem, cudaStream_t stream) {
#define SRNN_VPU_Q(G)                                                      \
  case G:                                                                  \
    return launch_vpu<G, kTrace>(logits, gum, use_prng, seed, temperature, \
                                 n_frames, ring, out, b, f1, producers,    \
                                 steps, slots, smem, stream);
  switch (q / 128) {
    SRNN_VPU_Q(1) SRNN_VPU_Q(2) SRNN_VPU_Q(3) SRNN_VPU_Q(4)
    SRNN_VPU_Q(5) SRNN_VPU_Q(6) SRNN_VPU_Q(7) SRNN_VPU_Q(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SRNN_VPU_Q
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

// K8 under the plan (vpu_ceiling.vpu_plan): `producers` warps beside the
// chain, `steps` steps per noise slot, `slots` slots, `smem` bytes of
// dynamic shared memory; q a multiple of 128 up to 1024, f1 in 1..32 (a
// chain lane per ring slot) and a multiple of `steps`.  A plan the kernel
// cannot run (too many warps, fewer slots than producers, a ring larger
// than `smem`) is refused with cudaErrorInvalidValue.
extern "C" int srnn_vpu_tail(const float* logits, const float* gum,
                             int use_prng, uint64_t seed, float temperature,
                             int n_frames, void* ring, int32_t* out, int b,
                             int q, int f1, int producers, int steps,
                             int slots, int smem, void* stream) {
  if (q % 128 || f1 < 1 || f1 > 32 || producers < 1 ||
      vpu_warps(producers) > MAX_WARPS || steps < 1 || f1 % steps ||
      slots < producers ||
      smem < static_cast<int64_t>(slots) * steps * q * 4 + 16 * slots)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g_vpu_trace
             ? dispatch_vpu<true>(q, logits, gum, use_prng, seed,
                                  temperature, n_frames, ring, out, b, f1,
                                  producers, steps, slots, smem, s)
             : dispatch_vpu<false>(q, logits, gum, use_prng, seed,
                                   temperature, n_frames, ring, out, b, f1,
                                   producers, steps, slots, smem, s);
}

// The trace buffer of the next launches of K8 (nullptr: untraced):
// TRACE_FRAMES * TRACE_PER + 4 int64.
extern "C" void srnn_vpu_tail_trace(void* buf) {
  g_vpu_trace = static_cast<unsigned long long*>(buf);
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
