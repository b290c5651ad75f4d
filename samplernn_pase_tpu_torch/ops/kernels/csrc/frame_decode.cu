// K1 frame_decode: one bottom frame of autoregressive sample decode.
//
// Replaces the inner loop of samplernn_pase_tpu/ops/pallas/decode.py
// (_kernel, _tier_frame_kernel's MLP steps) and ops/pallas/megagen.py
// (_kernel: mlp_step and the on-core Gumbel draw).  For every lane and
// each of the f1 steps i of the frame:
//   x      = sum_j W'[j, win[j]] + b_in          (fused embedding, below)
//   h1     = relu(x + (cond[i] + b_up[i]))       -> rounded to weight type
//   h2     = relu(h1 @ W_h + b_h)                -> rounded to weight type
//   logits = h2 @ W_out + b_out
//   sample = argmax(logits + T * g)  (T == 0: argmax(logits), g never read)
// then the window rolls by one sample.
//
// Fused embedding: W'[j] = embed @ W_in[j*E:(j+1)*E] ([f1*q, H], built
// once per call by the caller with gemm_bias), so the first layer is a
// sum of f1 gathered rows instead of a [B, f1*E] @ [f1*E, H] product: the
// megakernel's bf16 form.  Rows are summed in order j = 0 .. f1-1 in
// float32, the same order as the plain version.
//
// Noise: noise_mode 0 = greedy, 1 = a supplied [f1, B, q] float32 Gumbel
// block, 2 = in-kernel Philox4x32-10 keyed by `seed` and counted by
// (level / 4, position low, position high, lane), word level % 4; its
// bits go through the megakernel's transform (23-bit mask, * 2^-23,
// + 1e-7, -log(-log u)), with u clamped to 1 - 2^-24 so that the largest
// word gives finite noise, not +inf.  Keyed by absolute position, the
// stream does not depend on how a generation is chunked.  3 = per-lane
// keys, the counterpart of the megakernel's host-noise mode under the
// reference's lane_keys (megagen.py:139-166, :397-415): lane b draws with
// key lane_keys[b] and counter (level / 4, position low, position high,
// 0), so its noise depends on its key and positions only, not on its
// index in the batch.  Step i of lane b is at position
// pos0 + i (+ lane_pos[b] when given) in modes 2 and 3.  In mode 2 the
// seed is read from seed_ptr (device memory) when that is not null, so a
// captured CUDA graph can take a new seed at each replay.
//
// Bound on the H100: per step the batch needs the rows of W' it gathers,
// W_h and W_out (2.6 MB in bf16 at dim 1024) and 0.34 GFLOP, ~0.4 us at
// the tensor-core rate; the f1 steps are a serial chain, so the time is
// the chain's latency.  Two kernels, chosen by decode.frame_plan (never
// by the batch):
//
// * the tensor-core kernel (bf16 weights at dim 1024, q 256: every preset
//   that generates; below, namespace tcd): mma.sync products, weights by
//   TMA through a ring, the activations exchanged by bulk copies
//   completed on the receivers' mbarriers, the next step's gathers and
//   noise off the chain;
// * the CUDA-core kernel (float32, and every other bf16 width): each tile of LT lanes is one thread-block cluster of CL
//   blocks, block r owns columns [r*H/CL, (r+1)*H/CL) of both hidden
//   layers and [r*q/CL, (r+1)*q/CL) of the logits, streams its slice of
//   W_h and W_out from L2 at every step, multiplies with float32 FMAs on
//   16-byte weight loads and pushes its slice of each activation into
//   the other blocks' shared memory, with a cluster barrier after each
//   layer and after the per-block argmax partials.  Needs dim and
//   q % (8 * CL) == 0.  At B=128 that is 16 clusters of 8, one more
//   than the card holds at once: two waves (scripts/frame_trace.py).
//
// Both kernels run griddepcontrol.launch_dependents once their cluster is
// up: the GRU tiers' next recurrent products (megagen._frames), launched
// after K1 as programmatic dependents, then take the SMs K1 leaves idle
// (64 of 132 at B=128) and never the ones K1 needs.  They read nothing K1
// writes, so they never wait on its grid.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "philox.cuh"
#include "sm90.cuh"

namespace {

constexpr int CL = 8;         // blocks per cluster, each owning 1/CL of the columns
constexpr int LT = 8;         // lanes per cluster
constexpr int THREADS = 256;  // >= 32 * LT: one warp per lane for argmax

// Phase trace (scripts/frame_trace.py): with a buffer set by
// srnn_frame_decode_trace, thread 0 of block 0 writes clock64() at point p
// of step s < TRACE_STEPS to trace[s * 16 + p].  CUDA-core kernel: 0 step
// start, 1 layer 1 done, 2 h1 pushed and the cluster barrier passed, 3
// layer 2's products done, 4 its K-split sum done, 5 h2 pushed and the
// barrier passed, 10 layer 3's products done, 6 its sum done, 7 noise
// added, 8 the argmax partials pushed and the barrier passed, 9 the
// window rolled.  Tensor-core kernel: 0 step start, 1 the h1 slice sent,
// 11 the next cond row issued, 12 the next rows issued, 2 h1 whole, 3 its
// warp's layer-2 products done (K-half 0, 32 columns), 4 h2 slice sent
// (after every warp's products, the K-halves' sum, bias, relu), 5 h2
// whole, 10 its warp's layer-3 products done, 6 its partial sent, 13 the
// next step's row sums done, 7 the leader's argmax partial sent, 8 every
// partial here, 9 the sample taken; 14 and 15 the cycles thread 0 spent
// waiting for weight boxes in layers 2 and 3.
// At trace[TRACE_STEPS * 16 + 0..3]: clock64 and %globaltimer at block 0's
// entry and exit; at + 4 + 2 * block, + 5 + 2 * block: %globaltimer at
// each block's entry and exit (how many waves the grid ran in).
constexpr int TRACE_STEPS = 16;
unsigned long long* g_trace = nullptr;   // host side: the next launches'

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}
__device__ __forceinline__ void trace_at(unsigned long long* tr, int s,
                                         int p) {
  if (tr != nullptr && blockIdx.x == 0 && threadIdx.x == 0 &&
      s < TRACE_STEPS)
    tr[s * 16 + p] = clock64();
}
// entry (end = 0) or exit (end = 1) of every block
__device__ __forceinline__ void trace_block(unsigned long long* tr,
                                            int end) {
  if (tr == nullptr || threadIdx.x != 0) return;
  const unsigned long long ns = globaltimer();
  if (blockIdx.x == 0) {
    tr[TRACE_STEPS * 16 + 2 * end] = clock64();
    tr[TRACE_STEPS * 16 + 2 * end + 1] = ns;
  }
  tr[TRACE_STEPS * 16 + 4 + 2 * blockIdx.x + end] = ns;
}

// 16-byte weight vectors: 4 float32 or 8 bf16 columns per load.
template <typename WT>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
};

// Threads that share one column vector split K this many ways (so a
// 1024-wide layer keeps all the threads busy); host and device agree.
__host__ __device__ inline int ksplit(int groups) {
  return groups >= THREADS ? 1 : THREADS / groups;
}

// out[l][n] = act(in[l] @ w[:, n] + bias[n]) for the block's LT lanes and
// its ndim columns; `in` ([LT][kdim]) and `out` ([LT][ndim]) live in shared
// memory, w points at the block's first column of a row-major matrix with
// leading dimension ldw (ndim, ldw and the offset % Vec::N == 0).  Each
// thread owns one 16-byte column vector and one K slice: loads are 16
// bytes wide and eight k rows are in flight at a time.  Slices are summed
// in slice order through `red`.
template <typename WT, bool RELU_ROUND>
__device__ void dense(const float* in, const WT* __restrict__ w, int ldw,
                      const float* __restrict__ bias, float* out, float* red,
                      int kdim, int ndim, unsigned long long* tr, int step,
                      int point) {
  constexpr int V = Vec<WT>::N;
  const int groups = ndim / V;
  const int ks = ksplit(groups);
  const int chunk = ((kdim + ks - 1) / ks + 7) & ~7;
  for (int item = threadIdx.x; item < groups * ks; item += THREADS) {
    const int g = item % groups, s = item / groups;
    const int k0 = min(kdim, s * chunk), k1 = min(kdim, k0 + chunk);
    const WT* wp = w + static_cast<int64_t>(g) * V;
    float acc[LT][V] = {};
    int k = k0;
    for (; k + 8 <= k1; k += 8) {
      float wv[8][V];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        Vec<WT>::load(wp + static_cast<int64_t>(k + u) * ldw, wv[u]);
#pragma unroll
      for (int l = 0; l < LT; ++l) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 a =
              *reinterpret_cast<const float4*>(in + l * kdim + k + 4 * h);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[l][v] = fmaf(av[u], wv[4 * h + u][v], acc[l][v]);
        }
      }
    }
    for (; k < k1; ++k) {
      float wv[V];
      Vec<WT>::load(wp + static_cast<int64_t>(k) * ldw, wv);
#pragma unroll
      for (int l = 0; l < LT; ++l)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[l][v] = fmaf(in[l * kdim + k], wv[v], acc[l][v]);
    }
#pragma unroll
    for (int l = 0; l < LT; ++l)
#pragma unroll
      for (int v = 0; v < V; ++v)
        red[(s * LT + l) * ndim + g * V + v] = acc[l][v];
  }
  __syncthreads();
  trace_at(tr, step, point);
  for (int e = threadIdx.x; e < LT * ndim; e += THREADS) {
    const int n = e % ndim;
    float v = 0.f;
    for (int s = 0; s < ks; ++s) v += red[s * LT * ndim + e];
    v = v + bias[n];
    if (RELU_ROUND) v = srnn::round_to<WT>(fmaxf(v, 0.f));
    out[e] = v;
  }
}

// Copy this block's [LT][ncols] slice into columns [c0, c0+ncols) of the
// [LT][ld] array `dst` in every block of the cluster (itself included).
__device__ void push_slice(cooperative_groups::cluster_group& cluster,
                           const float* slice, float* dst, int ld, int c0,
                           int ncols) {
  const int n4 = ncols / 4;
  for (int e = threadIdx.x; e < LT * n4; e += THREADS) {
    const int l = e / n4, c = (e % n4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(slice + l * ncols + c);
    for (int r = 0; r < CL; ++r)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, r) + l * ld +
                                 c0 + c) = v;
  }
}

// floats of the K-slice partial sums the two dense layers need
__host__ __device__ inline int red_floats(int hc, int qc, int v) {
  const int a = ksplit(hc / v) * LT * hc, c = ksplit(qc / v) * LT * qc;
  return a > c ? a : c;
}

// shared memory floats: h1, h2 (full width), red, the layer slice, the
// argmax partials (values, indices) and the window
__host__ __device__ inline int smem_floats(int hdim, int q, int f1, int v) {
  const int hc = hdim / CL, qc = q / CL;
  return 2 * LT * hdim + red_floats(hc, qc, v) + LT * (hc > qc ? hc : qc) +
         2 * CL * LT + LT * f1;
}

template <typename WT>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
frame_decode_kernel(
    const int32_t* __restrict__ window, int64_t ldw,
    const float* __restrict__ cond, int64_t ldc,
    const float* __restrict__ bup, const WT* __restrict__ w_fused,
    const float* __restrict__ b_in, const WT* __restrict__ w_h,
    const float* __restrict__ b_h, const WT* __restrict__ w_out,
    const float* __restrict__ b_out, const float* __restrict__ noise,
    int noise_mode, float temperature, uint64_t seed,
    const uint64_t* __restrict__ seed_ptr, int64_t pos0,
    const uint32_t* __restrict__ lane_keys,
    const int64_t* __restrict__ lane_pos, int32_t* __restrict__ out,
    int64_t ldo, int b, int f1, int hdim, int q,
    unsigned long long* __restrict__ tr) {
  trace_block(tr, 0);
  if (seed_ptr) seed = *seed_ptr;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int V = Vec<WT>::N;
  const int rank = static_cast<int>(cluster.block_rank());
  const int hc = hdim / CL, qc = q / CL;       // columns this block owns
  const int ch = rank * hc, cq = rank * qc;
  extern __shared__ float4 smem4[];
  float* h1 = reinterpret_cast<float*>(smem4);   // [LT][hdim], all columns
  float* h2 = h1 + LT * hdim;                    // [LT][hdim], all columns
  float* red = h2 + LT * hdim;                   // K-slice partials
  float* slice = red + red_floats(hc, qc, V);    // [LT][hc] or [LT][qc]
  float* pval = slice + LT * (hc > qc ? hc : qc);  // [CL][LT] argmax values
  int* pidx = reinterpret_cast<int*>(pval + CL * LT);  // [CL][LT] levels
  int* win = pidx + CL * LT;                     // [LT][f1]
  const int tid = threadIdx.x;
  const int lane0 = (blockIdx.x / CL) * LT;

  for (int e = tid; e < LT * f1; e += THREADS) {
    const int lane = min(lane0 + e / f1, b - 1);
    win[e] = window[lane * ldw + e % f1];
  }
  cluster.sync();  // every block of the cluster runs before any DSMEM access
  srnn::sm90::launch_dependents();   // resident: a programmatic dependent
                                     // may start

  for (int i = 0; i < f1; ++i) {
    trace_at(tr, i, 0);
    // layer 1 (own columns): gathered rows of W', + b_in, + the cond row
    for (int item = tid; item < LT * (hc / V); item += THREADS) {
      const int l = item / (hc / V), c0 = (item % (hc / V)) * V;
      const int lane = min(lane0 + l, b - 1);
      const int* wrow = win + l * f1;
      float x[V] = {};
#pragma unroll 4
      for (int j = 0; j < f1; ++j) {
        float r[V];
        Vec<WT>::load(w_fused + (static_cast<int64_t>(j) * q + wrow[j]) *
                                    hdim + ch + c0, r);
#pragma unroll
        for (int v = 0; v < V; ++v) x[v] += r[v];
      }
      const float* crow = cond + lane * ldc + static_cast<int64_t>(i) * hdim;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int n = ch + c0 + v;
        float c = crow[n];
        if (bup) c = c + bup[static_cast<int64_t>(i) * hdim + n];
        slice[l * hc + c0 + v] =
            srnn::round_to<WT>(fmaxf((x[v] + b_in[n]) + c, 0.f));
      }
    }
    __syncthreads();
    trace_at(tr, i, 1);
    push_slice(cluster, slice, h1, hdim, ch, hc);
    cluster.sync();
    trace_at(tr, i, 2);
    // layer 2 (own columns) from all of h1
    dense<WT, true>(h1, w_h + ch, hdim, b_h + ch, slice, red, hdim, hc, tr,
                    i, 3);
    __syncthreads();
    trace_at(tr, i, 4);
    push_slice(cluster, slice, h2, hdim, ch, hc);
    cluster.sync();
    trace_at(tr, i, 5);
    // layer 3 (own logits) from all of h2, plus noise
    dense<WT, false>(h2, w_out + cq, q, b_out + cq, slice, red, hdim, qc, tr,
                     i, 10);
    __syncthreads();
    trace_at(tr, i, 6);
    if (noise_mode) {
      for (int e = tid; e < LT * qc; e += THREADS) {
        const int l = e / qc, n = cq + e % qc;
        const int lane = min(lane0 + l, b - 1);
        float g;
        if (noise_mode == 1) {
          g = noise[(static_cast<int64_t>(i) * b + lane) * q + n];
        } else {
          const int64_t p = pos0 + i + (lane_pos ? lane_pos[lane] : 0);
          g = noise_mode == 3
                  ? srnn::philox_gumbel(
                        make_uint2(lane_keys[2 * lane],
                                   lane_keys[2 * lane + 1]),
                        0u, p, n)
                  : srnn::philox_gumbel(
                        make_uint2(static_cast<uint32_t>(seed),
                                   static_cast<uint32_t>(seed >> 32)),
                        static_cast<uint32_t>(lane), p, n);
        }
        slice[e] = slice[e] + temperature * g;
      }
      __syncthreads();
    }
    trace_at(tr, i, 7);
    // argmax over own levels per lane (one warp each), ties to the lowest
    // level; the partial goes to every block
    const int warp = tid / 32, wl = tid % 32;
    if (warp < LT) {
      float best = -INFINITY;
      int arg = cq + wl;
      for (int n = wl; n < qc; n += 32) {
        const float v = slice[warp * qc + n];
        if (v > best) {
          best = v;
          arg = cq + n;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oa = __shfl_down_sync(0xffffffffu, arg, off);
        if (ov > best || (ov == best && oa < arg)) {
          best = ov;
          arg = oa;
        }
      }
      best = __shfl_sync(0xffffffffu, best, 0);
      arg = __shfl_sync(0xffffffffu, arg, 0);
      if (wl < CL) {   // lane r writes the partial into block r
        cluster.map_shared_rank(pval, wl)[rank * LT + warp] = best;
        cluster.map_shared_rank(pidx, wl)[rank * LT + warp] = arg;
      }
    }
    cluster.sync();
    trace_at(tr, i, 8);
    // every block reduces the CL partials in rank (= level) order, so all
    // blocks pick the same sample
    if (tid < LT) {
      float best = pval[tid];
      int arg = pidx[tid];
      for (int r = 1; r < CL; ++r) {
        const float v = pval[r * LT + tid];
        if (v > best) {
          best = v;
          arg = pidx[r * LT + tid];
        }
      }
      int* wrow = win + tid * f1;
      for (int j = 0; j + 1 < f1; ++j) wrow[j] = wrow[j + 1];
      wrow[f1 - 1] = arg;
      if (rank == 0 && lane0 + tid < b) out[(lane0 + tid) * ldo + i] = arg;
    }
    __syncthreads();
    trace_at(tr, i, 9);
  }
  cluster.sync();  // no block leaves while its shared memory may be read
  trace_block(tr, 1);
}

template <typename WT>
int launch(const int32_t* window, int64_t ldw, const float* cond,
           int64_t ldc, const float* bup, const void* w_fused,
           const float* b_in, const void* w_h, const float* b_h,
           const void* w_out, const float* b_out, const float* noise,
           int noise_mode, float temperature, uint64_t seed,
           const uint64_t* seed_ptr, int64_t pos0, const uint32_t* lane_keys,
           const int64_t* lane_pos, int32_t* out, int64_t ldo, int b, int f1,
           int hdim, int q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(hdim, q, f1, Vec<WT>::N);
  cudaError_t err = cudaFuncSetAttribute(
      frame_decode_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = CL * ((b + LT - 1) / LT);
  frame_decode_kernel<WT><<<blocks, THREADS, smem, stream>>>(
      window, ldw, cond, ldc, bup, static_cast<const WT*>(w_fused), b_in,
      static_cast<const WT*>(w_h), b_h, static_cast<const WT*>(w_out), b_out,
      noise, noise_mode, temperature, seed, seed_ptr, pos0, lane_keys,
      lane_pos, out, ldo, b, f1, hdim, q, g_trace);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------
// The tensor-core kernel (bf16).
//
// Built for one shape, dim 1024 (H = CL * HC): a tile of LT = 16 lanes is
// one cluster of CL = 8 blocks; block r owns HC = 128 columns of W_h
// (layer 2) and one 64-column tile t = r / split of W_out over K-slice
// s = r % split (layer 3), so each weight is read by one block of the
// cluster.  The products are warp-level mma.sync m16n8k16 (bf16 in,
// float32 accumulation): the tile's 16 lanes are M, the block's weight
// columns N.  Their fragments come from shared memory by ldmatrix: the
// lanes' (A) from h1 or h2, K-major panels, and the weights' (B) with
// .trans from the boxes as TMA lands them (K-rows, swizzled), so each
// weight byte is read from shared memory once a step and each lane
// fragment serves every column its warp owns.  (scripts/k1_products.cu
// times the product of resident boxes in this form, in SS and RS wgmma
// at N = 16, against the shared-memory floor; here SS wgmma took about
// 64 SM clocks an instruction, 3x its time alone.)  h1 and h2 are bf16
// by the kernel's definition, so only the order of the float32 sums
// differs from the CUDA-core kernel.  Layer 2: warp w of the consumers
// sums K-half w / 4 (its warpgroup's) for 32 columns of 64-column tile
// (w % 4) / 2; the two halves' sums meet in xsum, warpgroup 0 finishing
// lanes 0-7, warpgroup 1 lanes 8-15.  Layer 3:
// warpgroup w takes half of the block's K-slice, each warp 16 of the 64
// columns, and its partial reaches the tile's leader (s = 0) as partial
// 2s + w, summed there in that order.  The plan (decode.frame_plan)
// never reads B, so a lane's samples do not depend on the batch.
//
// Weights: a producer warp streams the step's boxes (128 rows x 64
// columns, 128-byte swizzle) through a ring of `stages` slots in the
// order the warps consume them (layer 2's in box_order: the groups'
// boxes interleaved, the box before each in its slot the same group's;
// full and empty mbarriers per slot, the empty one freed by every thread
// that read the box; lane l owns slot l, so copies wait only for their
// own slot), across
// steps and tiles, so the next step's first boxes land while a block
// waits at an exchange.  A copy costs its issuing thread about as much
// whatever its size (PERF.md), so boxes are 16 KB.
//
// Exchanges: each block writes its h1 slice (layer 1) and h2 slice
// (layer 2) into its own shared memory and copies the panels into every
// other block of the cluster (cp.async.bulk, completed on the receiver's
// mbarrier, bytes expected per step); layer-3 partials go to the leader
// the same way, and a leader's argmax partials to every block with
// st.async.  Nothing waits on a cluster barrier inside the loop.  A
// buffer is rewritten only after its reader's use of the step before is
// implied by the data the writer has itself received (h1 of step i+1
// follows every argmax partial of step i, which follows every layer-3
// partial, which follows every h2 slice, which follows every block's
// layer 2), so one buffer per exchange is enough; the layer-3 partials
// land in h1's space, free between layer 2 and the next h1.
//
// Off the chain: layer 1 sums its f1 rows in order j = 0 .. f1-1 and only
// row f1-1 depends on the sample just drawn, so the next step's sum of
// rows 0 .. f1-2 and its cond + b_up row are loaded while this step runs
// (issued before the products, summed after them); a noise warp draws
// the leader's Gumbel noise up to two steps ahead.  The step's chain is
// the newest row, the two products and four exchanges.  Lanes past B in
// the last tile repeat lane B-1 and write nothing.  The clusters launched
// never exceed those the card holds at once
// (cudaOccupancyMaxActiveClusters); each walks tiles c, c + clusters, ...

namespace tcd {

using namespace srnn::sm90;

constexpr int CL = 8;                          // blocks per cluster
constexpr int LT = 16;                         // lanes per tile
constexpr int HC = 128;                        // W_h columns per block
constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int TC_THREADS = CONSUMERS + 64;     // the producer and noise warps
constexpr int BR = 128;                        // weight rows per box
constexpr int BOXB = BR * 64 * 2;              // one box of 64 columns, bytes
constexpr int NBOX2 = CL * HC / BR * (HC / 64);  // layer 2's boxes a step
constexpr int GBOX = NBOX2 / 4;   // of them a group (K-half, tile) reads
constexpr int MIN_STAGES = 8;                  // ring slots (box_order)
constexpr int MAX_STAGES = 24;   // static shared memory: 512 bytes
constexpr int SMEM_MAX = 231936;               // dynamic, bytes

struct Params {
  const int32_t* window;
  int64_t ldw;
  const float* cond;
  int64_t ldc;
  const float* bup;
  const __nv_bfloat16* w_fused;
  const float* b_in;
  const float* b_h;
  const float* b_out;
  const float* noise;
  int noise_mode;
  float temperature;
  uint64_t seed;
  const uint64_t* seed_ptr;   // mode 2's seed in device memory, or null
  int64_t pos0;
  const uint32_t* lane_keys;
  const int64_t* lane_pos;
  int32_t* out;
  int64_t ldo;
  int b, f1, hdim, q;
  int split, stages, tiles;
  unsigned long long* trace;
};

// Layer 2's boxes of a step in ring order, for a ring of S slots:
// box_of[x] = GBOX g + r, the r-th box (in K order) of group g = 2 K-half +
// tile, read by the group's two warps.  A warp waits for its box x by the
// parity of the slot's full barrier, which names box x only if the
// slot's box before, x - S, has landed; it has if the same warps read it.
// So every base b < S (boxes b, b + S, ... of the step) goes to one
// group, the next in turn with room for them all; boxes of an earlier
// step or of layer 2 (for layer 3's) were read before the warps began.
// False where no group has room (some rings of fewer than 8 slots).
__host__ __device__ inline bool box_order(int S, uint8_t* box_of) {
  int count[4] = {0, 0, 0, 0}, base[NBOX2];
  int next = 0;
  for (int b = 0; b < S && b < NBOX2; ++b) {
    const int m = (NBOX2 - 1 - b) / S + 1;   // boxes of base b
    int k = 0;
    while (k < 4 && count[(next + k) % 4] + m > GBOX) ++k;
    if (k == 4) return false;
    base[b] = (next + k) % 4;
    count[base[b]] += m;
    next = (base[b] + 1) % 4;
  }
  int r[4] = {0, 0, 0, 0};
  for (int x = 0; x < NBOX2; ++x) {
    const int g = base[x % S];
    box_of[x] = static_cast<uint8_t>(GBOX * g + r[g]++);
  }
  return true;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// 8 bytes into (remote) shared memory, completed on the receiver's
// mbarrier `bar` (both shared::cluster addresses)
__device__ __forceinline__ void st_async8(uint32_t addr, uint32_t x,
                                          uint32_t y, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0], {%1, %2}, [%3];"
      :: "r"(addr), "r"(x), "r"(y), "r"(bar) : "memory");
}
// `bytes` (a multiple of 16) of this block's shared memory at `src` into
// (another) block's at `dst`, completed on that block's mbarrier `bar`
__device__ __forceinline__ void bulk_to(uint32_t dst, uint32_t src,
                                        int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}
// A wait that has not ended after about 10 s (2e10 cycles) traps: the
// launch fails with an error instead of holding the card.
constexpr long long WAIT_LIMIT = 20000000000LL;

// wait for a phase of a local mbarrier: `cluster` where its bytes came
// from other blocks of the cluster (acquire at cluster scope)
template <bool CLUSTER>
__device__ __forceinline__ void wait_phase(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    if (CLUSTER)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}
// `n` arrivals on a local mbarrier
__device__ __forceinline__ void arrive_n(uint64_t* bar, int n) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(n) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}
// byte offset of (row n, column k) in a K-major [rows][K] bf16 operand of
// `rows` rows kept as 64-column panels with the 128-byte swizzle
__device__ __forceinline__ int kmajor(int rows, int n, int k) {
  return (k / 64) * rows * 128 + n * 128 + ((((k % 64) / 8) ^ (n % 8)) * 16) +
         (k % 8) * 2;
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// TRACE: the instantiation launched while a trace buffer is set (the
// phase points and the box-wait clocks); the other has none of them.
template <bool TRACE>
__global__ void __launch_bounds__(TC_THREADS, 1)
frame_decode_tc_kernel(const __grid_constant__ Params p,
                const __grid_constant__ CUtensorMap wh_map,
                const __grid_constant__ CUtensorMap wo_map) {
  constexpr int MT = HC / 64;                   // layer-2 tiles of 64
  constexpr int ITEMS = LT * HC / 8;            // layer-1 items of 8 columns
  constexpr int TPL = CONSUMERS / LT;           // leader threads per lane
  constexpr int NPT = 64 / TPL;                 // logit columns per thread
  static_assert(MT == 2 && CONSUMERS == 256, "layer 2: warp w takes K-half "
                "w / 4 and 32 columns of tile (w % 4) / 2");
  static_assert(TPL <= 32 && NPT % 4 == 0, "a lane's logits in one warp, "
                "four levels per Philox block");
  static_assert(ITEMS <= CONSUMERS, "one layer-1 item per thread");
  static_assert(CONSUMERS / 32 >= CL - 1, "one h2 copy a consumer warp");

  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t bars[4];     // h1, h2, partials, argmax
  __shared__ __align__(8) uint64_t gfull[2], gfree[2];   // noise buffers
  __shared__ uint8_t box_of[NBOX2], pos_of[NBOX2];       // box_order
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int H = p.hdim, Q = p.q, F1 = p.f1, S = p.stages;
  const int T = Q / 64;
  uint8_t* ring = smem;
  uint8_t* h1 = ring + S * BOXB;
  uint8_t* h2 = h1 + LT * H * 2;
  uint2* argp = reinterpret_cast<uint2*>(h2 + LT * H * 2);   // [T][LT]
  float* gbuf = reinterpret_cast<float*>(argp + T * LT);    // [2][LT][64]
  // layer 2's K-half sums: [warp][2][32 threads] float4
  float4* xsum = reinterpret_cast<float4*>(gbuf + 2 * LT * 64);
  int16_t* win = reinterpret_cast<int16_t*>(xsum + 2 * CONSUMERS);  // [LT][F1]
  float* part = reinterpret_cast<float*>(h1);   // [2 split][LT][64]

  const int tid = threadIdx.x;
  // warp-uniform as far as the compiler can see (the products' ldmatrix
  // and mma.sync are .aligned: every lane of a warp runs them together)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), wg = warp / 4;
  const int rank = static_cast<int>(cluster_rank());
  const int tq = rank / p.split, sq = rank % p.split;
  const bool leader = sq == 0;
  const int ch = rank * HC;
  const int rows3 = H / p.split;
  const int nbox3 = rows3 / BR;
  const int nbox = NBOX2 + nbox3;
  const int cid = blockIdx.x / CL, nclusters = gridDim.x / CL;
  const int my_tiles = (p.tiles - cid + nclusters - 1) / nclusters;
  unsigned long long* tr = TRACE ? p.trace : nullptr;
  const bool tracing = tr != nullptr && blockIdx.x == 0 && tid == 0;
  if (tr != nullptr && tid == 0) {
    const unsigned long long ns = globaltimer();
    if (blockIdx.x == 0) {
      tr[TRACE_STEPS * 16] = clock64();
      tr[TRACE_STEPS * 16 + 1] = ns;
    }
    tr[TRACE_STEPS * 16 + 4 + 2 * blockIdx.x] = ns;
  }

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      // every thread that reads the box: 4 each of two warps (layer 2),
      // 2 each of four (layer 3)
      mbar_init(&empty[s], 256);
    }
    for (int s = 0; s < 4; ++s) mbar_init(&bars[s], 1);
    box_order(S, box_of);   // the launcher checked that it exists
    for (int x = 0; x < NBOX2; ++x)
      pos_of[box_of[x]] = static_cast<uint8_t>(x);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&gfull[s], 32);          // the noise warp's lanes
      mbar_init(&gfree[s], CONSUMERS);   // the leader's consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();   // every block's mbarriers exist before any store
  cluster_wait();
  launch_dependents();   // resident: a programmatic dependent may start

  if (warp == CONSUMERS / 32) {
    // ---- producer: the boxes of every step, in consumption order; lane
    // l < S owns slot l and issues its boxes l, l + S, ...: a copy waits
    // only for its own slot, one fill at a time ----
    const int64_t total = static_cast<int64_t>(my_tiles) * F1 * nbox;
    const int lane = tid % 32;
    for (int64_t c = lane; lane < S && c < total; c += S) {
      const int slot = static_cast<int>(c % S);
      if (c >= S)
        wait_phase<false>(&empty[slot], static_cast<int>((c / S - 1) & 1));
      const int j = static_cast<int>(c % nbox);
      mbar_expect_tx(&full[slot], BOXB);
      if (j < NBOX2) {   // box r of group g = 2 K-half + tile
        const int g = box_of[j] / GBOX, r = box_of[j] % GBOX;
        tma_box(ring + slot * BOXB, &wh_map, ch + 64 * (g % MT),
                BR * (g / MT * GBOX + r), &full[slot]);
      } else {
        tma_box(ring + slot * BOXB, &wo_map, 64 * tq,
                sq * rows3 + BR * (j - NBOX2), &full[slot]);
      }
    }
    __syncwarp();
    cluster_arrive();   // no block leaves while its shared memory may be
    cluster_wait();     // written
    return;
  }
  if (warp == CONSUMERS / 32 + 1) {
    // ---- noise warp (leaders): the Gumbel noise of the leader's 64
    // levels for every lane of the tile, up to two steps ahead, into
    // gbuf[step % 2] ----
    if (leader && p.noise_mode) {
      const int lane = tid % 32;
      const uint64_t seed = p.seed_ptr ? *p.seed_ptr : p.seed;
      int64_t g = 0;
      for (int tile = cid; tile < p.tiles; tile += nclusters)
        for (int i = 0; i < F1; ++i, ++g) {
          const int buf = static_cast<int>(g & 1);
          if (g >= 2)
            wait_phase<false>(&gfree[buf],
                              static_cast<int>(((g >> 1) - 1) & 1));
          for (int e = lane; e < LT * 16; e += 32) {
            const int n = e / 16, lev = 64 * tq + 4 * (e % 16);
            const int ln = min(tile * LT + n, p.b - 1);
            float4 v;
            if (p.noise_mode == 1) {
              v = *reinterpret_cast<const float4*>(
                  p.noise + (static_cast<int64_t>(i) * p.b + ln) * Q + lev);
            } else {   // one Philox block: the words of levels lev .. +3
              const bool own = p.noise_mode == 3;
              const uint4 w = srnn::philox_words(
                  own ? make_uint2(p.lane_keys[2 * ln],
                                   p.lane_keys[2 * ln + 1])
                      : make_uint2(static_cast<uint32_t>(seed),
                                   static_cast<uint32_t>(seed >> 32)),
                  own ? 0u : static_cast<uint32_t>(ln),
                  p.pos0 + i + (p.lane_pos ? p.lane_pos[ln] : 0), lev >> 2);
              v = make_float4(srnn::bits_gumbel(w.x), srnn::bits_gumbel(w.y),
                              srnn::bits_gumbel(w.z), srnn::bits_gumbel(w.w));
            }
            *reinterpret_cast<float4*>(
                gbuf + (buf * LT + n) * 64 + 4 * (e % 16)) = v;
          }
          mbar_arrive(&gfull[buf]);
        }
    }
    __syncwarp();
    cluster_arrive();
    cluster_wait();
    return;
  }
  {
    // ---- consumers ----
    const int t128 = tid % 128, lane = tid % 32;
    const int fr = lane / 4, fc = lane % 4;   // mma.sync fragment row, pair
    // ldmatrix: lane t addresses row t % 8 of matrix t / 8, here row lr of
    // the 16 lanes (or of a 16-row K-step of weights) and half lh of the
    // 16 columns of K (or of weights)
    const int lr = ((lane / 8) & 1) * 8 + lane % 8, lh = lane / 16;
    const uint32_t ring_u = smem_u32(ring), h1_u = smem_u32(h1),
                   h2_u = smem_u32(h2);
    // the 16 lanes' fragment of K-step s of h1 or h2 (K-major panels)
    auto lanes_at = [&](uint32_t hb, int s) {
      return hb + (s / 4) * LT * 128 + lr * 128 +
             (((2 * (s % 4) + lh) ^ (lr % 8)) * 16);
    };
    // the transposed fragment of K-step s, columns [col, col + 16), of a
    // box (rows 128 bytes apart, swizzled)
    auto weights_at = [&](uint32_t box, int s, int col) {
      return box + (16 * s + lr) * 128 + (((col / 8 + lh) ^ (lr % 8)) * 16);
    };
    const uint32_t bars_u = smem_u32(bars);
    // exchange mbarrier k (h1, h2, partials, argmax) of block r
    auto rbar = [&](int r, int k) { return mapa(bars_u + 8 * k, r); };
    // bytes each exchange brings per step: h1 and h2 (every other
    // block's slice), the leader's partials, the argmax partials
    const uint32_t slice_bytes = (CL - 1) * LT * HC * 2;
    const uint32_t part_bytes = 2 * (p.split - 1) * 64 * LT * 4;
    const uint32_t arg_bytes = T * LT * 8;
    // per-thread constants: layer 1's b_in, layer 2's b_h, the leader's
    // b_out; a thread < ITEMS owns layer 1's columns [c0, c0 + 8) of lane
    // il of the tile
    const bool item = tid < ITEMS;
    const int il = tid / (HC / 8), c0 = ch + (tid % (HC / 8)) * 8;
    float bin[8], pre[8], cnd[8], pre_n[8] = {}, cnd_n[8] = {};
    int last = 0;
#pragma unroll
    for (int v = 0; v < 8; ++v) bin[v] = item ? p.b_in[c0 + v] : 0.f;
    // layer 2's tile and columns: col2 + 8 t + (0, 1) for t < 4
    const int mt = (warp % 4) / 2, c32 = 32 * (warp % 2);
    const int col2 = ch + 64 * mt + c32 + 2 * fc;
    float bh[4][2];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) bh[t][jj] = p.b_h[col2 + 8 * t + jj];
    const int ln = tid / TPL;     // the leader's lane and its columns
    float bo[NPT], gn[NPT];
#pragma unroll
    for (int u = 0; u < NPT; ++u) {
      bo[u] = p.b_out[64 * tq + NPT * (tid % TPL) + u];
      gn[u] = 0.f;
    }

    // Layer 1's inputs of step i other than the newest row, gathered off
    // the chain while the products of step i - 1 run: the cond + b_up row
    // and the sum of the window's rows 0 .. f1-2 (in order j = 0, 1, ..).
    // win is a ring: entry j of step i's window is slot (i + j) % f1, and
    // the sample of step i goes to slot i % f1, so the slots read here are
    // all known when step i - 1 starts.  Loads are issued a stage before
    // their sums.
    float4 ncond[2], nbup[2];
    uint4 nraw[8];
    auto issue_cond = [&](int lane0, int i) {
      if (!item) return;
      const int lane = min(lane0 + il, p.b - 1);
      const float* crow = p.cond + lane * p.ldc +
                          static_cast<int64_t>(i) * H + c0;
      ncond[0] = *reinterpret_cast<const float4*>(crow);
      ncond[1] = *reinterpret_cast<const float4*>(crow + 4);
      if (p.bup) {
        const float* brow = p.bup + static_cast<int64_t>(i) * H + c0;
        nbup[0] = *reinterpret_cast<const float4*>(brow);
        nbup[1] = *reinterpret_cast<const float4*>(brow + 4);
      }
    };
    auto take_cond = [&]() {
      if (!item) return;
      const float c[8] = {ncond[0].x, ncond[0].y, ncond[0].z, ncond[0].w,
                          ncond[1].x, ncond[1].y, ncond[1].z, ncond[1].w};
      const float u[8] = {nbup[0].x, nbup[0].y, nbup[0].z, nbup[0].w,
                          nbup[1].x, nbup[1].y, nbup[1].z, nbup[1].w};
#pragma unroll
      for (int v = 0; v < 8; ++v) cnd_n[v] = p.bup ? c[v] + u[v] : c[v];
    };
    auto issue_rows = [&](int i, int j0) {   // rows [j0, j0 + 8) of step i
      if (!item) return;
      const int16_t* wr = win + il * F1;
#pragma unroll
      for (int d = 0; d < 8; ++d)
        if (j0 + d < F1 - 1)
          nraw[d] = *reinterpret_cast<const uint4*>(
              p.w_fused +
              (static_cast<int64_t>(j0 + d) * Q + wr[(i + j0 + d) % F1]) * H +
              c0);
    };
    auto add_rows = [&](int j0) {
      if (!item) return;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        if (j0 + d >= F1 - 1) break;
        const __nv_bfloat162* h2v =
            reinterpret_cast<const __nv_bfloat162*>(&nraw[d]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2v[e]);
          pre_n[2 * e] = j0 + d == 0 ? f.x : pre_n[2 * e] + f.x;
          pre_n[2 * e + 1] = j0 + d == 0 ? f.y : pre_n[2 * e + 1] + f.y;
        }
      }
    };
    int64_t gs = 0;                // steps so far (mbarrier phases, boxes)
    for (int tile = cid; tile < p.tiles; tile += nclusters) {
      const int lane0 = tile * LT;
      named_sync(1, CONSUMERS);    // the last tile's window reads are done
      for (int e = tid; e < LT * F1; e += CONSUMERS) {
        const int lane = min(lane0 + e / F1, p.b - 1);
        win[e] = static_cast<int16_t>(p.window[lane * p.ldw + e % F1]);
      }
      named_sync(1, CONSUMERS);
      issue_cond(lane0, 0);
      for (int j0 = 0; j0 < F1 - 1; j0 += 8) {
        issue_rows(0, j0);
        add_rows(j0);
      }
      take_cond();
#pragma unroll
      for (int v = 0; v < 8; ++v) pre[v] = pre_n[v], cnd[v] = cnd_n[v];
      if (item) last = win[il * F1 + F1 - 1];

      for (int i = 0; i < F1; ++i, ++gs) {
        const int par = static_cast<int>(gs & 1);
        const bool more = i + 1 < F1;
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 0] = clock64();
        if (tid == 0) {
          mbar_expect_tx(&bars[0], slice_bytes);
          mbar_expect_tx(&bars[1], slice_bytes);
          if (leader) mbar_expect_tx(&bars[2], part_bytes);
          mbar_expect_tx(&bars[3], arg_bytes);
        }
        // ---- layer 1: the newest row, b_in, cond + b_up -> h1 slice ----
        if (item) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              p.w_fused + (static_cast<int64_t>(F1 - 1) * Q + last) * H +
              c0);
          const __nv_bfloat162* h2v =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          float hv[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2v[e]);
            const float xa = F1 > 1 ? pre[2 * e] + f.x : f.x;
            const float xb = F1 > 1 ? pre[2 * e + 1] + f.y : f.y;
            hv[2 * e] = fmaxf((xa + bin[2 * e]) + cnd[2 * e], 0.f);
            hv[2 * e + 1] =
                fmaxf((xb + bin[2 * e + 1]) + cnd[2 * e + 1], 0.f);
          }
          const uint4 pk = make_uint4(pack_bf16(hv[0], hv[1]),
                                      pack_bf16(hv[2], hv[3]),
                                      pack_bf16(hv[4], hv[5]),
                                      pack_bf16(hv[6], hv[7]));
          *reinterpret_cast<uint4*>(h1 + kmajor(LT, il, c0)) = pk;
        }
        fence_proxy_async();        // the slice, to the bulk copies
        named_sync(1, CONSUMERS);
        if (tid == 0) {             // its panels into the other blocks
          const uint32_t off = (ch / 64) * LT * 128;
#pragma unroll
          for (int r = 0; r < CL; ++r)
            if (r != rank)
              bulk_to(mapa(h1_u + off, r), h1_u + off, LT * HC * 2,
                      rbar(r, 0));
        }
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 1] = clock64();
        // off the chain: the next step's loads
        if (more) issue_cond(lane0, i + 1);
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 11] = clock64();
        if (more) issue_rows(i + 1, 0);
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 12] = clock64();
        wait_phase<true>(&bars[0], par);
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 2] = clock64();

        // ---- layer 2: h2 = relu(h1 @ W_h + b_h), own columns; warp w
        // sums K-half wg over 32 columns of tile mt ----
        long long waited = 0;      // cycles spent waiting for weight boxes
        {
          float acc[4][4];         // [8-column group][mma.sync D]
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
          for (int r = 0; r < GBOX; ++r) {
            const int kt = wg * GBOX + r;
            const int64_t c = gs * nbox + pos_of[GBOX * (MT * wg + mt) + r];
            const int slot = static_cast<int>(c % S);
            const long long w0 = TRACE ? clock64() : 0;
            // the slot's box before has landed (box_order): the parity
            // names box c
            wait_phase<false>(&full[slot], static_cast<int>((c / S) & 1));
            if (TRACE) waited += clock64() - w0;
            const uint32_t box = ring_u + slot * BOXB;
#pragma unroll
            for (int s = 0; s < BR / 16; ++s) {
              uint32_t a[4], b[4];
              ldmatrix4<false>(a, lanes_at(h1_u, kt * (BR / 16) + s));
#pragma unroll
              for (int hq = 0; hq < 2; ++hq) {
                ldmatrix4<true>(b, weights_at(box, s, c32 + 16 * hq));
                mma_bf16(acc[2 * hq], a, b[0], b[1]);
                mma_bf16(acc[2 * hq + 1], a, b[2], b[3]);
              }
            }
            arrive_n(&empty[slot], 4);   // read by two warps: free it
          }
          if (tracing && i < TRACE_STEPS) {
            tr[i * 16 + 3] = clock64();
            tr[i * 16 + 14] = waited;
            waited = 0;
          }
          // the K-halves' sums meet in xsum: each warp hands the other
          // half's warp of its columns the lanes that warp finishes,
          // lanes 0-7 finishing in warpgroup 0 and 8-15 in warpgroup 1
#pragma unroll
          for (int u = 0; u < 2; ++u)   // the lanes the other warp keeps
            xsum[(2 * warp + u) * 32 + lane] = wg
                ? make_float4(acc[2 * u][0], acc[2 * u][1],
                              acc[2 * u + 1][0], acc[2 * u + 1][1])
                : make_float4(acc[2 * u][2], acc[2 * u][3],
                              acc[2 * u + 1][2], acc[2 * u + 1][3]);
          named_sync(1, CONSUMERS);
          // epilogue: the sum, bias, relu, bf16 into the own slice of h2
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float4 o = xsum[(2 * (warp ^ 4) + u) * 32 + lane];
            const float other[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
            for (int t = 2 * u; t < 2 * u + 2; ++t) {
              const float x0 = (wg ? acc[t][2] : acc[t][0]) +
                               other[2 * (t - 2 * u)];
              const float x1 = (wg ? acc[t][3] : acc[t][1]) +
                               other[2 * (t - 2 * u) + 1];
              *reinterpret_cast<uint32_t*>(
                  h2 + kmajor(LT, fr + 8 * wg, col2 + 8 * t)) =
                  pack_bf16(fmaxf(x0 + bh[t][0], 0.f),
                            fmaxf(x1 + bh[t][1], 0.f));
            }
          }
          fence_proxy_async();      // the slice, to the bulk copies
          named_sync(1, CONSUMERS);
          if (lane == 0 && warp < CL - 1) {   // into the other blocks, one
            const uint32_t off = (ch / 64) * LT * 128;   // copy a warp
            const int to = (rank + 1 + warp) % CL;
            bulk_to(mapa(h2_u + off, to), h2_u + off, LT * HC * 2,
                    rbar(to, 1));
          }
        }
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 4] = clock64();
        if (more) {
          add_rows(0);
          take_cond();
          issue_rows(i + 1, 8);
        }
        wait_phase<true>(&bars[1], par);
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 5] = clock64();

        // ---- layer 3: partial logits of the own tile and K-slice; warp
        // w sums the warpgroup's half of the slice over 16 columns ----
        {
          float acc[2][4];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
          const int half = nbox3 / 2;
          for (int kk = 0; kk < half; ++kk) {
            const int kt = wg * half + kk;
            const int64_t c = gs * nbox + NBOX2 + kt;
            const int slot = static_cast<int>(c % S);
            const long long w0 = TRACE ? clock64() : 0;
            wait_phase<false>(&full[slot], static_cast<int>((c / S) & 1));
            if (TRACE) waited += clock64() - w0;
            const uint32_t box = ring_u + slot * BOXB;
            const int s0 = (sq * rows3 + kt * BR) / 16;   // h2's K-steps
#pragma unroll
            for (int s = 0; s < BR / 16; ++s) {
              uint32_t a[4], b[4];
              ldmatrix4<false>(a, lanes_at(h2_u, s0 + s));
              ldmatrix4<true>(b, weights_at(box, s, 16 * (warp % 4)));
              mma_bf16(acc[0], a, b[0], b[1]);
              mma_bf16(acc[1], a, b[2], b[3]);
            }
            arrive_n(&empty[slot], 2);   // read by the warpgroup: free it
          }
          if (tracing && i < TRACE_STEPS) {
            tr[i * 16 + 10] = clock64();
            tr[i * 16 + 15] = waited;
          }
          // partial 2 sq + wg of [LT lanes][64 columns], written where
          // the leader keeps it (h1's space, free here), then copied to
          // the leader
          float* mine = part + (2 * sq + wg) * 64 * LT;
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(
                  mine + (fr + 8 * hh) * 64 + 16 * (warp % 4) + 8 * t +
                  2 * fc) = make_float2(acc[t][2 * hh], acc[t][2 * hh + 1]);
          fence_proxy_async();
          named_sync(2 + wg, 128);
          if (!leader && t128 == 0) {
            const int to = tq * p.split;
            const uint32_t off = smem_u32(mine) - h1_u;
            bulk_to(mapa(h1_u + off, to), h1_u + off, 64 * LT * 4,
                    rbar(to, 2));
          }
        }
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 6] = clock64();
        if (more) {
          add_rows(8);
          for (int j0 = 16; j0 < F1 - 1; j0 += 8) {
            issue_rows(i + 1, j0);
            add_rows(j0);
          }
        }
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 13] = clock64();

        // ---- the leader: sum, bias, noise, argmax of its 64 levels ----
        if (leader) {
          named_sync(1, CONSUMERS);   // both own partials written
          wait_phase<true>(&bars[2], par);
          float best = -INFINITY;
          const int mb = NPT * (tid % TPL);    // this thread's columns
          int arg = 64 * tq + mb;
          float lg[NPT];
#pragma unroll
          for (int u = 0; u < NPT; u += 4) {
            float4 v = *reinterpret_cast<const float4*>(
                part + ln * 64 + mb + u);
            for (int ps = 1; ps < 2 * p.split; ++ps) {
              const float4 w = *reinterpret_cast<const float4*>(
                  part + (ps * LT + ln) * 64 + mb + u);
              v.x += w.x;
              v.y += w.y;
              v.z += w.z;
              v.w += w.w;
            }
            lg[u] = v.x, lg[u + 1] = v.y, lg[u + 2] = v.z, lg[u + 3] = v.w;
          }
          if (p.noise_mode) {
            const int buf = static_cast<int>(gs & 1);
            wait_phase<false>(&gfull[buf], static_cast<int>((gs >> 1) & 1));
#pragma unroll
            for (int u = 0; u < NPT; u += 4) {
              const float4 g4 = *reinterpret_cast<const float4*>(
                  gbuf + (buf * LT + ln) * 64 + mb + u);
              gn[u] = g4.x, gn[u + 1] = g4.y, gn[u + 2] = g4.z,
              gn[u + 3] = g4.w;
            }
            mbar_arrive(&gfree[buf]);
          }
#pragma unroll
          for (int u = 0; u < NPT; ++u) {
            const int m = mb + u;
            float v = lg[u] + bo[u];
            if (p.noise_mode) v = v + p.temperature * gn[u];
            if (v > best) {
              best = v;
              arg = 64 * tq + m;
            }
          }
#pragma unroll
          for (int off = TPL / 2; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, best, off);
            const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
            if (ov > best || (ov == best && oa < arg)) {
              best = ov;
              arg = oa;
            }
          }
          if (tid % TPL == 0) {
            const uint32_t a = smem_u32(argp + tq * LT + ln);
#pragma unroll
            for (int r = 0; r < CL; ++r)
              st_async8(mapa(a, r), __float_as_uint(best),
                        static_cast<uint32_t>(arg), rbar(r, 3));
          }
        }
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 7] = clock64();
        wait_phase<true>(&bars[3], par);
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 8] = clock64();
        // ---- every block: the sample, in level order ----
        auto sample = [&](int l) {
          uint2 e = argp[l];
          float best = __uint_as_float(e.x);
          int arg = static_cast<int>(e.y);
          for (int t = 1; t < T; ++t) {
            e = argp[t * LT + l];
            if (__uint_as_float(e.x) > best) {
              best = __uint_as_float(e.x);
              arg = static_cast<int>(e.y);
            }
          }
          return arg;
        };
        if (item) last = sample(il);
#pragma unroll
        for (int v = 0; v < 8; ++v) pre[v] = pre_n[v], cnd[v] = cnd_n[v];
        if (tid < LT) {
          const int s = sample(tid);
          win[tid * F1 + i % F1] = static_cast<int16_t>(s);
          if (rank == 0 && lane0 + tid < p.b)
            p.out[(lane0 + tid) * p.ldo + i] = s;
        }
        if (tracing && i < TRACE_STEPS) tr[i * 16 + 9] = clock64();
      }
    }
  }
  cluster_arrive();   // no block leaves while its shared memory may be
  cluster_wait();     // written
  if (tr != nullptr && tid == 0) {
    const unsigned long long ns = globaltimer();
    if (blockIdx.x == 0) {
      tr[TRACE_STEPS * 16 + 2] = clock64();
      tr[TRACE_STEPS * 16 + 3] = ns;
    }
    tr[TRACE_STEPS * 16 + 5 + 2 * blockIdx.x] = ns;
  }
}

// dynamic shared memory of a plan (decode.py:_tc_plan mirrors it)
inline int smem_bytes(int hdim, int q, int f1, int stages) {
  return 1024 + 2 * LT * hdim * 2 + (q / 64) * LT * 8 + 2 * LT * 64 * 4 +
         CONSUMERS * 8 * 4 + (LT * f1 * 2 + 15) / 16 * 16 + stages * BOXB;
}

void config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int clusters,
            int smem, cudaStream_t stream) {
  *cfg = {};
  cfg->gridDim = dim3(CL * clusters, 1, 1);
  cfg->blockDim = dim3(TC_THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// clusters the card holds at once (cached per smem), or a negative CUDA
// error
template <bool TRACE>
int max_clusters(int smem) {
  static bool prepared = false;
  static int cached_smem = -1, cached = 0;
  if (smem == cached_smem) return cached;
  if (!prepared) {
    const cudaError_t err = cudaFuncSetAttribute(
        frame_decode_tc_kernel<TRACE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return -static_cast<int>(err);
    prepared = true;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(&cfg, &attr, 64, smem, nullptr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, frame_decode_tc_kernel<TRACE>,
                                     &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cached_smem = smem;
  cached = n;
  return n;
}

template <bool TRACE>
int launch(Params p, const void* w_h, const void* w_out,
           cudaStream_t stream) {
  const int smem = smem_bytes(p.hdim, p.q, p.f1, p.stages);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = max_clusters<TRACE>(smem);
  if (fit < 0) return -fit;
  if (fit == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap wh = {}, wo = {};
  if (!tensor_map(&wh, w_h, p.hdim, p.hdim, p.hdim,
                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, BR, true) ||
      !tensor_map(&wo, w_out, p.hdim, p.q, p.q,
                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, BR, true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(&cfg, &attr, p.tiles < fit ? p.tiles : fit, smem, stream);
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, frame_decode_tc_kernel<TRACE>, p, wh, wo));
}

}  // namespace tcd

// plan[0..4]: route (1 tensor cores, 0 fma), cluster, lanes, out_split,
// stages
// (decode.py:frame_plan, _plan_words).
int decode(const int32_t* window, int64_t ldw, const float* cond,
           int64_t ldc, const float* bup, const void* w_fused,
           const float* b_in, const void* w_h, const float* b_h,
           const void* w_out, const float* b_out, const float* noise,
           int noise_mode, float temperature, uint64_t seed,
           const uint64_t* seed_ptr, int64_t pos0, const uint32_t* lane_keys,
           const int64_t* lane_pos, int32_t* out, int64_t ldo, int b, int f1,
           int hdim, int q, int w_bf16, const int* plan, cudaStream_t s) {
  if (plan[0] == 1) {
    // the built shape; out_split <= 4: the layer-3 partials fit in h1's
    // space and each warpgroup has a box of its K-slice
    const int tiles = q / 64;
    uint8_t order[tcd::NBOX2];
    if (!w_bf16 || plan[1] != tcd::CL || plan[2] != tcd::LT ||
        hdim != tcd::CL * tcd::HC || q % 64 || tiles > tcd::CL ||
        tcd::CL % tiles || plan[3] != tcd::CL / tiles || plan[3] > 4 ||
        plan[4] < tcd::MIN_STAGES || plan[4] > tcd::MAX_STAGES ||
        !tcd::box_order(plan[4], order))
      return static_cast<int>(cudaErrorInvalidValue);
    const tcd::Params p = {window, ldw, cond, ldc, bup,
                           static_cast<const __nv_bfloat16*>(w_fused), b_in,
                           b_h, b_out, noise, noise_mode, temperature, seed,
                           seed_ptr, pos0, lane_keys, lane_pos, out, ldo, b,
                           f1, hdim, q, plan[3], plan[4],
                           (b + tcd::LT - 1) / tcd::LT, g_trace};
    return g_trace ? tcd::launch<true>(p, w_h, w_out, s)
                   : tcd::launch<false>(p, w_h, w_out, s);
  }
  if (plan[1] != CL || plan[2] != LT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_bf16)
    return launch<__nv_bfloat16>(window, ldw, cond, ldc, bup, w_fused, b_in,
                                 w_h, b_h, w_out, b_out, noise, noise_mode,
                                 temperature, seed, seed_ptr, pos0, lane_keys,
                                 lane_pos, out, ldo, b, f1, hdim, q, s);
  return launch<float>(window, ldw, cond, ldc, bup, w_fused, b_in, w_h, b_h,
                       w_out, b_out, noise, noise_mode, temperature, seed,
                       seed_ptr, pos0, lane_keys, lane_pos, out, ldo, b, f1,
                       hdim, q, s);
}

}  // namespace

// One bottom frame under a plan (route, cluster, lanes, out_split, stages),
// with mode 2's seed read from seed_ptr where that is not null.
extern "C" int srnn_frame_decode_planned(
    const int32_t* window, int64_t ldw, const float* cond, int64_t ldc,
    const float* bup, const void* w_fused, const float* b_in,
    const void* w_h, const float* b_h, const void* w_out, const float* b_out,
    const float* noise, int noise_mode, float temperature, uint64_t seed,
    const uint64_t* seed_ptr, int64_t pos0, const uint32_t* lane_keys,
    const int64_t* lane_pos, int32_t* out, int64_t ldo, int b, int f1,
    int hdim, int q, int w_bf16, const int* plan, void* stream) {
  return decode(window, ldw, cond, ldc, bup, w_fused, b_in, w_h, b_h, w_out,
                b_out, noise, noise_mode, temperature, seed, seed_ptr, pos0,
                lane_keys, lane_pos, out, ldo, b, f1, hdim, q, w_bf16, plan,
                static_cast<cudaStream_t>(stream));
}

// Clusters of the tensor-core kernel the card holds at once with `stages` ring
// slots (< 0: a CUDA error).
extern "C" int srnn_frame_clusters(int hdim, int q, int f1, int stages) {
  return tcd::max_clusters<false>(tcd::smem_bytes(hdim, q, f1, stages));
}

// Phase trace of the following launches into `buf` (int64, at least
// TRACE_STEPS * 16 + 4 + 2 * blocks entries), or off with null.
extern "C" void srnn_frame_decode_trace(void* buf) {
  g_trace = static_cast<unsigned long long*>(buf);
}
