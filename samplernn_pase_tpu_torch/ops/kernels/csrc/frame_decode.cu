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
// pos0 + i (+ lane_pos[b] when given) in modes 2 and 3.
//
// Bound on the H100: per step the batch needs the rows of W' it gathers,
// W_h and W_out (2.6 MB in bf16 at dim 1024) and 0.34 GFLOP, ~0.4 us at
// the tensor-core rate; the f1 steps are a serial chain.  Each tile of LT
// lanes is one thread-block cluster of CL blocks, and block r of a
// cluster owns columns [r*H/CL, (r+1)*H/CL) of both hidden layers and
// [r*q/CL, (r+1)*q/CL) of the logits: per step it streams only its slice
// of W_h and W_out from L2 (320 KB in bf16 at dim 1024) and pushes its
// slice of each activation into the other blocks' shared memory
// (distributed shared memory), with a cluster barrier after each layer
// and after the per-block argmax partials.  At B=128 that is 16 clusters,
// 128 blocks.  Products are float32 FMAs on 16-byte weight loads, so the
// time is bounded by the SMs' L2 reads and float32 rate, not by the
// tensor cores; tensor-core products and weights kept in shared memory
// across steps are later changes.  Needs dim and q % (8 * CL) == 0.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int CL = 8;         // blocks per cluster, each owning 1/CL of the columns
constexpr int LT = 8;         // lanes per cluster
constexpr int THREADS = 256;  // >= 32 * LT: one warp per lane for argmax

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
                      int kdim, int ndim) {
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
    int noise_mode, float temperature, uint64_t seed, int64_t pos0,
    const uint32_t* __restrict__ lane_keys,
    const int64_t* __restrict__ lane_pos, int32_t* __restrict__ out,
    int64_t ldo, int b, int f1, int hdim, int q) {
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

  for (int i = 0; i < f1; ++i) {
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
    push_slice(cluster, slice, h1, hdim, ch, hc);
    cluster.sync();
    // layer 2 (own columns) from all of h1
    dense<WT, true>(h1, w_h + ch, hdim, b_h + ch, slice, red, hdim, hc);
    __syncthreads();
    push_slice(cluster, slice, h2, hdim, ch, hc);
    cluster.sync();
    // layer 3 (own logits) from all of h2, plus noise
    dense<WT, false>(h2, w_out + cq, q, b_out + cq, slice, red, hdim, qc);
    __syncthreads();
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
  }
  cluster.sync();  // no block leaves while its shared memory may be read
}

template <typename WT>
int launch(const int32_t* window, int64_t ldw, const float* cond,
           int64_t ldc, const float* bup, const void* w_fused,
           const float* b_in, const void* w_h, const float* b_h,
           const void* w_out, const float* b_out, const float* noise,
           int noise_mode, float temperature, uint64_t seed, int64_t pos0,
           const uint32_t* lane_keys, const int64_t* lane_pos, int32_t* out,
           int64_t ldo, int b, int f1, int hdim, int q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(hdim, q, f1, Vec<WT>::N);
  cudaError_t err = cudaFuncSetAttribute(
      frame_decode_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = CL * ((b + LT - 1) / LT);
  frame_decode_kernel<WT><<<blocks, THREADS, smem, stream>>>(
      window, ldw, cond, ldc, bup, static_cast<const WT*>(w_fused), b_in,
      static_cast<const WT*>(w_h), b_h, static_cast<const WT*>(w_out), b_out,
      noise, noise_mode, temperature, seed, pos0, lane_keys, lane_pos, out,
      ldo, b, f1, hdim, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int srnn_frame_decode(
    const int32_t* window, int64_t ldw, const float* cond, int64_t ldc,
    const float* bup, const void* w_fused, const float* b_in,
    const void* w_h, const float* b_h, const void* w_out, const float* b_out,
    const float* noise, int noise_mode, float temperature, uint64_t seed,
    int64_t pos0, const uint32_t* lane_keys, const int64_t* lane_pos,
    int32_t* out, int64_t ldo, int b, int f1, int hdim, int q, int w_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return launch<__nv_bfloat16>(window, ldw, cond, ldc, bup, w_fused, b_in,
                                 w_h, b_h, w_out, b_out, noise, noise_mode,
                                 temperature, seed, pos0, lane_keys, lane_pos,
                                 out, ldo, b, f1, hdim, q, s);
  return launch<float>(window, ldw, cond, ldc, bup, w_fused, b_in, w_h, b_h,
                       w_out, b_out, noise, noise_mode, temperature, seed,
                       pos0, lane_keys, lane_pos, out, ldo, b, f1, hdim, q, s);
}
