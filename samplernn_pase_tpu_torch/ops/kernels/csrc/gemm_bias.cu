// K2 gemm_bias: C[M,N] = round(A)[M,K] @ W[K,N] + bias[N] (+ add[M,N])
// (+ the conditioning row of each output row).
//
// Replaces the products that samplernn_pase_tpu/ops/pallas/megagen.py
// (_kernel: tier_in, _cell, the f1-row upsample hoist, up_row) and
// ops/pallas/decode.py (_tier_frame_kernel) run on the TPU's matrix unit:
// the tier input, the two GRU gate products and the upsample.
//
// A is float32 activations, or int32 levels dequantized on load as
// l/(q/2) - 1; each A element is rounded to the weight type before the
// product (x.astype(w.dtype) in the reference) and products accumulate in
// float32.  The epilogue order is ((acc + bias) + add) + ext row, the
// reference's (tier_in: x + bf, + upper, + ext; float32 samples depend on
// it).
//
// Conditioning (the megakernel's cond_rate/ext_proj/cond_phase mode,
// megagen.py:196-220 tier_in): ext holds R projected conditioning rows per
// output row b (row r of b at ext + r*ld_row + b*ld_lane).  At `pos`, the
// tier frame's first-sample offset within the call, row b adds
//   base = pos / rate, bump = phase[b] + pos % rate >= rate,
//   r = bump ? min(base + 1, R - 1) : base
// (each lane's rows start at its own origin and its sub-row phase picks
// one of two rows).  The row index is worked out here, not on the host,
// so a tier step stays one launch; the bf16 route reads both candidate
// rows (2*B*N*4 bytes) so that the select waits on no dependent load.
//
// Bound on the H100: at decode batch 128 the products are skinny
// ([128,1024]@[1024,3072], [128,1024]@[1024,16384]); the weights (up to
// 32 MB in bf16) are read once per call, so the bytes bound is 0.2-13 us
// and the FLOP bound at the tensor-core rate is under 1.5 us.  bf16
// weights take the split-K wgmma core of skinny_gemm.cuh (K split over a
// thread-block cluster, W streamed by TMA, A staged by TMA and
// rounded once per stage, partials summed through distributed shared
// memory in rank order) with the epilogue below; the plan comes from
// ops/kernels/decode.py:gemm_plan.  float32 weights (the exact path the
// tests hold against the reference) take a plain tiled FMA product.  Rows
// of A, `add` and C take a leading dimension so that strided views of the
// generation buffer need no copy.  With `pdl` either route is launched as a
// programmatic dependent of the kernel before it (K1 there, which triggers
// once resident): the GRU tiers' next h @ W_hh then runs beside K1 on the
// SMs K1 leaves idle (ops/kernels/megagen.py).

#include <cmath>

#include "common.cuh"
#include "skinny_gemm.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// The conditioning epilogue's inputs; ext == nullptr turns it off.
struct ExtCond {
  const float* ext;
  int64_t ld_row, ld_lane;
  const int32_t* phase;
  int rows, pos, rate;
};

__device__ __forceinline__ float add_ext(const ExtCond& e, float v, int gr,
                                         int gc) {
  if (!e.ext) return v;
  const int base = e.pos / e.rate;
  const bool bump = e.phase[gr] + e.pos % e.rate >= e.rate;
  const int r = bump ? min(base + 1, e.rows - 1) : base;
  return v + e.ext[static_cast<int64_t>(r) * e.ld_row +
                   static_cast<int64_t>(gr) * e.ld_lane + gc];
}

template <typename WT, bool LEVELS>
__global__ void __launch_bounds__(THREADS)
gemm_bias_kernel(const void* __restrict__ a_ptr, int64_t lda,
                 const WT* __restrict__ w, const float* __restrict__ bias,
                 const float* __restrict__ add, int64_t ldadd,
                 ExtCond ext, float* __restrict__ c, int64_t ldc, int m,
                 int n, int k, float q_half) {
  __shared__ float as[BK][BM];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / BK, kk = e % BK;
      const int gr = row0 + row, gk = k0 + kk;
      float v = 0.f;
      if (gr < m && gk < k) {
        if (LEVELS) {
          const int32_t lv = static_cast<const int32_t*>(a_ptr)[gr * lda + gk];
          v = static_cast<float>(lv) / q_half - 1.f;
        } else {
          v = static_cast<const float*>(a_ptr)[gr * lda + gk];
        }
        v = srnn::round_to<WT>(v);
      }
      as[kk][row] = v;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = e / BN, col = e % BN;
      const int gk = k0 + kk, gc = col0 + col;
      ws[kk][col] = (gk < k && gc < n)
                        ? srnn::to_f32(w[static_cast<int64_t>(gk) * n + gc])
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc >= n) continue;
      float v = acc[i][j];
      if (bias) v = v + bias[gc];
      if (add) v = v + add[gr * ldadd + gc];
      c[gr * ldc + gc] = add_ext(ext, v, gr, gc);
    }
  }
}


// ---- bf16 weights: the skinny wgmma core (skinny_gemm.cuh) ----

// K2's epilogue on four columns of an output row, after the cluster's
// split-K sum: ((acc + bias) + add) + the row's conditioning row.  Every
// input is loaded (16 bytes where `vec`) in `load`, before the core's
// first store; both candidate conditioning rows are read, so the row
// select costs no dependent load.
struct K2Epilogue {
  const float* bias;
  const float* add;
  int64_t ldadd;
  const float* ext;
  int64_t ld_row, ld_lane;
  const int32_t* phase;
  int base, hi, pmod, rate;   // rows pos / rate and min(that + 1, R - 1)
  float* c;
  int64_t ldc;
  int vec;

  struct In {
    float4 b, a, e0, e1;
    int ph;
  };

  __device__ __forceinline__ In load(int row, int col, int) const {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    In in{z, z, z, z, 0};
    if (!vec) return in;   // the scalar path loads as it stores
    if (bias) in.b = *reinterpret_cast<const float4*>(bias + col);
    if (add) in.a = *reinterpret_cast<const float4*>(add + row * ldadd + col);
    if (ext) {
      const float* er = ext + static_cast<int64_t>(row) * ld_lane + col;
      in.e0 = *reinterpret_cast<const float4*>(er + base * ld_row);
      in.e1 = *reinterpret_cast<const float4*>(er + hi * ld_row);
      in.ph = phase[row];
    }
    return in;
  }

  __device__ __forceinline__ void store(int row, int col, float4 v,
                                        const In& in, int n) const {
    if (vec) {   // n, the row strides and the pointers are 16-byte multiples
      if (bias)
        v = make_float4(v.x + in.b.x, v.y + in.b.y, v.z + in.b.z,
                        v.w + in.b.w);
      if (add)
        v = make_float4(v.x + in.a.x, v.y + in.a.y, v.z + in.a.z,
                        v.w + in.a.w);
      if (ext) {
        const float4 e = in.ph + pmod >= rate ? in.e1 : in.e0;
        v = make_float4(v.x + e.x, v.y + e.y, v.z + e.z, v.w + e.w);
      }
      *reinterpret_cast<float4*>(c + row * ldc + col) = v;
      return;
    }
    const float vs[4] = {v.x, v.y, v.z, v.w};
    const int r = ext && phase[row] + pmod >= rate ? hi : base;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gc = col + u;
      if (gc >= n) break;
      float x = vs[u];
      if (bias) x = x + bias[gc];
      if (add) x = x + add[row * ldadd + gc];
      if (ext) x = x + ext[static_cast<int64_t>(r) * ld_row +
                           static_cast<int64_t>(row) * ld_lane + gc];
      c[row * ldc + gc] = x;
    }
  }
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename WT>
int launch(const void* a, int a_levels, int64_t lda, const void* w,
           const float* bias, const float* add, int64_t ldadd,
           const ExtCond& ext, float* c, int64_t ldc, int m, int n, int k,
           float q_half, bool pdl, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + BN - 1) / BN, (m + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const WT* wt = static_cast<const WT*>(w);
  return static_cast<int>(
      a_levels ? cudaLaunchKernelEx(&cfg, gemm_bias_kernel<WT, true>, a, lda,
                                    wt, bias, add, ldadd, ext, c, ldc, m, n,
                                    k, q_half)
               : cudaLaunchKernelEx(&cfg, gemm_bias_kernel<WT, false>, a, lda,
                                    wt, bias, add, ldadd, ext, c, ldc, m, n,
                                    k, q_half));
}

}  // namespace

extern "C" int srnn_gemm_bias(const void* a, int a_levels, int64_t lda,
                              const void* w, int w_bf16, const float* bias,
                              const float* add, int64_t ldadd, float* c,
                              int64_t ldc, int m, int n, int k, float q_half,
                              const float* ext, int64_t ext_ld_row,
                              int64_t ext_ld_lane, int ext_rows,
                              const int32_t* cond_phase, int pos,
                              int cond_rate, int split, int bn, int groups,
                              int pdl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ExtCond e{ext, ext_ld_row, ext_ld_lane, cond_phase, ext_rows, pos,
                  cond_rate};
  if (!w_bf16) {
    return launch<float>(a, a_levels, lda, w, bias, add, ldadd, e, c, ldc, m,
                         n, k, q_half, pdl != 0, s);
  }
  namespace sk = srnn::skinny;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  int exp2 = 0;
  const bool pow2 = q_half > 0.f && std::frexp(q_half, &exp2) == 0.5f;
  sk::Problem p{a, lda, q_half, pow2 ? 1.f / q_half : 0.f, wb, wb, k, m, n, k,
                split, groups, 0, 0};
  const int base = ext ? pos / cond_rate : 0;
  const int hi = base + 1 < ext_rows ? base + 1 : ext_rows - 1;
  K2Epilogue epi{bias, add, ldadd, ext, ext_ld_row, ext_ld_lane, cond_phase,
                 base, ext ? hi : 0, ext ? pos % cond_rate : 0,
                 ext ? cond_rate : 1, c, ldc, 0};
  epi.vec = n % 4 == 0 && ldc % 4 == 0 && aligned16(c) &&
            (!bias || aligned16(bias)) &&
            (!add || (ldadd % 4 == 0 && aligned16(add))) &&
            (!ext || (ext_ld_row % 4 == 0 && ext_ld_lane % 4 == 0 &&
                      aligned16(ext)));
  return a_levels ? sk::run<sk::A_LEVELS>(p, bn, epi, s, pdl != 0)
                  : sk::run<sk::A_F32>(p, bn, epi, s, pdl != 0);
}

// Clusters of `split` CTAs the card holds at once for K2's float32-A
// core at tile width bn (the plan's occupancy), or -1.
extern "C" int srnn_gemm_bias_clusters(int split, int bn) {
  namespace sk = srnn::skinny;
  return bn == 64 ? sk::max_clusters<64, sk::A_F32, K2Epilogue>(split)
                  : sk::max_clusters<128, sk::A_F32, K2Epilogue>(split);
}
