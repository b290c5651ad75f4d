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
// so a tier step stays one launch; reading it adds B*N*4 bytes.
//
// Bound on the H100: at decode batch 128 the products are small
// ([128,1024]@[1024,3072], [128,1024]@[1024,16384]); the weights (up to
// 32 MB in bf16) are read once per call, so the bytes bound is a few us
// and the FLOP bound at the tensor-core rate is under 10 us.  bf16 weights
// take the tensor cores: 64x64 output tiles, four warps of 2x2 WMMA
// 16x16x16 fragments (mma.sync), BK=64 slices staged through shared
// memory with the next slice prefetched into registers.  float32 weights
// (the exact path the tests hold against the reference) take a plain
// tiled FMA product.  Rows of A, `add` and C take a leading dimension so
// that strided views of the generation buffer need no copy.

#include <mma.h>

#include "common.cuh"

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


// ---- bf16 weights: tensor-core tiles ----
constexpr int TBM = 64, TBN = 64, TBK = 64, TTHREADS = 128;
constexpr int LDA = TBK + 8, LDW = TBN + 8, LDC = TBN + 4;  // padded rows

template <bool LEVELS>
__device__ __forceinline__ float load_a(const void* a_ptr, int64_t lda,
                                        int r, int k, int m, int kdim,
                                        float q_half) {
  if (r >= m || k >= kdim) return 0.f;
  if (LEVELS) {
    const int32_t lv = static_cast<const int32_t*>(a_ptr)[r * lda + k];
    return static_cast<float>(lv) / q_half - 1.f;
  }
  return static_cast<const float*>(a_ptr)[r * lda + k];
}

// Four consecutive A elements (row r, columns k..k+3) as float32, one
// 16-byte load where the row allows it.
template <bool LEVELS>
__device__ __forceinline__ float4 load_a4(const void* a_ptr, int64_t lda,
                                          int r, int k, int m, int kdim,
                                          float q_half, bool vec) {
  if (vec && r < m && k + 3 < kdim) {
    if (LEVELS) {
      const int4 v = *reinterpret_cast<const int4*>(
          static_cast<const int32_t*>(a_ptr) + r * lda + k);
      return make_float4(static_cast<float>(v.x) / q_half - 1.f,
                         static_cast<float>(v.y) / q_half - 1.f,
                         static_cast<float>(v.z) / q_half - 1.f,
                         static_cast<float>(v.w) / q_half - 1.f);
    }
    return *reinterpret_cast<const float4*>(
        static_cast<const float*>(a_ptr) + r * lda + k);
  }
  return make_float4(load_a<LEVELS>(a_ptr, lda, r, k, m, kdim, q_half),
                     load_a<LEVELS>(a_ptr, lda, r, k + 1, m, kdim, q_half),
                     load_a<LEVELS>(a_ptr, lda, r, k + 2, m, kdim, q_half),
                     load_a<LEVELS>(a_ptr, lda, r, k + 3, m, kdim, q_half));
}

template <bool LEVELS>
__global__ void __launch_bounds__(TTHREADS)
gemm_bias_wmma_kernel(const void* __restrict__ a_ptr, int64_t lda,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ add, int64_t ldadd,
                      ExtCond ext, float* __restrict__ c, int64_t ldc,
                      int m, int n, int k, float q_half) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(32) __nv_bfloat16 as[TBM * LDA];
  __shared__ __align__(32) __nv_bfloat16 ws[TBK * LDW];
  __shared__ __align__(32) float cs[TBM * LDC];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;        // warp's 32x32 sub-tile
  const int row0 = blockIdx.y * TBM, col0 = blockIdx.x * TBN;
  constexpr int A_PER = TBM * TBK / (4 * TTHREADS);   // float4s per thread
  constexpr int W_PER = TBK * TBN / (8 * TTHREADS);   // 8-bf16 vectors
  const bool a_vec = lda % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a_ptr) % 16 == 0;
  const bool w_vec = n % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  float4 ra[A_PER];
  uint4 rw[W_PER];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const int f = tid + r * TTHREADS, row = f / (TBK / 4);
      const int kq = (f % (TBK / 4)) * 4;
      ra[r] = load_a4<LEVELS>(a_ptr, lda, row0 + row, k0 + kq, m, k, q_half,
                              a_vec);
    }
#pragma unroll
    for (int r = 0; r < W_PER; ++r) {
      const int f = tid + r * TTHREADS, kk = f / (TBN / 8);
      const int gk = k0 + kk, gc = col0 + (f % (TBN / 8)) * 8;
      if (w_vec && gk < k && gc + 7 < n) {
        rw[r] = *reinterpret_cast<const uint4*>(
            w + static_cast<int64_t>(gk) * n + gc);
      } else {
        uint32_t bits[8];
#pragma unroll
        for (int v = 0; v < 8; ++v)
          bits[v] = (gk < k && gc + v < n)
                        ? __bfloat16_as_ushort(
                              w[static_cast<int64_t>(gk) * n + gc + v])
                        : 0u;
        rw[r] = make_uint4(bits[0] | bits[1] << 16, bits[2] | bits[3] << 16,
                           bits[4] | bits[5] << 16, bits[6] | bits[7] << 16);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch(0);
  for (int k0 = 0; k0 < k; k0 += TBK) {
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const int f = tid + r * TTHREADS;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          as + (f / (TBK / 4)) * LDA + (f % (TBK / 4)) * 4);
      dst[0] = __floats2bfloat162_rn(ra[r].x, ra[r].y);
      dst[1] = __floats2bfloat162_rn(ra[r].z, ra[r].w);
    }
#pragma unroll
    for (int r = 0; r < W_PER; ++r) {
      const int f = tid + r * TTHREADS;
      *reinterpret_cast<uint4*>(ws + (f / (TBN / 8)) * LDW +
                                (f % (TBN / 8)) * 8) = rw[r];
    }
    __syncthreads();
    if (k0 + TBK < k) fetch(k0 + TBK);   // next slice, in flight meanwhile
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDA + kk,
                               LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], ws + kk * LDW + wn * 32 + j * 16, LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < TBM * TBN; e += TTHREADS) {
    const int gr = row0 + e / TBN, gc = col0 + e % TBN;
    if (gr >= m || gc >= n) continue;
    float v = cs[(e / TBN) * LDC + e % TBN];
    if (bias) v = v + bias[gc];
    if (add) v = v + add[gr * ldadd + gc];
    c[gr * ldc + gc] = add_ext(ext, v, gr, gc);
  }
}

template <typename WT>
void launch(const void* a, int a_levels, int64_t lda, const void* w,
            const float* bias, const float* add, int64_t ldadd,
            const ExtCond& ext, float* c, int64_t ldc, int m, int n, int k,
            float q_half, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const WT* wt = static_cast<const WT*>(w);
  if (a_levels)
    gemm_bias_kernel<WT, true><<<grid, THREADS, 0, stream>>>(
        a, lda, wt, bias, add, ldadd, ext, c, ldc, m, n, k, q_half);
  else
    gemm_bias_kernel<WT, false><<<grid, THREADS, 0, stream>>>(
        a, lda, wt, bias, add, ldadd, ext, c, ldc, m, n, k, q_half);
}

}  // namespace

extern "C" int srnn_gemm_bias(const void* a, int a_levels, int64_t lda,
                              const void* w, int w_bf16, const float* bias,
                              const float* add, int64_t ldadd, float* c,
                              int64_t ldc, int m, int n, int k, float q_half,
                              const float* ext, int64_t ext_ld_row,
                              int64_t ext_ld_lane, int ext_rows,
                              const int32_t* cond_phase, int pos,
                              int cond_rate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ExtCond e{ext, ext_ld_row, ext_ld_lane, cond_phase, ext_rows, pos,
                  cond_rate};
  if (w_bf16) {
    const dim3 grid((n + TBN - 1) / TBN, (m + TBM - 1) / TBM);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
    if (a_levels)
      gemm_bias_wmma_kernel<true><<<grid, TTHREADS, 0, s>>>(
          a, lda, wb, bias, add, ldadd, e, c, ldc, m, n, k, q_half);
    else
      gemm_bias_wmma_kernel<false><<<grid, TTHREADS, 0, s>>>(
          a, lda, wb, bias, add, ldadd, e, c, ldc, m, n, k, q_half);
  } else {
    launch<float>(a, a_levels, lda, w, bias, add, ldadd, e, c, ldc, m, n, k,
                  q_half, s);
  }
  return static_cast<int>(cudaGetLastError());
}
