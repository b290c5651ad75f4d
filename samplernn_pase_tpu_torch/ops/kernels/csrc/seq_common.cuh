// Shared parts of the whole-sequence RNN kernels (K4 gru_sequence, K5
// lstm_sequence): the staged-tile loads and tensor-core fragments of the
// serial chains, the tiled GEMMs of the input and weight-gradient
// products, and the cooperative launch of a chain after its residency
// check.  Each kernel library includes this header once; everything here
// has internal linkage, so the two libraries keep their own copies.
//
// A serial chain runs the whole sequence in one cooperative launch: block
// i owns hidden units [8i, 8i+8) with all their gate columns, keeps its
// slice of Whh in shared memory, stages the rows it multiplies (h_{t-1},
// or the gate gradients) from L2 in 128-column chunks with the next
// chunk's loads in flight, and meets the other blocks at one grid barrier
// per step.
#pragma once

#include <cooperative_groups.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ helpers --

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int U = 8;            // hidden units per block
constexpr int THREADS = 256;    // U units x 32 row groups
constexpr int RT = 4;           // rows per thread per pass
constexpr int ROWS = 32 * RT;   // rows per pass
constexpr int KC = 128;         // k columns staged per chunk
constexpr int HS = KC + 4;      // padded float32 row of the staged tile
constexpr int ALD = KC + 8;     // padded bf16 row of the staged tile
constexpr int NV = ROWS * (KC / 8) / THREADS;   // 8-element vectors/thread

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Eight WT values in registers -> float32.
__device__ __forceinline__ void unpack8(const uint4* raw, float* out,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack8(const uint4* raw, float* out,
                                       float) {
  const uint32_t w[8] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w,
                         raw[1].x, raw[1].y, raw[1].z, raw[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __uint_as_float(w[i]);
}

// One chunk of a staged tile in registers: rows [r0, r0+ROWS) x columns
// [k0, k0+KC) of a row-major [rows, ld] matrix in WT (rows past `rows`,
// columns past `cols` are zero; cols and ld are multiples of 8).  The
// serial kernels fetch the next chunk while they compute on the current
// one.  Loads go through L2 (ld.global.cg): the rows were written by other
// blocks earlier in the same launch and must not come from a stale L1 line.
template <typename WT>
struct Chunk {
  static constexpr int W = sizeof(WT) / 2;   // uint4 per 8 elements
  uint4 raw[NV][W];

  __device__ __forceinline__ void fetch(const WT* src, int64_t ld, int r0,
                                        int rows, int k0, int cols) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int e = threadIdx.x + v * THREADS;
      const int r = e / (KC / 8), kk = (e % (KC / 8)) * 8;
      const bool in = r0 + r < rows && k0 + kk < cols;
      const uint4* p = reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(r0 + r) * ld + k0 + kk);
#pragma unroll
      for (int w = 0; w < W; ++w)
        raw[v][w] = in ? __ldcg(p + w) : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // -> as[ROWS][ALD] as it is (bf16)
  __device__ __forceinline__ void store_raw(bf16* as) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int e = threadIdx.x + v * THREADS;
      *reinterpret_cast<uint4*>(as + (e / (KC / 8)) * ALD +
                                (e % (KC / 8)) * 8) = raw[v][0];
    }
  }

  // -> hs[ROWS][HS] as float32
  __device__ __forceinline__ void store(float* hs) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int e = threadIdx.x + v * THREADS;
      const int r = e / (KC / 8), kk = (e % (KC / 8)) * 8;
      float f[8];
      unpack8(raw[v], f, WT());
      float4* dst = reinterpret_cast<float4*>(hs + r * HS + kk);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
};

// hbuf[0] = round(h0) for this block's units: the product of step 0
// reads it like any round(h_{t-1}); every block waits for all of it.
template <typename WT>
__device__ __forceinline__ void round_h0(const float* __restrict__ h0,
                                         WT* hbuf, int b, int hdim,
                                         cg::grid_group& grid) {
  for (int e = threadIdx.x; e < b * U; e += THREADS) {
    const int64_t o = static_cast<int64_t>(e / U) * hdim + blockIdx.x * U +
                      e % U;
    hbuf[o] = from_f32<WT>(h0[o]);
  }
  __threadfence();
  grid.sync();
}

// Unit threadIdx.x's (< U) bias sums over the block's threads, in a fixed
// order: part[THREADS][2][4] holds thread th's four sums for its units
// (the FMA form owns one unit, th % 8, in slot 0; the mma form two,
// 2*(th%4) + q, in slot q).
template <bool MMA>
__device__ __forceinline__ void unit_sums(const float* part, float* a) {
  const int u = threadIdx.x;
#pragma unroll
  for (int c = 0; c < 4; ++c) a[c] = 0.f;
  for (int th = 0; th < THREADS; ++th)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if ((MMA ? 2 * (th % 4) + q : (q == 0 ? th % U : -1)) == u)
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] += part[(th * 2 + q) * 4 + c];
}

// ---- bf16 chains: tensor cores (mma.sync m16n8k16, float32 sums) ----
// Warp w owns rows w*16 .. w*16+15 of each 128-row pass; lane (g =
// lane / 4, tq = lane % 4) holds, in the accumulator layout, rows w*16+g
// and w*16+g+8 of units 2tq and 2tq+1, so a unit's gate math stays in the
// thread.  The staged tile and the Whh slice are bf16 in shared memory,
// rows padded so that the fragment loads hit 32 distinct banks.

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows x 16 k) of the staged tile: rows w*16 + g (+8),
// k = kk + 2tq (+1) and (+8, +9).
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* as, int kk) {
  const int lane = threadIdx.x % 32;
  const bf16* p = as + ((threadIdx.x / 32) * 16 + lane / 4) * ALD + kk +
                  2 * (lane % 4);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ALD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ALD + 8);
}

// B fragment (16 k x 8 n) from a [n][k] bf16 slice with row length ld.
__device__ __forceinline__ void load_b(uint32_t* bfr, const bf16* bs, int ld,
                                       int k) {
  const int lane = threadIdx.x % 32;
  const bf16* p = bs + (lane / 4) * ld + k + 2 * (lane % 4);
  bfr[0] = ld32(p);
  bfr[1] = ld32(p + 8);
}

// Accumulator element i of this thread: row offset in the pass and unit.
__device__ __forceinline__ int mma_row(int i) {
  return (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4 + (i >= 2 ? 8 : 0);
}
__device__ __forceinline__ int mma_unit(int i) {
  return 2 * (threadIdx.x % 4) + (i & 1);
}

// ---------------------------------------------------------- GEMMs --
// C[M,N] = A[M,K] @ B[K,N] (+ bias[N]), A and B in the weight type (values
// already rounded), float32 accumulation, C in OT.  AT: A is stored
// transposed ([K, M], leading dimension lda); BT: B is stored transposed
// ([N, K], leading dimension ldb).  Each output sums over K in one block in
// a fixed order.

// float32: a plain tiled FMA product (the exact path the tests use).
constexpr int FB = 64, FK = 16, FTHREADS = 256;

template <bool AT, bool BT>
__global__ void __launch_bounds__(FTHREADS)
seq_gemm_f32(const float* __restrict__ a, int64_t lda,
             const float* __restrict__ bm, int64_t ldb,
             const float* __restrict__ bias, float* __restrict__ c,
             int64_t ldc, int m, int n, int k) {
  __shared__ float as[FK][FB];
  __shared__ float bs[FK][FB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * FB, col0 = blockIdx.x * FB;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += FK) {
    for (int e = tid; e < FB * FK; e += FTHREADS) {
      // pick the index order whose global reads are contiguous
      const int r = AT ? e % FB : e / FK, kk = AT ? e / FB : e % FK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k)
          ? a[AT ? gk * lda + gr : gr * lda + gk] : 0.f;
    }
    for (int e = tid; e < FB * FK; e += FTHREADS) {
      const int cc = BT ? e / FK : e % FB, kk = BT ? e % FK : e / FB;
      const int gc = col0 + cc, gk = k0 + kk;
      bs[kk][cc] = (gc < n && gk < k)
          ? bm[BT ? gc * ldb + gk : gk * ldb + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bs[kk][tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= m) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gc = col0 + tx + 16 * q;
      if (gc >= n) continue;
      c[static_cast<int64_t>(gr) * ldc + gc] =
          bias ? acc[i][q] + bias[gc] : acc[i][q];
    }
  }
}

// bf16: tensor cores, WMMA 16x16x16, 64x64 tiles, four warps of 32x32,
// BK=64 slices staged through shared memory with the next slice prefetched
// into registers.  Shared tiles keep the global layout's contiguous
// dimension; a transposed operand is read as a column-major fragment.
constexpr int TB = 64, TK = 64, TTHREADS = 128, TLD = 72, TLDC = 68;

// Tile rows [r0, r0+64) x columns [c0, c0+64) of a row-major matrix with
// leading dimension ld and extent rows x cols, 8 elements per vector.
struct TileLoader {
  uint4 v[TB * TK / (8 * TTHREADS)];

  __device__ __forceinline__ void fetch(const bf16* g, int64_t ld, int r0,
                                        int c0, int rows, int cols,
                                        bool vec) {
#pragma unroll
    for (int i = 0; i < TB * TK / (8 * TTHREADS); ++i) {
      const int f = threadIdx.x + i * TTHREADS;
      const int r = r0 + f / (TK / 8), cc = c0 + (f % (TK / 8)) * 8;
      if (vec && r < rows && cc + 7 < cols) {
        v[i] = *reinterpret_cast<const uint4*>(g + r * ld + cc);
      } else {
        uint32_t bits[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          bits[q] = (r < rows && cc + q < cols)
                        ? __bfloat16_as_ushort(g[r * ld + cc + q]) : 0u;
        v[i] = make_uint4(bits[0] | bits[1] << 16, bits[2] | bits[3] << 16,
                          bits[4] | bits[5] << 16, bits[6] | bits[7] << 16);
      }
    }
  }

  __device__ __forceinline__ void store(bf16* s) const {
#pragma unroll
    for (int i = 0; i < TB * TK / (8 * TTHREADS); ++i) {
      const int f = threadIdx.x + i * TTHREADS;
      *reinterpret_cast<uint4*>(s + (f / (TK / 8)) * TLD +
                                (f % (TK / 8)) * 8) = v[i];
    }
  }
};

template <bool AT, bool BT, typename OT>
__global__ void __launch_bounds__(TTHREADS)
seq_gemm_bf16(const bf16* __restrict__ a, int64_t lda,
              const bf16* __restrict__ bm, int64_t ldb,
              const float* __restrict__ bias, OT* __restrict__ c,
              int64_t ldc, int m, int n, int k) {
  namespace wmma = nvcuda::wmma;
  using LA = std::conditional_t<AT, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<BT, wmma::col_major, wmma::row_major>;
  __shared__ __align__(32) bf16 as[TB * TLD];
  __shared__ __align__(32) bf16 bs[TB * TLD];
  __shared__ __align__(32) float cs[TB * TLDC];
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  const int row0 = blockIdx.y * TB, col0 = blockIdx.x * TB;
  const bool a_vec = lda % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec = ldb % 8 == 0 && reinterpret_cast<uintptr_t>(bm) % 16 == 0;
  TileLoader la, lb;
  // shared a tile: [m][k] (A) or [k][m] (AT); b tile: [k][n] (B) or [n][k]
  auto fetch = [&](int k0) {
    if (AT) la.fetch(a, lda, k0, row0, k, m, a_vec);
    else la.fetch(a, lda, row0, k0, m, k, a_vec);
    if (BT) lb.fetch(bm, ldb, col0, k0, n, k, b_vec);
    else lb.fetch(bm, ldb, k0, col0, k, n, b_vec);
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q) wmma::fill_fragment(acc[i][q], 0.f);

  fetch(0);
  for (int k0 = 0; k0 < k; k0 += TK) {
    la.store(as);
    lb.store(bs);
    __syncthreads();
    if (k0 + TK < k) fetch(k0 + TK);   // next slice, in flight meanwhile
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mo = wm * 32 + i * 16;
        wmma::load_matrix_sync(fa[i], AT ? as + kk * TLD + mo
                                         : as + mo * TLD + kk, TLD);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int no = wn * 32 + q * 16;
        wmma::load_matrix_sync(fb[q], BT ? bs + no * TLD + kk
                                         : bs + kk * TLD + no, TLD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          wmma::mma_sync(acc[i][q], fa[i], fb[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * TLDC + wn * 32 +
                                  q * 16,
                              acc[i][q], TLDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < TB * TB; e += TTHREADS) {
    const int gr = row0 + e / TB, gc = col0 + e % TB;
    if (gr >= m || gc >= n) continue;
    float v = cs[(e / TB) * TLDC + e % TB];
    if (bias) v = v + bias[gc];
    c[static_cast<int64_t>(gr) * ldc + gc] = from_f32<OT>(v);
  }
}

template <bool AT, bool BT, typename OT>
int gemm(bool w_bf16, const void* a, int64_t lda, const void* b, int64_t ldb,
         const float* bias, OT* c, int64_t ldc, int m, int n, int k,
         cudaStream_t s) {
  if (w_bf16) {
    const dim3 grid((n + TB - 1) / TB, (m + TB - 1) / TB);
    seq_gemm_bf16<AT, BT, OT><<<grid, TTHREADS, 0, s>>>(
        static_cast<const bf16*>(a), lda, static_cast<const bf16*>(b), ldb,
        bias, c, ldc, m, n, k);
  } else {
    const dim3 grid((n + FB - 1) / FB, (m + FB - 1) / FB);
    seq_gemm_f32<AT, BT><<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb,
        bias, reinterpret_cast<float*>(c), ldc, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- cooperative launch --

// 0 when `blocks` blocks of a serial kernel with `smem` bytes of dynamic
// shared memory can all be resident at once (the grid barrier needs it);
// else 1 (shared memory), 2 (co-residency) or a negative cudaError_t.
int chain_fits(const void* kernel, int blocks, size_t smem) {
  int dev = 0, limit = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return -static_cast<int>(err);
  if (smem > static_cast<size_t>(limit)) return 1;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(smem))) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return -static_cast<int>(err);
  return blocks <= per_sm * sms ? 0 : 2;
}

// A cooperative launch of one serial kernel, after the residency check,
// so a grid that cannot all be resident fails instead of deadlocking.
int launch_chain(const void* kernel, int blocks, size_t smem, void** args,
                 cudaStream_t s) {
  const int fits = chain_fits(kernel, blocks, smem);
  if (fits < 0) return -fits;
  if (fits > 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(THREADS), args, smem, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace
