// Shared parts of the whole-sequence RNN kernels (K4 gru_sequence, K5
// lstm_sequence): the tiled GEMMs of the input and weight-gradient
// products (bf16: a TMA-fed wgmma tile GEMM; float32: FMA tiles), the bf16
// serial chains' engine (namespace tc: TMA ring, readiness flags, wgmma),
// the float32 chains' staged loads, and the cooperative launch of a chain
// after its residency check; the chains themselves, written once over a
// cell type, are in seq_chain.cuh.  Each kernel library includes this
// header once; everything here has internal linkage, so the two libraries
// keep their own copies.
//
// A serial chain runs the whole sequence in one cooperative launch.  bf16
// (namespace tc below): blocks of 8 or 16 hidden units and a share of the
// rows keep their Whh slice in shared memory, stage the rows they multiply
// by TMA as soon as the blocks that own them have published the step, and
// never meet at a grid barrier.  float32 (the exact path the tests hold):
// block i owns units [8i, 8i+8), stages the rows from L2 in 128-column
// chunks with the next chunk's loads in flight, and meets the other blocks
// at one grid barrier per step.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

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
constexpr int NV = ROWS * (KC / 8) / THREADS;   // 8-element vectors/thread

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// One chunk of a staged float32 tile in registers: rows [r0, r0+ROWS) x
// columns [k0, k0+KC) of a row-major [rows, ld] matrix (rows past `rows`,
// columns past `cols` are zero; cols and ld are multiples of 8).  The
// float32 chains fetch the next chunk while they compute on the current
// one.  Loads go through L2 (ld.global.cg): the rows were written by other
// blocks earlier in the same launch and must not come from a stale L1 line.
struct Chunk {
  uint4 raw[NV][2];   // 8 floats per vector

  __device__ __forceinline__ void fetch(const float* src, int64_t ld, int r0,
                                        int rows, int k0, int cols) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int e = threadIdx.x + v * THREADS;
      const int r = e / (KC / 8), kk = (e % (KC / 8)) * 8;
      const bool in = r0 + r < rows && k0 + kk < cols;
      const uint4* p = reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(r0 + r) * ld + k0 + kk);
#pragma unroll
      for (int w = 0; w < 2; ++w)
        raw[v][w] = in ? __ldcg(p + w) : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // -> hs[ROWS][HS]
  __device__ __forceinline__ void store(float* hs) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int e = threadIdx.x + v * THREADS;
      const int r = e / (KC / 8), kk = (e % (KC / 8)) * 8;
      float4* dst = reinterpret_cast<float4*>(hs + r * HS + kk);
      dst[0] = make_float4(__uint_as_float(raw[v][0].x),
                           __uint_as_float(raw[v][0].y),
                           __uint_as_float(raw[v][0].z),
                           __uint_as_float(raw[v][0].w));
      dst[1] = make_float4(__uint_as_float(raw[v][1].x),
                           __uint_as_float(raw[v][1].y),
                           __uint_as_float(raw[v][1].z),
                           __uint_as_float(raw[v][1].w));
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
// order: part[THREADS][4] holds thread th's four sums for its unit th % 8.
__device__ __forceinline__ void unit_sums(const float* part, float* a) {
  const int u = threadIdx.x;
#pragma unroll
  for (int c = 0; c < 4; ++c) a[c] = 0.f;
  for (int th = u; th < THREADS; th += U)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] += part[th * 4 + c];
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

// A wait of the sequence kernels that has not ended after about 10 s
// (2e10 cycles) traps: the launch fails with an error instead of holding
// the card (a fault, never a slow run).
constexpr long long WAIT_LIMIT = 20000000000LL;

__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(srnn::sm90::smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

// bf16: the tile GEMM for M in the thousands (sm_90a).  One CTA per
// 128 x 128 output tile sums it over all of K in order (no split-K, no
// atomics: two runs give the same bits).  One producer warp brings A's and
// B's 64-deep K-slices by TMA (128-byte swizzle, zero past M, N and K)
// into a ring of TG_STAGES slots, an mbarrier per slot for "landed" and one
// for "free"; two consumer warpgroups multiply with wgmma m64n128k16, rows
// [0, 64) and [64, 128) of the tile, one slice's batch in flight while the
// next is awaited; the bias and the cast to OT are the epilogue, from the
// registers.  Operand layouts in shared memory (atoms of 8 rows x 128 bytes
// aligned to 1024): a K-major operand (A as stored, or B stored [N, K]) is
// 128 rows x 128 bytes, row r at r * 128; an MN-major one (A stored [K, M],
// B as stored [K, N]) is two 64-wide panels 8192 bytes apart, K-row kk of
// a panel at kk * 128.
constexpr int TG_BM = 128, TG_BN = 128, TG_BK = 64, TG_STAGES = 5;
constexpr int TG_THREADS = 288;                 // two warpgroups + producer
constexpr int TG_A = TG_BM * TG_BK * 2, TG_B = TG_BK * TG_BN * 2;
constexpr int TG_SMEM = 1024 + TG_STAGES * (TG_A + TG_B);

template <bool AT, bool BT, typename OT>
__global__ void __launch_bounds__(TG_THREADS, 1)
seq_gemm_tc(const __grid_constant__ CUtensorMap amap,
            const __grid_constant__ CUtensorMap bmap,
            const float* __restrict__ bias, OT* __restrict__ c, int64_t ldc,
            int m, int n, int k) {
  using namespace srnn::sm90;
  __shared__ __align__(8) uint64_t full[TG_STAGES], empty[TG_STAGES];
  extern __shared__ __align__(128) uint8_t tg_raw[];
  uint8_t* smem = tg_raw + ((1024 - (smem_u32(tg_raw) & 1023)) & 1023);
  const int row0 = blockIdx.y * TG_BM, col0 = blockIdx.x * TG_BN;
  const int nk = (k + TG_BK - 1) / TG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp == 8) {                       // producer
    if (threadIdx.x % 32 == 0)
      for (int j = 0; j < nk; ++j) {
        const int slot = j % TG_STAGES;
        if (j >= TG_STAGES)
          mbar_wait_bounded(&empty[slot], (j / TG_STAGES - 1) & 1);
        uint8_t* sa = smem + slot * (TG_A + TG_B);
        uint8_t* sb = sa + TG_A;
        mbar_expect_tx(&full[slot], TG_A + TG_B);
        const int k0 = j * TG_BK;
        if (AT) {
          tma_box(sa, &amap, row0, k0, &full[slot]);
          tma_box(sa + 8192, &amap, row0 + 64, k0, &full[slot]);
        } else {
          tma_box(sa, &amap, k0, row0, &full[slot]);
        }
        if (BT) {
          tma_box(sb, &bmap, k0, col0, &full[slot]);
        } else {
          tma_box(sb, &bmap, col0, k0, &full[slot]);
          tma_box(sb + 8192, &bmap, col0 + 64, k0, &full[slot]);
        }
      }
    return;
  }
  const int wg = warp / 4;               // consumer warpgroup 0 or 1
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t base = smem_u32(smem);
  for (int j = 0; j < nk; ++j) {
    const int slot = j % TG_STAGES;
    mbar_wait_bounded(&full[slot], (j / TG_STAGES) & 1);
    const uint32_t sa = base + slot * (TG_A + TG_B), sb = sa + TG_A;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t da = AT ? desc(sa + wg * 8192 + s * 2048, 8192, 1024, 1)
                             : desc(sa + wg * 8192 + s * 32, 16, 1024, 1);
      const uint64_t db = BT ? desc(sb + s * 32, 16, 1024, 1)
                             : desc(sb + s * 2048, 8192, 1024, 1);
      wgmma<128, AT ? 1 : 0, BT ? 0 : 1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();                     // slice j - 1 done: its slot is free
    fence_regs(acc);
    if (j > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(j - 1) % TG_STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // accumulator layout: rows 16 w + l/4 (+8), columns 8 i + 2 (l%4) (+1)
  const int lane = threadIdx.x % 32;
  const int r = row0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = col0 + 8 * i + 2 * (lane % 4);
    if (col >= n) continue;
    const bool pair = col + 1 < n;
    const float b0 = bias ? bias[col] : 0.f;
    const float b1 = bias && pair ? bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= m) continue;
      const float v0 = acc[4 * i + 2 * h] + b0;
      const float v1 = acc[4 * i + 2 * h + 1] + b1;
      OT* dst = c + static_cast<int64_t>(row) * ldc + col;
      if (pair && ldc % 2 == 0) {
        if constexpr (std::is_same<OT, float>::value)
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = from_f32<OT>(v0);
        if (pair) dst[1] = from_f32<OT>(v1);
      }
    }
  }
}

// The tile GEMM's tensor maps: a K-major operand (rows x K stored, ld
// elements per row) takes boxes of 64 K x 128 rows, an MN-major one (K x
// cols stored) boxes of 64 cols x 64 K.
inline bool tg_map(CUtensorMap* out, const void* p, int rows, int cols,
                   int64_t ld, bool k_major) {
  if (reinterpret_cast<uintptr_t>(p) % 16 || ld % 8) return false;
  return srnn::sm90::tensor_map(out, p, rows, cols, ld,
                                CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                k_major ? 128 : 64, true);
}

template <bool AT, bool BT, typename OT>
int tile_gemm(const bf16* a, int64_t lda, const bf16* b, int64_t ldb,
              const float* bias, OT* c, int64_t ldc, int m, int n, int k,
              cudaStream_t s) {
  CUtensorMap amap, bmap;
  // A: [m, k] (K-major) or [k, m] stored; B: [k, n] (MN-major) or [n, k]
  if (!(AT ? tg_map(&amap, a, k, m, lda, false)
           : tg_map(&amap, a, m, k, lda, true)) ||
      !(BT ? tg_map(&bmap, b, n, k, ldb, true)
           : tg_map(&bmap, b, k, n, ldb, false)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = seq_gemm_tc<AT, BT, OT>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TG_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((n + TG_BN - 1) / TG_BN, (m + TG_BM - 1) / TG_BM);
  seq_gemm_tc<AT, BT, OT><<<grid, TG_THREADS, TG_SMEM, s>>>(
      amap, bmap, bias, c, ldc, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
template <bool AT, bool BT, typename OT>
int gemm(bool w_bf16, const void* a, int64_t lda, const void* b, int64_t ldb,
         const float* bias, OT* c, int64_t ldc, int m, int n, int k,
         cudaStream_t s) {
  if (w_bf16)
    return tile_gemm<AT, BT, OT>(static_cast<const bf16*>(a), lda,
                                 static_cast<const bf16*>(b), ldb, bias, c,
                                 ldc, m, n, k, s);
  {
    const dim3 grid((n + FB - 1) / FB, (m + FB - 1) / FB);
    seq_gemm_f32<AT, BT><<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb,
        bias, reinterpret_cast<float*>(c), ldc, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- bf16 chains (sm_90a) --
// A serial chain with bf16 weights: block (row group rg, unit group ug),
// blockIdx.x = rg * owners + ug, owns hidden units [ug*U, ug*U+U) of rows
// [rg*rows, rg*rows+rows) (the plan, ops/kernels/rnn_train.py:chain_plan)
// and keeps its Whh slice in shared memory as wgmma's B operand (K-major,
// 128-byte swizzle, 64-column panels): forward its N = gates*U columns
// gate-major (column q*U + u is gate q of unit u, so that a thread's
// accumulator holds every gate of its units), backward its U rows of Whh
// (N = U).  Each step stages the rows it multiplies (h_{t-1}, or the gate
// gradients dG_t) by TMA into a ring of `stages` slots of nb 64-column
// chunks, one copy per slot (a copy costs its issuing thread about 0.4 us
// on the H100, whatever its size).  One producer warp waits for the
// blocks that own a slot's columns to have published the step (a flag
// per block in device memory, released after the block's rows are
// stored; polled relaxed, all owners at once, then one fence), issues the
// slot and counts it on the slot's mbarrier; 128 * WG consumer threads
// (WG warpgroups, 64 rows each per pass) multiply with wgmma m64nNk16 as
// the slots land and free each slot once its batch retires.  No grid
// barrier: a slot of step t+1 is copied as soon as its owners are done
// with step t.  All blocks must be resident (a block waits on the
// others' flags): the launch is cooperative, after the residency check;
// every wait traps after about 10 s instead of holding the card.
namespace tc {

constexpr int BOX = 64 * 128;       // bytes of a 64-row x 64-column bf16 box
constexpr int MAX_STAGES = 16;
constexpr int MAX_OWNERS = 256;     // unit groups per row group: 32 lanes x 8

struct Chain {
  int n, b, hdim;       // steps, batch, hidden width
  int kdim;             // columns of the staged rows: hdim or gates * hdim
  int units;            // hidden units per block (U)
  int owners;           // unit groups: hdim / units
  int rows;             // rows per block, a multiple of 64 * WG
  int stages;           // ring slots
  int kch;              // 64-column chunks per row pass
  int nb;               // chunks per ring slot: 1 (3-D boxes) or 8 (4-D)
  int kpan;             // B operand panels: kch rounded up to nb
  unsigned long long* trace;   // phase trace (seq_trace), or null
};

// Independent accumulators of a product N columns wide: its k16 steps take
// them in turn (the partial sums are added in order at the end), so that
// the dependent wgmmas of a narrow product overlap.
__host__ __device__ constexpr int nacc(int nc) {
  return nc <= 16 ? 4 : nc <= 64 ? 2 : 1;
}

// Phase trace: with Chain::trace set, block 0 writes clock64() at phase i
// of step s < TRACE_STEPS to trace[s * 16 + i] (consumer thread 0: 0 step
// start, 1 first slot landed, 2 product done, 3 gate math done, 4 flag
// published, 5 backward gate gradients done; producer lane 0: 8 first
// slot's owners seen, 9 the first run of slots issued, 10 the last slot
// issued), and clock64() / %globaltimer after its set-up, at its end and
// at its entry to trace[TRACE_STEPS * 16 + 0..5].
constexpr int TRACE_STEPS = 32;

__device__ __forceinline__ void trace(const Chain& c, int s, int i) {
  if (c.trace != nullptr && blockIdx.x == 0 && s < TRACE_STEPS)
    c.trace[s * 16 + i] = clock64();
}

// Per slot of step TRACE_BOX_STEP (slot < 64): landed (consumer thread 0)
// and issued (producer lane 0), to trace[TRACE_STEPS * 16 + 6 + i * 64 +
// slot].
constexpr int TRACE_BOX_STEP = 8;
__device__ __forceinline__ void trace_box(const Chain& c, int s, int box,
                                          int i, long long v) {
  if (c.trace != nullptr && blockIdx.x == 0 && s == TRACE_BOX_STEP &&
      box < 64)
    c.trace[TRACE_STEPS * 16 + 6 + i * 64 + box] = v;
}

__device__ __forceinline__ void trace_clock(const Chain& c, int i) {
  if (c.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    c.trace[TRACE_STEPS * 16 + 2 * i] = clock64();
    c.trace[TRACE_STEPS * 16 + 2 * i + 1] = ns;
  }
}

// Byte offset of element (n, k) of the K-major swizzled B operand with nc
// rows per 64-column panel.
__device__ __forceinline__ int ws_off(int n, int k, int nc) {
  return (k / 64) * nc * 128 + n * 128 + ((((k % 64) / 8) ^ (n % 8)) * 16) +
         (k % 8) * 2;
}

// Loads of what the gate math reads besides the product, issued where
// they stand: as volatile asm the compiler does not sink them past the
// product's waits (plain loads of const data it may, and their latency
// then lands on the serial chain).
__device__ __forceinline__ float ld(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// The B operand into shared memory, once per launch: `count` 16-byte
// vectors, vector e from load(e) to store(e, v), eight loads in flight per
// thread (one at a time, their latency would add up to tens of us).
template <class Load, class Store>
__device__ __forceinline__ void stage_b(int count, Load load, Store store) {
  constexpr int V = 8;
  for (int e0 = threadIdx.x; e0 < count; e0 += V * blockDim.x) {
    uint4 v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int e = e0 + i * blockDim.x;
      v[i] = e < count ? load(e) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int e = e0 + i * blockDim.x;
      if (e < count) store(e, v[i]);
    }
  }
}

// Dynamic shared memory: 1 KB of alignment, the B operand (64-column
// panels of the staged rows' width `kdim`, rounded up to whole slots), the
// ring of `stages` slots of nb chunks per warpgroup.
inline size_t smem_bytes(int kdim, int nc, int wg, int stages, int nb) {
  return 1024 +
         static_cast<size_t>(((kdim + 63) / 64 + nb - 1) / nb * nb) * nc *
             128 +
         static_cast<size_t>(stages) * nb * wg * BOX;
}

__device__ __forceinline__ void consumers_sync(int wg) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(wg * 128) : "memory");
}

// Block i's flag is flags[i * FLAG_STRIDE]: one 128-byte line each, so that
// a block's release does not disturb the lines the others poll.
constexpr int FLAG_STRIDE = 32;
__device__ __forceinline__ int* flag_of(int* flags, int block) {
  return flags + block * FLAG_STRIDE;
}

__device__ __forceinline__ int flag_relaxed(const int* flag) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(flag) : "memory");
  return v;
}

// The consumers' rows of this step are stored: publish `value` for the
// block (its flag) with a release after the consumers' barrier, so that
// every consumer's stores are ordered before it.
__device__ __forceinline__ void publish(int* flag, int value, int wg) {
  srnn::sm90::fence_proxy_async_global();
  consumers_sync(wg);
  if (threadIdx.x == 0) srnn::sm90::flag_release(flag, value);
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// Owners [0, x) hold every column of chunk ch: columns [64 ch, 64 ch + 64)
// of the staged rows, column col belonging to unit (col % hdim) / units
// (a chunk across a gate boundary takes every owner).
__device__ __forceinline__ int chunk_owners(const Chain& c, int ch) {
  const int c0 = ch * 64, c1 = min(c0 + 64, c.kdim);
  if (c0 / c.hdim != (c1 - 1) / c.hdim) return c.owners;
  return ((c1 - 1) % c.hdim) / c.units + 1;
}

// The producer warp: every slot of every step in the consumers' order
// (steps, row passes, slots of nb 64-column chunks): per warpgroup a 3-D
// box (chunk, rows, slice t) of the map [T, B, kdim] (nb = 1), or a 4-D box
// of nb chunks of the map [T, chunks, B, 64] (nb = 8); slice t = s
// forward, n-1-s backward.  A slot of step s is issued once the blocks
// owning its columns (and the owners before them) have published flag >=
// s + 1: the warp polls every owner of its row group not yet seen at once
// (relaxed loads, then one fence), `front` is the first owner still behind,
// and lane 0 issues every slot that front covers in one run.
template <int WG>
__device__ void producer(const CUtensorMap* map, const Chain& c,
                         const int* flags, bool reverse, uint8_t* ring,
                         uint64_t* full, uint64_t* empty) {
  using namespace srnn::sm90;
  const int lane = threadIdx.x % 32;
  const int rg = blockIdx.x / c.owners;
  const int* fl = flags + rg * c.owners * FLAG_STRIDE;
  const int passes = c.rows / (64 * WG);
  const int slots = (c.kch + c.nb - 1) / c.nb;
  const int bytes = c.nb * WG * BOX;
  // owners [0, x) hold every column of slot q
  auto need = [&](int q) {
    return chunk_owners(c, min(q * c.nb + c.nb, c.kch) - 1);
  };
  int seen[MAX_OWNERS / 32];
#pragma unroll
  for (int j = 0; j < MAX_OWNERS / 32; ++j) seen[j] = 0;
  int it = 0;
  for (int s = 0; s < c.n; ++s) {
    const int t = reverse ? c.n - 1 - s : s;
    int front = 0;                 // owners [0, front) have published step s
    for (int p = 0; p < passes; ++p) {
      const int r = rg * c.rows + p * 64 * WG;
      int q = 0;
      while (q < slots) {
        if (need(q) > front) {
          const long long t0 = clock64();
          do {
            int first = c.owners;
#pragma unroll
            for (int j = 0; j < MAX_OWNERS / 32; ++j) {
              const int o = lane + 32 * j;
              if (o < c.owners && seen[j] <= s) {
                seen[j] = flag_relaxed(fl + o * FLAG_STRIDE);
                if (seen[j] <= s) first = min(first, o);
              }
            }
            front = __reduce_min_sync(0xffffffffu, first);
            if (clock64() - t0 > WAIT_LIMIT) __trap();
          } while (need(q) > front);
          fence_acq_rel();         // the owners' rows before this warp's reads
          __syncwarp();
          // what the warp's reads saw, before the copies (async proxy)
          if (lane == 0) fence_proxy_async_global();
        }
        int last = q + 1;
        while (last < slots && need(last) <= front) ++last;
        if (lane == 0) {
          if (p == 0 && q == 0) trace(c, s, 8);
          for (int k = q; k < last; ++k) {
            const int i = it + k - q, slot = i % c.stages;
            if (i >= c.stages)
              mbar_wait_bounded(&empty[slot], (i / c.stages - 1) & 1);
            mbar_expect_tx(&full[slot], bytes);
            for (int w = 0; w < WG; ++w) {
              uint8_t* dst = ring + (slot * WG + w) * c.nb * BOX;
              if (c.nb == 1)
                tma_box3(dst, map, k * 64, r + 64 * w, t, &full[slot]);
              else
                tma_box4(dst, map, 0, r + 64 * w, k * c.nb, t, &full[slot]);
            }
            trace_box(c, s, k, 1, clock64());
          }
          if (p == 0 && q == 0) trace(c, s, 9);
          if (p == passes - 1 && last == slots) trace(c, s, 10);
        }
        __syncwarp();
        it += last - q;
        q = last;
      }
    }
  }
}

// The barriers of a chain kernel, by thread 0 before the block barrier:
// a slot's full barrier takes the producer's arrival (and the copy's
// bytes), its empty barrier one arrival per consumer warpgroup.
__device__ __forceinline__ void init_barriers(const Chain& c, uint64_t* full,
                                              uint64_t* empty, int wg) {
  using namespace srnn::sm90;
  if (threadIdx.x == 0)
    for (int s = 0; s < c.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], wg);
    }
}

// One ring slot into the accumulators: slot `it` holds chunks ch0 ..
// ch0 + NB - 1 of this warpgroup's 64 rows; k16 step k of chunk ch0 + q
// adds into accumulator (4 q + k) % NACC; the slot of LAG slots ago is
// freed once its batch has retired.
template <int NC, int WG, int NB, int NACC, int LAG>
__device__ __forceinline__ void product_slot(float (&part)[NACC][NC / 2],
                                             int ch0, int& it, int it0,
                                             const Chain& c, int s,
                                             uint32_t ring_u, uint32_t ws_u,
                                             uint64_t* full,
                                             uint64_t* empty) {
  using namespace srnn::sm90;
  const int slot = it % c.stages, wg = threadIdx.x / 128;
  mbar_wait_bounded(&full[slot], (it / c.stages) & 1);
  if (it == it0 && threadIdx.x == 0) trace(c, s, 1);
  if (threadIdx.x == 0) trace_box(c, s, it - it0, 0, clock64());
  wgmma_fence();
  const uint32_t a0 = ring_u + (slot * WG + wg) * NB * BOX;
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma<NC, 0, 0>(part[(4 * q + k) % NACC],
                      desc(a0 + q * BOX + k * 32, 16, 1024, 1),
                      desc(ws_u + (ch0 + q) * NC * 128 + k * 32, 16, 1024, 1),
                      1);
  wgmma_commit();
  wgmma_wait<LAG>();               // slot it - LAG's batch has retired
  if (it - it0 >= LAG && threadIdx.x % 128 == 0)
    mbar_arrive(&empty[(it - LAG) % c.stages]);
  ++it;
}

// acc = this warpgroup's 64 staged rows (the next slots of the ring, `it`
// counting slots) @ the B operand at ws_u, float32 sums in a fixed order:
// NACC accumulators taken in turn by the k16 steps, added in order at the
// end.  NB = 1: a slot per chunk, two slots in flight; NB = 8: one.
template <int NC, int WG, int NB>
__device__ __forceinline__ void product(float (&acc)[NC / 2], int& it,
                                        const Chain& c, int s,
                                        uint32_t ring_u, uint32_t ws_u,
                                        uint64_t* full, uint64_t* empty) {
  using namespace srnn::sm90;
  constexpr int NACC = nacc(NC), LAG = NB > 1 ? 1 : 2;
  const int it0 = it;
  float part[NACC][NC / 2];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) part[a][i] = 0.f;
  for (int ch = 0; ch < c.kch; ch += NB)
    product_slot<NC, WG, NB, NACC, LAG>(part, ch, it, it0, c, s, ring_u,
                                        ws_u, full, empty);
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < NACC; ++a) fence_regs(part[a]);
  if (threadIdx.x % 128 == 0)
    for (int i = max(it0, it - LAG); i < it; ++i)
      mbar_arrive(&empty[i % c.stages]);
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    float v = part[0][i];
#pragma unroll
    for (int a = 1; a < NACC; ++a) v += part[a][i];
    acc[i] = v;
  }
}

// A consumer thread's place in the accumulator layout of m64nN: rows
// row(0) and row(1) of its warpgroup's 64, and for each 8-column group i
// the columns 8i + lane2 and 8i + lane2 + 1 (acc[4i + 2 rs + e]).
struct Place {
  int wg, r, lane2;
  __device__ Place()
      : wg(threadIdx.x / 128),
        r(threadIdx.x % 128 / 32 * 16 + threadIdx.x % 32 / 4),
        lane2(2 * (threadIdx.x % 4)) {}
  __device__ int row(int rs) const { return wg * 64 + r + 8 * rs; }
};

// The block's bias sums, per unit, in a fixed order: sums[uh][e][4] of
// each consumer thread (unit 8 uh + lane2 + e) through shared memory `part`,
// thread u < units adding unit u's over the threads in order; then, with
// several row groups, the groups' in order through bpart [row_groups, 4,
// hdim] after each group's flag reads done_flag.  Calls
// out(j, a[4]) for unit j of the block, in the first row group.
template <int UN, int WG, class Out>
__device__ void bias_sums(const float (&sums)[UN / 8][2][4], float* part,
                          float* __restrict__ bpart, int* flags,
                          const Chain& c, int done_flag, Out out) {
  constexpr int SLOTS = UN / 4;
  const int th = threadIdx.x;
  consumers_sync(WG);                       // B operand no longer read
#pragma unroll
  for (int uh = 0; uh < UN / 8; ++uh)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        part[(th * SLOTS + uh * 2 + e) * 4 + q] = sums[uh][e][q];
  consumers_sync(WG);
  const int ug = blockIdx.x % c.owners, rg = blockIdx.x / c.owners;
  const int row_groups = (c.b + c.rows - 1) / c.rows;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if (th < UN) {
    const int slot = (th / 8) * 2 + th % 2, l4 = (th % 8) / 2;
    for (int t2 = l4; t2 < WG * 128; t2 += 4)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] += part[(t2 * SLOTS + slot) * 4 + q];
  }
  const int j = ug * UN + th;
  if (row_groups == 1) {
    if (th < UN) out(j, a);
    return;
  }
  if (th < UN)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bpart[(static_cast<int64_t>(rg) * 4 + q) * c.hdim + j] = a[q];
  publish(flag_of(flags, blockIdx.x), done_flag, WG);
  if (rg != 0 || th >= UN) return;
  const long long t0 = clock64();
  for (int g = 1; g < row_groups; ++g)
    while (flag_relaxed(flag_of(flags, g * c.owners + ug)) < done_flag)
      if (clock64() - t0 > WAIT_LIMIT) __trap();
  __threadfence();
  float tot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int g = 0; g < row_groups; ++g)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tot[q] += bpart[(static_cast<int64_t>(g) * 4 + q) * c.hdim + j];
  out(j, tot);
}

// The producer's map over [t_count, b, kdim] bf16 rows (128-byte swizzle):
// nb = 1, 3-D with 64 x 64 boxes; nb > 1 (kdim a multiple of 64), 4-D
// [t_count, kdim / 64, b, 64] with boxes of nb chunks x 64 rows x 64
// columns: one copy per slot.
inline bool rows_map(CUtensorMap* out, const void* p, int t_count, int b,
                     int kdim, int nb) {
  if (reinterpret_cast<uintptr_t>(p) % 16 || kdim % 8 ||
      (nb > 1 && kdim % 64))
    return false;
  const cuuint64_t row = static_cast<cuuint64_t>(kdim) * 2;
  if (nb == 1) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kdim),
                                static_cast<cuuint64_t>(b),
                                static_cast<cuuint64_t>(t_count)};
    const cuuint64_t strides[2] = {row, row * b};
    const cuuint32_t box[3] = {64, 64, 1};
    return srnn::sm90::encode_map(out, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                  3, dims, strides, box, true);
  }
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(b),
                              static_cast<cuuint64_t>(kdim / 64),
                              static_cast<cuuint64_t>(t_count)};
  const cuuint64_t strides[3] = {row, 128, row * b};
  const cuuint32_t box[4] = {64, 64, static_cast<cuuint32_t>(nb), 1};
  return srnn::sm90::encode_map(out, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                dims, strides, box, true);
}

// The plan as the library checks it: 0, or cudaErrorInvalidValue.
inline int check_plan(const Chain& c, int wg) {
  const bool ok = (c.units == 8 || c.units == 16) && (wg == 1 || wg == 2) &&
                  c.hdim % c.units == 0 && c.owners == c.hdim / c.units &&
                  c.owners <= MAX_OWNERS && c.rows > 0 &&
                  c.rows % (64 * wg) == 0 && c.stages >= 2 &&
                  c.stages <= MAX_STAGES && c.kdim % 8 == 0 &&
                  (c.nb == 1 ? c.stages >= 4 : c.nb == 8 && c.kdim % 64 == 0);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

// ------------------------------------------------- cooperative launch --

// 0 when `blocks` blocks of a serial kernel with `smem` bytes of dynamic
// shared memory can all be resident at once (the grid barrier needs it);
// else 1 (shared memory), 2 (co-residency) or a negative cudaError_t.
int chain_fits(const void* kernel, int blocks, size_t smem,
               int threads = THREADS) {
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
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return -static_cast<int>(err);
  return blocks <= per_sm * sms ? 0 : 2;
}

// A cooperative launch of one serial kernel, after the residency check,
// so a grid that cannot all be resident fails instead of deadlocking.
int launch_chain(const void* kernel, int blocks, size_t smem, void** args,
                 cudaStream_t s, int threads = THREADS) {
  const int fits = chain_fits(kernel, blocks, smem, threads);
  if (fits < 0) return -fits;
  if (fits > 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(threads), args, smem, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

namespace tc {

// Launch a bf16 chain after its plan check: cooperative, after the
// residency check (chain_fits), so a grid that cannot all be resident
// fails instead of deadlocking.
inline int launch(const void* kernel, const Chain& c, int wg, int nc,
                  void** args, cudaStream_t s) {
  if (check_plan(c, wg)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = c.owners * ((c.b + c.rows - 1) / c.rows);
  return launch_chain(kernel, blocks,
                      smem_bytes(c.kdim, nc, wg, c.stages, c.nb), args, s,
                      wg * 128 + 32);
}

}  // namespace tc

}  // namespace
