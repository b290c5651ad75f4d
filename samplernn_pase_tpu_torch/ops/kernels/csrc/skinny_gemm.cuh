// The skinny GEMM core of K2 (gemm_bias.cu) and K9 (roofline.cu):
//   C = round_bf16(A) @ W,  float32 accumulation,
// then a caller-supplied epilogue on every finished float32 output tile.
// Written for sm_90a (wgmma, thread-block clusters, TMA).
//
// The products it serves are skinny: M = 1-128 rows at decode (3,456 at
// the conditioning projection), N = 256-16,384, K = 4-4,096, W in bf16.
// At M = 128 such a product is bound by W's bytes (0.2-13 us on the H100),
// and a 64x64-tile kernel gives only 2 N/64 blocks, each walking all of K
// with A re-read and re-rounded by every column block.  This core:
//
// * splits K across the CTAs of a thread-block cluster (`split` = 1-8,
//   portable sizes), one K-slice each; the partial tiles are summed
//   through distributed shared memory in rank order 0, 1, .., split-1 by
//   the CTA that owns the rows (row r belongs to rank r % split), which
//   then runs the epilogue: one launch, no atomics, no workspace.  The
//   plan (split, tile width `bn` of 64 or 128, column groups: group g
//   walks tiles g, g + groups, ..) is a function of K, N and the weight
//   type only (ops/kernels/decode.py:gemm_plan), never of M, so a row's
//   result does not depend on the other rows: a B=1 stream and a lane of
//   a B=128 pool add the same partials in the same order;
// * streams W's [64, bn] stages through a ring of STAGES shared-memory
//   slots by TMA (cp.async.bulk.tensor, 128-byte swizzle, zero past K and
//   N, an mbarrier per slot), STAGES - 2 ahead across tile boundaries;
// * brings A's 64-column panels (float32, int32 levels as l/(q/2) - 1, or
//   bf16; all TILE_M rows, zero past M and K) two stages ahead by TMA
//   into staging space, and rounds each to bf16 (round to nearest even,
//   as x.astype(w.dtype)) into its A slot while the stage before it
//   multiplies;
// * multiplies with wgmma.mma_async m64n{bn}k16 bf16 -> f32: two
//   warpgroups, rows [0, 64) and [64, 128) of the row block, one batch of
//   four k16 steps in flight; A K-major and W MN-major (W is [K, N]
//   row-major: the transpose bit), both 128-byte swizzled.
//
// A's rows keep their leading dimension (strided views of the generation
// buffer); rows that are not 16-byte aligned are loaded and converted in
// the stage before the one that uses them, by plain loads.  W rows [0, k_split) come from w0 and [k_split, K)
// from w1 (K9's window head and tail).  A W whose rows are not 16-byte
// multiples (N % 8 != 0) is staged with plain loads.
#pragma once

#include <cooperative_groups.h>

#include "sm90.cuh"

namespace srnn {
namespace skinny {

using namespace sm90;   // TMA, mbarriers, wgmma, tensor maps

// Phase trace, compiled in only with SKINNY_TRACE (scripts/skinny_trace.cu):
// thread 0 of each CTA writes clock64() at phase `i` to g_trace[cta * 64 +
// i] (0 entry, 1 barriers ready, 2 the first A panel in bf16, 10 + j W
// stage j landed, 30 + j A panel j + 1 in bf16, 4 last stage issued, 5
// its wgmma done, 6 the cluster's partials visible, 7 epilogue done, 8
// exit; first tile, j < 16) and %globaltimer at entry (62) and exit (63).
#ifdef SKINNY_TRACE
__device__ unsigned long long* g_trace;
#define SK_TRACE(i)                                                      \
  do {                                                                   \
    if (g_trace && threadIdx.x == 0)                                     \
      g_trace[(blockIdx.y * gridDim.x + blockIdx.x) * 64 + (i)] =        \
          clock64();                                                     \
  } while (0)
#define SK_TIMER(i)                                                      \
  do {                                                                   \
    if (g_trace && threadIdx.x == 0) {                                   \
      unsigned long long ns_;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));           \
      g_trace[(blockIdx.y * gridDim.x + blockIdx.x) * 64 + (i)] = ns_;   \
    }                                                                    \
  } while (0)
#else
#define SK_TRACE(i) do {} while (0)
#define SK_TIMER(i) do {} while (0)
#endif

constexpr int THREADS = 256;   // two warpgroups
constexpr int TILE_M = 128;    // rows per CTA: 64 per warpgroup
constexpr int BK = 64;         // W rows per ring stage
constexpr int SMEM_MAX = 231424;  // dynamic: 227 KB less 1 KB of static

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 64 ? 10 : 6;
  static constexpr int STAGE = BK * BN * 2;          // bytes
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PART_LD = BN + 8;             // floats per partial row
  static constexpr int PART = TILE_M * PART_LD * 4;  // bytes
};

// A panels held in bf16: the stage whose wgmma may still run and the
// current one
constexpr int A_SLOTS = 2;
// A panels staged as loaded (float32 / int32 / bf16), A_AHEAD stages
// ahead; they share their space with the partial tile
constexpr int A_AHEAD = 2;
constexpr int A_STAGED = A_AHEAD * TILE_M * 64 * 4;

// Dynamic shared memory of a CTA: 1 KB to align the swizzle atoms, the W
// ring, A_SLOTS panels of A (TILE_M rows x 64 bf16) and the larger of the
// float32 partial tile and the staged A panels
// (ops/kernels/decode.py:_plan_smem mirrors it).
template <int BN>
constexpr int smem_bytes() {
  return 1024 + Cfg<BN>::RING + A_SLOTS * TILE_M * 128 +
         (Cfg<BN>::PART > A_STAGED ? Cfg<BN>::PART : A_STAGED);
}

enum AMode { A_F32 = 0, A_LEVELS = 1, A_BF16 = 2 };

struct Problem {
  const void* a;
  int64_t lda;
  float q_half;                 // levels: l / q_half - 1
  float q_inv;                  // 1 / q_half where exact, else 0
  const __nv_bfloat16* w0;      // W rows [0, k_split)
  const __nv_bfloat16* w1;      // W rows [k_split, k), row 0 = W row k_split
  int k_split;
  int m, n, k;
  int split, groups;            // the plan
  int a_vec;                    // A through TMA (set by launch)
  int tma;                      // W through TMA (else plain loads)
};

// A level l as float32: l / q_half - 1, the division a multiplication by
// the exact reciprocal where q_half is a power of two (the same result).
__device__ __forceinline__ float dequant(const Problem& p, int l) {
  const float x = static_cast<float>(l);
  return (p.q_inv != 0.f ? x * p.q_inv : x / p.q_half) - 1.f;
}

// Four consecutive A elements (row, k..k+3) as float32, 0 past K.
template <int AMODE>
__device__ __forceinline__ float4 load_a4(const Problem& p, int row, int k) {
  const int64_t at = static_cast<int64_t>(row) * p.lda + k;
  if (p.a_vec && k + 3 < p.k) {
    if (AMODE == A_LEVELS) {
      const int4 v = *reinterpret_cast<const int4*>(
          static_cast<const int32_t*>(p.a) + at);
      return make_float4(dequant(p, v.x), dequant(p, v.y), dequant(p, v.z),
                         dequant(p, v.w));
    } else if (AMODE == A_BF16) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          static_cast<const __nv_bfloat16*>(p.a) + at);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&v.y));
      return make_float4(lo.x, lo.y, hi.x, hi.y);
    } else {
      return *reinterpret_cast<const float4*>(
          static_cast<const float*>(p.a) + at);
    }
  }
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    v[u] = 0.f;
    if (k + u < p.k) {
      if (AMODE == A_LEVELS)
        v[u] = dequant(p, static_cast<const int32_t*>(p.a)[at + u]);
      else if (AMODE == A_BF16)
        v[u] = __bfloat162float(
            static_cast<const __nv_bfloat16*>(p.a)[at + u]);
      else
        v[u] = static_cast<const float*>(p.a)[at + u];
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The core.  Grid: (split * groups, ceil(m / TILE_M)), clusters of `split`
// CTAs along x; CTA x is rank x % split of column group x / split.  Epi
// handles columns col..col+3 of an output row (col a multiple of 4, < n;
// it drops columns >= n itself): `In load(row, col, n)` issues the loads
// of its own inputs, `store(row, col, float4 v, In, n)` finishes them.
//
// Shared memory (128-byte swizzle, atoms of 8 rows x 128 bytes aligned to
// 1024 bytes): a W stage is bn/64 panels of 64 K-rows x 128 bytes, 16-byte
// chunk c of row kk at panel * 8192 + kk * 128 + (c ^ (kk % 8)) * 16 (the
// MN-major operand: 8-row groups 1024 bytes apart, panels 8192); A is
// A_SLOTS panels of TILE_M rows x 128 bytes, chunk c of row m at slot *
// 16384 + m * 128 + (c ^ (m % 8)) * 16 (K-major; a k16 step is 32 bytes
// into the row).
template <int BN, int AMODE, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
skinny_gemm_kernel(const Problem p, const Epi epi,
                   const __grid_constant__ CUtensorMap map0,
                   const __grid_constant__ CUtensorMap map1,
                   const __grid_constant__ CUtensorMap amap) {
  using C = Cfg<BN>;
  constexpr int STAGES = C::STAGES;
  SK_TIMER(62);
  SK_TRACE(0);
  __shared__ __align__(8) uint64_t full[STAGES];   // a W stage has landed
  __shared__ __align__(8) uint64_t afull[A_AHEAD];  // a staged A panel landed
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* a_s = smem + C::RING;
  float* part = reinterpret_cast<float*>(a_s + A_SLOTS * TILE_M * 128);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, wg = tid / 128;
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.x / p.split;
  const int row0 = blockIdx.y * TILE_M;
  const int m_valid = min(TILE_M, p.m - row0);
  const int k16 = (p.k + 15) / 16;
  const int kb = 16 * (rank * k16 / p.split);
  const int ke = 16 * ((rank + 1) * k16 / p.split);
  const int nk = (ke - kb + BK - 1) / BK;          // ring stages per tile
  const int n_tiles = (p.n + BN - 1) / BN;
  const int nt = (n_tiles - g + p.groups - 1) / p.groups;

  // W rows k0 .. k0 + 63 x columns n0 .. n0 + bn - 1 into ring slot
  // `slot`.  TMA: one 64 x 64 box per panel from map0 (rows below
  // k_split) or map1, zero past K and N, counted on full[slot]; rows past
  // the slice meet zero columns of A.  Plain loads (N % 8 != 0): by every
  // thread, zero past the slice, K and N.
  auto load_w = [&](int slot, int k0, int n0) {
    uint8_t* st = ring + slot * C::STAGE;
    if (p.tma) {
      if (tid == 0) {
        mbar_expect_tx(&full[slot], C::STAGE);
        const bool lo = k0 < p.k_split;
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_box(st + q * (BK * 128), lo ? &map0 : &map1, n0 + 64 * q,
                  lo ? k0 : k0 - p.k_split, &full[slot]);
      }
      return;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / 8 / THREADS; ++r) {
      const int f = tid + r * THREADS;
      const int kk = (f / 8) % BK, nc = (f / (8 * BK)) * 8 + f % 8;
      const int gk = k0 + kk, gc = n0 + nc * 8;
      const __nv_bfloat16* src =
          gk < p.k_split ? p.w0 + static_cast<int64_t>(gk) * p.n + gc
                         : p.w1 + static_cast<int64_t>(gk - p.k_split) * p.n +
                               gc;
      uint32_t bits[8];
#pragma unroll
      for (int v = 0; v < 8; ++v)
        bits[v] = gk < ke && gk < p.k && gc + v < p.n
                      ? __bfloat16_as_ushort(src[v]) : 0u;
      *reinterpret_cast<uint4*>(st + (nc / 8) * (BK * 128) + kk * 128 +
                                ((nc % 8) ^ (kk % 8)) * 16) =
          make_uint4(bits[0] | bits[1] << 16, bits[2] | bits[3] << 16,
                     bits[4] | bits[5] << 16, bits[6] | bits[7] << 16);
    }
  };

  // A panel q (slice columns kb + 64q ..) of all TILE_M rows goes to A
  // slot `slot` in bf16 (16 threads per row, four columns each), rows past
  // M and columns past the slice or K zero.  Through TMA (a_vec): A_AHEAD
  // stages ahead, a [TILE_M, 64] box of the raw rows into a staging
  // buffer (zero past M and K), counted on its afull barrier, converted in
  // the stage before the one that uses it; else loaded and converted
  // there.
  constexpr int ELEM = AMODE == A_BF16 ? 2 : 4;
  uint8_t* staged = reinterpret_cast<uint8_t*>(part);
  int a_issued = 0, a_used = 0;                    // staged panels so far
  auto stage_a = [&](int q) {
    if (tid == 0) {
      uint64_t* bar = &afull[a_issued % A_AHEAD];
      mbar_expect_tx(bar, TILE_M * 64 * ELEM);
      tma_box(staged + (a_issued % A_AHEAD) * (TILE_M * 64 * ELEM), &amap,
              kb + 64 * q, row0, bar);
    }
    ++a_issued;
  };
  auto put_a = [&](int q, int slot) {
    const uint8_t* src = staged + (a_used % A_AHEAD) * (TILE_M * 64 * ELEM);
    if (p.a_vec) {
      mbar_wait(&afull[a_used % A_AHEAD], (a_used / A_AHEAD) & 1);
      ++a_used;
    }
#pragma unroll 4
    for (int f = tid; f < TILE_M * 16; f += THREADS) {
      const int row = f / 16, kq = f % 16, k = kb + 64 * q + kq * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!p.a_vec) {
        if (row < m_valid && k < ke) v = load_a4<AMODE>(p, row0 + row, k);
      } else if (k < ke) {         // columns past the slice stay zero
        if (AMODE == A_BF16) {
          const uint2 raw =
              *reinterpret_cast<const uint2*>(src + row * 128 + kq * 8);
          const float2 lo = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          v = make_float4(lo.x, lo.y, hi.x, hi.y);
        } else if (AMODE == A_LEVELS) {
          const int4 l =
              *reinterpret_cast<const int4*>(src + row * 256 + kq * 16);
          if (row < m_valid) {     // zero-filled levels stay 0
            v = make_float4(dequant(p, l.x), dequant(p, l.y),
                            dequant(p, l.z), dequant(p, l.w));
            // columns past K are zero-filled levels too
            if (k + 1 >= p.k) v.y = 0.f;
            if (k + 2 >= p.k) v.z = 0.f;
            if (k + 3 >= p.k) v.w = 0.f;
            if (k >= p.k) v.x = 0.f;
          }
        } else {
          v = *reinterpret_cast<const float4*>(src + row * 256 + kq * 16);
        }
      }
      __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(
          a_s + slot * (TILE_M * 128) + row * 128 +
          ((kq / 2) ^ (row % 8)) * 16 + (kq % 2) * 8);
      d2[0] = __floats2bfloat162_rn(v.x, v.y);
      d2[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  };

  float acc[BN / 2];

  // A tile's epilogue: partials into shared memory, the cluster's sum of
  // this CTA's rows in rank order, the caller's epilogue.
  auto finish_tile = [&](int n0) {
    {
      const int lane = tid % 32, r0 = wg * 64 + (tid % 128) / 32 * 16 +
                                      lane / 4;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = 8 * i + (lane % 4) * 2;
        *reinterpret_cast<float2*>(part + r0 * C::PART_LD + col) =
            make_float2(acc[4 * i], acc[4 * i + 1]);
        *reinterpret_cast<float2*>(part + (r0 + 8) * C::PART_LD + col) =
            make_float2(acc[4 * i + 2], acc[4 * i + 3]);
      }
    }
    cluster_arrive();
    cluster_wait();
    SK_TRACE(6);
    const int my_rows = m_valid > rank ? (m_valid - rank + p.split - 1) /
                                             p.split : 0;
    const int items = my_rows * (BN / 4);
    // U items per thread at a time: every load (the cluster's partials,
    // the epilogue's inputs) issued before the first store; U * split
    // float4 partials in flight bound the registers
    constexpr int U = 2;
    for (int e0 = tid; e0 < items; e0 += U * THREADS) {
      float4 v[U];
      typename Epi::In in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS;
        const int rr = rank + (e / (BN / 4)) * p.split, c4 = (e % (BN / 4)) * 4;
        if (e >= items || n0 + c4 >= p.n) continue;
        // rank 0's partial; a CTA alone reads its own locally: through
        // the cluster window its epilogue takes 1-3 us longer on the H100
        // (scripts/skinny_trace.cu)
        float* mine = part + rr * C::PART_LD + c4;
        v[u] = *reinterpret_cast<const float4*>(
            p.split == 1 ? mine : cluster.map_shared_rank(mine, 0));
#pragma unroll
        for (int s = 1; s < 8; ++s)
          if (s < p.split) {
            const float4 q = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(mine, s));
            v[u].x += q.x;
            v[u].y += q.y;
            v[u].z += q.z;
            v[u].w += q.w;
          }
        in[u] = epi.load(row0 + rr, n0 + c4, p.n);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS;
        const int rr = rank + (e / (BN / 4)) * p.split, c4 = (e % (BN / 4)) * 4;
        if (e >= items || n0 + c4 >= p.n) continue;
        epi.store(row0 + rr, n0 + c4, v[u], in[u], p.n);
      }
    }
    cluster_arrive();               // done reading the cluster's partials
  };

  // W stages in the order the tiles consume them, STAGES - 2 ahead: the
  // slot refilled at stage i is that of stage i - 2, whose wgmma has
  // completed (one wgmma batch stays in flight; the block barrier at the
  // top of stage i orders it before the refill)
  int lt = 0, lj = 0;                              // next stage to load
  auto issue_next = [&](int slot) {
    if (lt < nt) {
      load_w(slot, kb + lj * BK, (g + lt * p.groups) * BN);
      if (++lj == nk) {
        lj = 0;
        ++lt;
      }
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
#pragma unroll
    for (int s = 0; s < A_AHEAD; ++s) mbar_init(&afull[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  SK_TRACE(1);
  for (int s = 0; s < STAGES - 2; ++s) issue_next(s);
  const uint32_t ring_u = smem_u32(ring);
  const uint32_t a_u = smem_u32(a_s) + wg * 64 * 128;
  int slot = 0, phase = 0;
  for (int t = 0; t < nt; ++t) {
    if (t > 0) cluster_wait();   // every CTA has read this one's partials,
                                 // whose space the staged A panels reuse
    if (p.a_vec) {
      fence_proxy_async();         // the partials' reads before the copies
      __syncthreads();
      for (int q = 0; q < A_AHEAD && q < nk; ++q) stage_a(q);
    }
    put_a(0, 0);
    if (t == 0) SK_TRACE(2);
    for (int j = 0; j < nk; ++j) {
      if (p.tma) mbar_wait(&full[slot], phase);
      if (t == 0 && j < 16) SK_TRACE(10 + j);
      fence_proxy_async();
      __syncthreads();   // W stage and A panel j landed; W slot - 2 free
      issue_next(slot >= 2 ? slot - 2 : slot + STAGES - 2);
      if (p.a_vec && j + A_AHEAD < nk) stage_a(j + A_AHEAD);  // j's buffer
      const uint32_t sb = ring_u + slot * C::STAGE;
      if (j > 0) fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) {
        const uint64_t da = desc(a_u + (j % A_SLOTS) * (TILE_M * 128) + s * 32,
                                 16, 1024, 1);
        const uint64_t db = desc(sb + s * 2048, BK * 128, 1024, 1);
        if (s == 0 && j == 0)
          wgmma_zero<BN, 0, 1>(acc, da, db);
        else
          wgmma<BN, 0, 1>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();             // stage j - 1's wgmma done: its A slot
      fence_regs(acc);             // takes panel j + 1 while j's runs
      if (j + 1 < nk) {
        put_a(j + 1, (j + 1) % A_SLOTS);
        if (t == 0 && j < 16) SK_TRACE(30 + j);
      }
      if (++slot == STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }
    if (t == 0) SK_TRACE(4);
    wgmma_wait<0>();
    fence_regs(acc);
    if (t == 0) SK_TRACE(5);
    __syncthreads();   // every staged panel read before the partials
    finish_tile((g + t * p.groups) * BN);
    if (t == 0) SK_TRACE(7);
  }
  cluster_wait();      // no CTA leaves while its partials may be read
  SK_TRACE(8);
  SK_TIMER(63);
}

// W's map: [rows, cols] bf16, 64 x 64 boxes, 128-byte swizzle.
inline bool w_map(CUtensorMap* out, const void* w, int rows, int cols) {
  return tensor_map(out, w, rows, cols, cols, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    2, BK, true);
}

// Launch one product: one kernel, clusters of p.split CTAs (a plain
// launch for split 1).  W goes through TMA where its rows are 16-byte
// multiples and aligned and k_split falls on a ring stage, else through
// plain loads.  `pdl`: launched with programmatic stream serialization,
// so it may start once the kernel before it on the stream has triggered
// (frame_decode.cu); it must then read nothing that kernel writes.
// Returns the CUDA error code (cudaErrorInvalidValue for a plan the core
// cannot run).
template <int BN, int AMODE, class Epi>
int launch(Problem p, const Epi& epi, cudaStream_t stream, bool pdl) {
  const int k16 = (p.k + 15) / 16, n_tiles = (p.n + BN - 1) / BN;
  const int smem = smem_bytes<BN>();
  if (p.m < 1 || p.n < 1 || p.k < 1 || p.split < 1 || p.split > 8 ||
      (p.split & (p.split - 1)) || p.split > k16 || p.groups < 1 ||
      p.groups > n_tiles || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map0 = {}, map1 = {};
  const bool aligned = reinterpret_cast<uintptr_t>(p.w0) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.w1) % 16 == 0;
  // two maps only where every stage starts on a multiple of 64 rows, so
  // that none straddles k_split
  p.tma = p.n % 8 == 0 && aligned &&
          (p.k_split == p.k ||
           (p.k_split % BK == 0 && k16 % (4 * p.split) == 0)) &&
          w_map(&map0, p.w0, p.k_split, p.n) &&
          (p.k_split == p.k || w_map(&map1, p.w1, p.k - p.k_split, p.n));
  if (p.k_split == p.k) map1 = map0;
  // A through TMA where its rows are 16-byte multiples and aligned
  constexpr int ELEM = AMODE == A_BF16 ? 2 : 4;
  CUtensorMap amap = {};
  p.a_vec = reinterpret_cast<uintptr_t>(p.a) % 16 == 0 &&
            p.lda * ELEM % 16 == 0 &&
            tensor_map(&amap, p.a, p.m, p.k, p.lda,
                       AMODE == A_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : AMODE == A_LEVELS ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       ELEM, TILE_M, false);
  auto kernel = skinny_gemm_kernel<BN, AMODE, Epi>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split * p.groups, (p.m + TILE_M - 1) / TILE_M, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int n_attrs = 0;
  if (p.split > 1) {
    attr[n_attrs].id = cudaLaunchAttributeClusterDimension;
    attr[n_attrs].val.clusterDim.x = p.split;
    attr[n_attrs].val.clusterDim.y = 1;
    attr[n_attrs].val.clusterDim.z = 1;
    ++n_attrs;
  }
  if (pdl) {
    attr[n_attrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n_attrs].val.programmaticStreamSerializationAllowed = 1;
    ++n_attrs;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n_attrs;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, p, epi, map0, map1, amap));
}

// Clusters of `split` CTAs the card can hold at once for this kernel and
// shared memory (cudaOccupancyMaxActiveClusters), or -1.
template <int BN, int AMODE, class Epi>
int max_clusters(int split) {
  auto kernel = skinny_gemm_kernel<BN, AMODE, Epi>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * 64, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<BN>();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return -1;
  return n;
}

// Dispatch on the plan's tile width.
template <int AMODE, class Epi>
int run(const Problem& p, int bn, const Epi& epi, cudaStream_t stream,
        bool pdl = false) {
  if (bn == 64) return launch<64, AMODE>(p, epi, stream, pdl);
  if (bn == 128) return launch<128, AMODE>(p, epi, stream, pdl);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace skinny
}  // namespace srnn
