// K4 gru_sequence: the whole-sequence GRU of a training step, forward and
// backward, in float32 gate math with products on values rounded to the
// weight type (float32 or bf16) and float32 accumulation.
//
// Replaces samplernn_pase_tpu/ops/pallas/rnn_train.py: _fwd_call (the
// pallas_call at :137, body _fwd_kernel) and _bwd_call (:156, body
// _bwd_kernel), the custom VJP behind gru_sequence.  The Pallas kernels
// keep both weight matrices, their transposes, the [N,B,H] residuals and
// the float32 dW accumulators in VMEM (~117 MB at the flagship's tier 0);
// an H100 SM has 228 KB of shared memory, so the work is split instead:
//
// forward (srnn_gru_seq_fwd):
//   1. XG = round(X) @ Wih + bih over all N*B rows: one tiled GEMM (no
//      time dependence);
//   2. the serial chain, one cooperative launch for the whole sequence:
//      block i owns hidden units [8i, 8i+8) with all three of their gate
//      columns, keeps that [H, 24] slice of Whh in shared memory, reads
//      round(h_{t-1}) for all B rows from L2 in 128-column chunks (the
//      next chunk's loads in flight while it computes on the current one),
//      computes its slice of HG = round(h_{t-1}) @ Whh + bhh and the gates,
//      writes h_t, and meets the other blocks at one grid barrier per step.
//      HG is kept as a residual, so the backward pass needs no recompute
//      product.
// backward (srnn_gru_seq_bwd):
//   1. the serial chain, one cooperative launch: per step each block forms
//      the gate gradients of its units (d_xg, d_hg, stored rounded to the
//      weight type, the reference's rounding point for the products) and
//      their bias sums (unrounded, in a fixed order), meets the others at
//      the grid barrier, then computes its units' carry
//      g*z + round(d_hg) @ Whh^T with the matching Whh rows in shared
//      memory;
//   2. dX = round(d_xg) @ Wih^T, dWih = round(X)^T @ round(d_xg) and
//      dWhh = round(H_prev)^T @ round(d_hg): three tiled GEMMs over all
//      N*B rows, each summing over rows in a fixed order (no atomics), so
//      two runs give the same gradient.
//
// Bound on the H100: operations.  At the flagship's tier 0 (N=64, B=128,
// H=1024) the products are 2 x 51.5 GFLOP forward and 4 x 51.5 backward
// (the Pallas kernel's 6 count the two recompute products this design
// keeps as residuals instead), about 104 us and 208 us at 989 TFLOP/s.
// With bf16 weights every product takes the tensor cores: the GEMMs WMMA
// 16x16x16 on 64x64 tiles, the chains mma.sync m16n8k16 (8 warps of 16
// rows each, the accumulator layout giving each thread all three gates of
// its 2 rows x 2 units).  With float32 weights (the exact path the tests
// hold) the products are float32 FMAs.  The chains are bound by their
// per-step latency (L2 reads of h_{t-1}, the barrier), not by the card's
// rates.  Gate math uses expf/tanhf, not the fast intrinsics.

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

// --------------------------------------------------- serial kernels --

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

// The per-element gate math of the two chains, shared by both forms.
//
// Forward: (ar, az, an) = round(h_{t-1}) @ Whh for row `row`, unit j;
// writes hg, the carried h (hfin) and hbuf[t+1] = round(h_t).
template <typename WT>
__device__ __forceinline__ void fwd_cell(const float* __restrict__ xg,
                                         const float* __restrict__ h0,
                                         const float* __restrict__ bhh,
                                         WT* hbuf, float* __restrict__ hg,
                                         float* __restrict__ hfin, float ar,
                                         float az, float an, int t, int row,
                                         int j, int b, int hdim) {
  const int64_t g3 = (static_cast<int64_t>(t) * b + row) * 3 * hdim;
  const float hr = ar + bhh[j], hz = az + bhh[hdim + j],
              hn = an + bhh[2 * hdim + j];
  const float r = sigmoidf(xg[g3 + j] + hr);
  const float z = sigmoidf(xg[g3 + hdim + j] + hz);
  const float nn = tanhf(xg[g3 + 2 * hdim + j] + r * hn);
  const int64_t o = static_cast<int64_t>(row) * hdim + j;
  const float hp = t == 0 ? h0[o] : hfin[o];
  const float hnew = (1.f - z) * nn + z * hp;
  hfin[o] = hnew;
  hbuf[static_cast<int64_t>(t + 1) * b * hdim + o] = from_f32<WT>(hnew);
  hg[g3 + j] = hr;
  hg[g3 + hdim + j] = hz;
  hg[g3 + 2 * hdim + j] = hn;
}

// Backward, first phase of step t for row `row`, unit j: the gate
// gradients (stored rounded to WT), their bias sums (added to s[4]:
// r, z, xn, hn) and g*z, the first term of the carry, left in dh0.
template <typename WT>
__device__ __forceinline__ void bwd_cell(
    const float* __restrict__ xg, const float* __restrict__ hg,
    const float* __restrict__ h0, const WT* __restrict__ hbuf,
    const WT* __restrict__ dh_seq, const float* __restrict__ dh_fin,
    WT* dxg, WT* dhg, float* __restrict__ dh0, float* s, int t, int row,
    int j, int n, int b, int hdim) {
  const int64_t o = static_cast<int64_t>(row) * hdim + j;
  const int64_t g3 = (static_cast<int64_t>(t) * b + row) * 3 * hdim;
  const float carry = t == n - 1 ? dh_fin[o] : dh0[o];
  const float g =
      carry + srnn::to_f32(dh_seq[static_cast<int64_t>(t) * b * hdim + o]);
  const float hp = t == 0 ? h0[o]
      : srnn::to_f32(hbuf[static_cast<int64_t>(t) * b * hdim + o]);
  const float hr = hg[g3 + j], hz = hg[g3 + hdim + j],
              hn = hg[g3 + 2 * hdim + j];
  const float r = sigmoidf(xg[g3 + j] + hr);
  const float z = sigmoidf(xg[g3 + hdim + j] + hz);
  const float nn = tanhf(xg[g3 + 2 * hdim + j] + r * hn);
  const float dn = g * (1.f - z);
  const float dz = g * (hp - nn);
  const float dtanh = dn * (1.f - nn * nn);
  const float dhn = dtanh * r;
  const float dr = dtanh * hn;
  const float dxr = dr * r * (1.f - r);
  const float dxz = dz * z * (1.f - z);
  dxg[g3 + j] = from_f32<WT>(dxr);
  dxg[g3 + hdim + j] = from_f32<WT>(dxz);
  dxg[g3 + 2 * hdim + j] = from_f32<WT>(dtanh);
  dhg[g3 + j] = from_f32<WT>(dxr);
  dhg[g3 + hdim + j] = from_f32<WT>(dxz);
  dhg[g3 + 2 * hdim + j] = from_f32<WT>(dhn);
  s[0] += dxr;
  s[1] += dxz;
  s[2] += dtanh;
  s[3] += dhn;
  dh0[o] = g * z;
}

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

// The block's bias sums, per unit, over its threads in a fixed order.
// part[THREADS][2][4]: thread th's sums for its units unit_of(th, 0..1)
// (the FMA form owns one unit, th % 8; the mma form two, 2*(th%4) + q).
template <bool MMA>
__device__ __forceinline__ void bias_sums(const float* part, int hdim,
                                          float* __restrict__ dbih,
                                          float* __restrict__ dbhh) {
  if (threadIdx.x >= U) return;
  const int u = threadIdx.x;
  float a[4] = {};
  for (int th = 0; th < THREADS; ++th)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if ((MMA ? 2 * (th % 4) + q : (q == 0 ? th % U : -1)) == u)
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] += part[(th * 2 + q) * 4 + c];
  const int j = blockIdx.x * U + u;
  dbih[j] = a[0];
  dbih[hdim + j] = a[1];
  dbih[2 * hdim + j] = a[2];
  dbhh[j] = a[0];
  dbhh[hdim + j] = a[1];
  dbhh[2 * hdim + j] = a[3];
}

// ---- float32: FMA chains (the exact path the tests hold) ----
// Thread (u = tid % 8, rg = tid / 8) owns unit u and rows rg*4 .. rg*4+3
// of each 128-row pass; the staged h tile is float32.

__global__ void __launch_bounds__(THREADS)
gruseq_fwd_chain(const float* __restrict__ xg, const float* __restrict__ h0,
                 const float* __restrict__ whh, const float* __restrict__ bhh,
                 float* hbuf, float* __restrict__ hg,
                 float* __restrict__ hfin, int n, int b, int hdim) {
  extern __shared__ __align__(16) float smem[];
  const int kpad = round_up(hdim, KC);
  float* ws = smem;                         // [kpad][3U]: Whh columns
  float* hs = smem + kpad * 3 * U;          // [ROWS][HS]
  const int tid = threadIdx.x, u = tid % U, rg = tid / U;
  const int j = blockIdx.x * U + u;
  for (int e = tid; e < kpad * 3 * U; e += THREADS) {
    const int k = e / (3 * U), c = e % (3 * U);
    ws[e] = k < hdim ? whh[k * 3 * hdim + (c / U) * hdim + blockIdx.x * U +
                           c % U]
                     : 0.f;
  }
  cg::grid_group grid = cg::this_grid();
  round_h0(h0, hbuf, b, hdim, grid);
  Chunk<float> next;
  for (int t = 0; t < n; ++t) {
    const float* src = hbuf + static_cast<int64_t>(t) * b * hdim;
    for (int r0 = 0; r0 < b; r0 += ROWS) {
      float acc[RT][3] = {};
      next.fetch(src, hdim, r0, b, 0, hdim);
      for (int k0 = 0; k0 < hdim; k0 += KC) {
        next.store(hs);
        __syncthreads();
        if (k0 + KC < hdim) next.fetch(src, hdim, r0, b, k0 + KC, hdim);
#pragma unroll 2
        for (int kk = 0; kk < KC; kk += 4) {
          float4 hv[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i)
            hv[i] = *reinterpret_cast<const float4*>(hs + (rg * RT + i) * HS +
                                                     kk);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float* wrow = ws + (k0 + kk + s) * 3 * U;
            const float w0 = wrow[u], w1 = wrow[U + u], w2 = wrow[2 * U + u];
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              const float hvs = s == 0 ? hv[i].x
                              : s == 1 ? hv[i].y
                              : s == 2 ? hv[i].z : hv[i].w;
              acc[i][0] = fmaf(hvs, w0, acc[i][0]);
              acc[i][1] = fmaf(hvs, w1, acc[i][1]);
              acc[i][2] = fmaf(hvs, w2, acc[i][2]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = r0 + rg * RT + i;
        if (row < b)
          fwd_cell(xg, h0, bhh, hbuf, hg, hfin, acc[i][0], acc[i][1],
                   acc[i][2], t, row, j, b, hdim);
      }
    }
    __threadfence();
    grid.sync();   // h_t of every unit is in hbuf before step t+1 reads it
  }
}

__global__ void __launch_bounds__(THREADS)
gruseq_bwd_chain(const float* __restrict__ xg, const float* __restrict__ hg,
                 const float* __restrict__ h0, const float* __restrict__ hbuf,
                 const float* __restrict__ dh_seq,
                 const float* __restrict__ dh_fin,
                 const float* __restrict__ whh, float* dxg, float* dhg,
                 float* __restrict__ dh0, float* __restrict__ dbih,
                 float* __restrict__ dbhh, int n, int b, int hdim) {
  extern __shared__ __align__(16) float smem[];
  const int h3 = 3 * hdim;
  const int kpad = round_up(h3, KC);
  float* ws = smem;                     // [kpad][U]: Whh rows j0..j0+U
  float* hs = smem + kpad * U;          // [ROWS][HS]
  const int tid = threadIdx.x, u = tid % U, rg = tid / U;
  const int j = blockIdx.x * U + u;
  for (int e = tid; e < kpad * U; e += THREADS) {
    const int k = e / U;
    ws[e] = k < h3 ? whh[(blockIdx.x * U + e % U) * h3 + k] : 0.f;
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  Chunk<float> next;
  float s[4] = {};
  for (int t = n - 1; t >= 0; --t) {
    for (int r0 = 0; r0 < b; r0 += ROWS)
      for (int i = 0; i < RT; ++i) {
        const int row = r0 + rg * RT + i;
        if (row < b)
          bwd_cell(xg, hg, h0, hbuf, dh_seq, dh_fin, dxg, dhg, dh0, s, t,
                   row, j, n, b, hdim);
      }
    __threadfence();
    grid.sync();   // d_hg[t] of every unit is written
    const float* src = dhg + static_cast<int64_t>(t) * b * h3;
    for (int r0 = 0; r0 < b; r0 += ROWS) {
      float acc[RT] = {};
      next.fetch(src, h3, r0, b, 0, h3);
      for (int k0 = 0; k0 < h3; k0 += KC) {
        next.store(hs);
        __syncthreads();
        if (k0 + KC < h3) next.fetch(src, h3, r0, b, k0 + KC, h3);
#pragma unroll 2
        for (int kk = 0; kk < KC; kk += 4) {
          const float w0 = ws[(k0 + kk) * U + u];
          const float w1 = ws[(k0 + kk + 1) * U + u];
          const float w2 = ws[(k0 + kk + 2) * U + u];
          const float w3 = ws[(k0 + kk + 3) * U + u];
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float4 hv = *reinterpret_cast<const float4*>(
                hs + (rg * RT + i) * HS + kk);
            acc[i] = fmaf(hv.x, w0, acc[i]);
            acc[i] = fmaf(hv.y, w1, acc[i]);
            acc[i] = fmaf(hv.z, w2, acc[i]);
            acc[i] = fmaf(hv.w, w3, acc[i]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = r0 + rg * RT + i;
        if (row < b) {   // carry_prev = g*z + d_hg @ Whh^T
          const int64_t o = static_cast<int64_t>(row) * hdim + j;
          dh0[o] = dh0[o] + acc[i];
        }
      }
    }
  }
  __syncthreads();
  float* part = smem;                   // Whh no longer needed
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    part[(tid * 2) * 4 + c] = s[c];
    part[(tid * 2 + 1) * 4 + c] = 0.f;
  }
  __syncthreads();
  bias_sums<false>(part, hdim, dbih, dbhh);
}

// ---- bf16: tensor-core chains (mma.sync m16n8k16, float32 sums) ----
// Warp w owns rows w*16 .. w*16+15 of each 128-row pass; lane (g =
// lane / 4, tq = lane % 4) holds, in the accumulator layout, rows w*16+g
// and w*16+g+8 of units 2tq and 2tq+1, so the gate math stays in the
// thread.  The staged h tile and the Whh slice are bf16 in shared memory,
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

__global__ void __launch_bounds__(THREADS)
gruseq_fwd_chain_mma(const float* __restrict__ xg,
                     const float* __restrict__ h0,
                     const bf16* __restrict__ whh,
                     const float* __restrict__ bhh, bf16* hbuf,
                     float* __restrict__ hg, float* __restrict__ hfin, int n,
                     int b, int hdim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bld = round_up(hdim, KC) + 8;
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);   // [3U][bld]: gate q unit u
  bf16* as = bs + 3 * U * bld;                     // [ROWS][ALD]
  const int j0 = blockIdx.x * U;
  for (int e = threadIdx.x; e < 3 * U * (bld - 8); e += THREADS) {
    const int k = e / (3 * U), c = e % (3 * U);
    bs[c * bld + k] = k < hdim ? whh[k * 3 * hdim + (c / U) * hdim + j0 +
                                     c % U]
                               : __float2bfloat16_rn(0.f);
  }
  cg::grid_group grid = cg::this_grid();
  round_h0(h0, hbuf, b, hdim, grid);
  Chunk<bf16> next;
  for (int t = 0; t < n; ++t) {
    const bf16* src = hbuf + static_cast<int64_t>(t) * b * hdim;
    for (int r0 = 0; r0 < b; r0 += ROWS) {
      float acc[3][4] = {};
      next.fetch(src, hdim, r0, b, 0, hdim);
      for (int k0 = 0; k0 < hdim; k0 += KC) {
        next.store_raw(as);
        __syncthreads();
        if (k0 + KC < hdim) next.fetch(src, hdim, r0, b, k0 + KC, hdim);
#pragma unroll 4
        for (int kk = 0; kk < KC; kk += 16) {
          uint32_t a[4], bfr[2];
          load_a(a, as, kk);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            load_b(bfr, bs + q * U * bld, bld, k0 + kk);
            mma_bf16(acc[q], a, bfr);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + mma_row(i);
        if (row < b)
          fwd_cell(xg, h0, bhh, hbuf, hg, hfin, acc[0][i], acc[1][i],
                   acc[2][i], t, row, j0 + mma_unit(i), b, hdim);
      }
    }
    __threadfence();
    grid.sync();   // h_t of every unit is in hbuf before step t+1 reads it
  }
}

__global__ void __launch_bounds__(THREADS)
gruseq_bwd_chain_mma(const float* __restrict__ xg,
                     const float* __restrict__ hg,
                     const float* __restrict__ h0,
                     const bf16* __restrict__ hbuf,
                     const bf16* __restrict__ dh_seq,
                     const float* __restrict__ dh_fin,
                     const bf16* __restrict__ whh, bf16* dxg, bf16* dhg,
                     float* __restrict__ dh0, float* __restrict__ dbih,
                     float* __restrict__ dbhh, int n, int b, int hdim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h3 = 3 * hdim;
  const int bld = round_up(h3, KC) + 8;
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);   // [U][bld]: Whh rows
  bf16* as = bs + U * bld;                         // [ROWS][ALD]
  const int j0 = blockIdx.x * U;
  for (int e = threadIdx.x; e < U * (bld - 8); e += THREADS) {
    const int u = e / (bld - 8), k = e % (bld - 8);
    bs[u * bld + k] = k < h3 ? whh[(j0 + u) * h3 + k]
                             : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  Chunk<bf16> next;
  float s[2][4] = {};
  for (int t = n - 1; t >= 0; --t) {
    for (int r0 = 0; r0 < b; r0 += ROWS)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + mma_row(i);
        if (row < b)
          bwd_cell(xg, hg, h0, hbuf, dh_seq, dh_fin, dxg, dhg, dh0, s[i & 1],
                   t, row, j0 + mma_unit(i), n, b, hdim);
      }
    __threadfence();
    grid.sync();   // d_hg[t] of every unit is written
    const bf16* src = dhg + static_cast<int64_t>(t) * b * h3;
    for (int r0 = 0; r0 < b; r0 += ROWS) {
      float acc[4] = {};
      next.fetch(src, h3, r0, b, 0, h3);
      for (int k0 = 0; k0 < h3; k0 += KC) {
        next.store_raw(as);
        __syncthreads();
        if (k0 + KC < h3) next.fetch(src, h3, r0, b, k0 + KC, h3);
#pragma unroll 4
        for (int kk = 0; kk < KC; kk += 16) {
          uint32_t a[4], bfr[2];
          load_a(a, as, kk);
          load_b(bfr, bs, bld, k0 + kk);
          mma_bf16(acc, a, bfr);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + mma_row(i);
        if (row < b) {   // carry_prev = g*z + d_hg @ Whh^T
          const int64_t o = static_cast<int64_t>(row) * hdim + j0 +
                            mma_unit(i);
          dh0[o] = dh0[o] + acc[i];
        }
      }
    }
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem_raw);   // Whh no longer needed
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[(threadIdx.x * 2 + q) * 4 + c] = s[q][c];
  __syncthreads();
  bias_sums<true>(part, hdim, dbih, dbhh);
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
gruseq_gemm_f32(const float* __restrict__ a, int64_t lda,
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
gruseq_gemm_bf16(const bf16* __restrict__ a, int64_t lda,
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
    gruseq_gemm_bf16<AT, BT, OT><<<grid, TTHREADS, 0, s>>>(
        static_cast<const bf16*>(a), lda, static_cast<const bf16*>(b), ldb,
        bias, c, ldc, m, n, k);
  } else {
    const dim3 grid((n + FB - 1) / FB, (m + FB - 1) / FB);
    gruseq_gemm_f32<AT, BT><<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb,
        bias, reinterpret_cast<float*>(c), ldc, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

size_t fwd_smem(int hdim, bool bf) {
  return bf ? 2 * (static_cast<size_t>(3 * U) * (round_up(hdim, KC) + 8) +
                   ROWS * ALD)
            : 4 * (static_cast<size_t>(round_up(hdim, KC)) * 3 * U +
                   ROWS * HS);
}

size_t bwd_smem(int hdim, bool bf) {
  return bf ? 2 * (static_cast<size_t>(U) * (round_up(3 * hdim, KC) + 8) +
                   ROWS * ALD)
            : 4 * (static_cast<size_t>(round_up(3 * hdim, KC)) * U +
                   ROWS * HS);
}

const void* fwd_kernel(bool bf) {
  return bf ? reinterpret_cast<const void*>(&gruseq_fwd_chain_mma)
            : reinterpret_cast<const void*>(&gruseq_fwd_chain);
}

const void* bwd_kernel(bool bf) {
  return bf ? reinterpret_cast<const void*>(&gruseq_bwd_chain_mma)
            : reinterpret_cast<const void*>(&gruseq_bwd_chain);
}

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

template <typename WT>
int seq_fwd(const void* x, const float* h0, const void* wih, const float* bih,
            const void* whh, const float* bhh, float* xg, void* hbuf,
            float* hg, float* hfin, int n, int b, int hdim, cudaStream_t s) {
  const bool bf = std::is_same<WT, bf16>::value;
  const int64_t rows = static_cast<int64_t>(n) * b;
  int err = gemm<false, false, float>(bf, x, hdim, wih, 3 * hdim, bih, xg,
                                      3 * hdim, static_cast<int>(rows),
                                      3 * hdim, hdim, s);
  if (err) return err;
  const WT* w = static_cast<const WT*>(whh);
  WT* hb = static_cast<WT*>(hbuf);
  void* args[] = {&xg, &h0, &w, &bhh, &hb, &hg, &hfin, &n, &b, &hdim};
  return launch_chain(fwd_kernel(bf), hdim / U, fwd_smem(hdim, bf), args, s);
}

template <typename WT>
int seq_bwd(const void* x, const float* h0, const void* wih, const void* whh,
            const void* hbuf, const float* xg, const float* hg,
            const void* dh_seq, const float* dh_fin, void* dxg, void* dhg,
            void* dx, float* dh0, float* dwih, float* dbih, float* dwhh,
            float* dbhh, int n, int b, int hdim, cudaStream_t s) {
  const bool bf = std::is_same<WT, bf16>::value;
  const int rows = n * b;
  const WT* hb = static_cast<const WT*>(hbuf);
  const WT* dhs = static_cast<const WT*>(dh_seq);
  const WT* w = static_cast<const WT*>(whh);
  WT* dxgw = static_cast<WT*>(dxg);
  WT* dhgw = static_cast<WT*>(dhg);
  void* args[] = {&xg, &hg, &h0, &hb, &dhs, &dh_fin, &w, &dxgw, &dhgw,
                  &dh0, &dbih, &dbhh, &n, &b, &hdim};
  int err = launch_chain(bwd_kernel(bf), hdim / U, bwd_smem(hdim, bf), args,
                         s);
  if (err) return err;
  // dX [NB, H] = d_xg [NB, 3H] @ Wih^T (Wih is [H, 3H]: B stored [N, K])
  err = gemm<false, true, WT>(bf, dxg, 3 * hdim, wih, 3 * hdim, nullptr,
                              static_cast<WT*>(dx), hdim, rows, hdim,
                              3 * hdim, s);
  if (err) return err;
  // dWih [H, 3H] = X^T @ d_xg (X is [NB, H]: A stored [K, M])
  err = gemm<true, false, float>(bf, x, hdim, dxg, 3 * hdim, nullptr, dwih,
                                 3 * hdim, hdim, 3 * hdim, rows, s);
  if (err) return err;
  // dWhh [H, 3H] = H_prev^T @ d_hg, H_prev = hbuf[0..N-1] as [NB, H]
  return gemm<true, false, float>(bf, hbuf, hdim, dhg, 3 * hdim, nullptr,
                                  dwhh, 3 * hdim, hdim, 3 * hdim, rows, s);
}

}  // namespace

// Whether both serial kernels run at width hdim on this device: 0 yes,
// 1 their shared memory exceeds a block's, 2 the hdim/8 blocks cannot all
// be resident for the grid barrier, negative a cudaError_t.
extern "C" int srnn_gru_seq_fits(int hdim, int w_bf16) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = w_bf16 != 0;
  const int f = chain_fits(fwd_kernel(bf), hdim / U, fwd_smem(hdim, bf));
  return f ? f : chain_fits(bwd_kernel(bf), hdim / U, bwd_smem(hdim, bf));
}

// Forward: x [N*B, H] and the weights in the weight type; h0 [B, H],
// biases [3H] float32.  Writes xg, hg [N*B, 3H] float32, hbuf [N+1, B, H]
// in the weight type (hbuf[t+1] = h_seq[t], hbuf[0] = round(h0)) and
// hfin [B, H] float32.  Returns a cudaError_t (0 = launched).
extern "C" int srnn_gru_seq_fwd(const void* x, const float* h0,
                                const void* wih, const float* bih,
                                const void* whh, const float* bhh, float* xg,
                                void* hbuf, float* hg, float* hfin, int n,
                                int b, int hdim, int w_bf16, void* stream) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_bf16 ? seq_fwd<bf16>(x, h0, wih, bih, whh, bhh, xg, hbuf, hg, hfin,
                                n, b, hdim, s)
                : seq_fwd<float>(x, h0, wih, bih, whh, bhh, xg, hbuf, hg,
                                 hfin, n, b, hdim, s);
}

// Backward: the forward's inputs and residuals (x, h0, wih, whh, hbuf, xg,
// hg), dh_seq [N, B, H] in the weight type and dh_fin [B, H] float32.
// Scratch dxg, dhg [N*B, 3H] in the weight type.  Writes dx [N*B, H] in
// the weight type, dh0 [B, H], dwih, dwhh [H, 3H] and dbih, dbhh [3H],
// all float32.  Returns a cudaError_t (0 = launched).
extern "C" int srnn_gru_seq_bwd(const void* x, const float* h0,
                                const void* wih, const void* whh,
                                const void* hbuf, const float* xg,
                                const float* hg, const void* dh_seq,
                                const float* dh_fin, void* dxg, void* dhg,
                                void* dx, float* dh0, float* dwih,
                                float* dbih, float* dwhh, float* dbhh, int n,
                                int b, int hdim, int w_bf16, void* stream) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_bf16
      ? seq_bwd<bf16>(x, h0, wih, whh, hbuf, xg, hg, dh_seq, dh_fin, dxg, dhg,
                      dx, dh0, dwih, dbih, dwhh, dbhh, n, b, hdim, s)
      : seq_bwd<float>(x, h0, wih, whh, hbuf, xg, hg, dh_seq, dh_fin, dxg,
                       dhg, dx, dh0, dwih, dbih, dwhh, dbhh, n, b, hdim, s);
}
