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
//      each block owns some hidden units with all three of their gate
//      columns for some rows, keeps that slice of Whh in shared memory,
//      multiplies round(h_{t-1}) of its rows by it, computes the gates
//      and writes h_t.  HG is kept as a residual, so the backward pass
//      needs no recompute product.
// backward (srnn_gru_seq_bwd):
//   1. the serial chain, one cooperative launch: per step each block forms
//      the gate gradients of its units (d_xg, d_hg, stored rounded to the
//      weight type, the reference's rounding point for the products) and
//      their bias sums (unrounded, in a fixed order), publishes them, then
//      computes its units' carry g*z + round(d_hg) @ Whh^T with the
//      matching Whh rows in shared memory;
//   2. dX = round(d_xg) @ Wih^T, dWih = round(X)^T @ round(d_xg) and
//      dWhh = round(H_prev)^T @ round(d_hg): three tiled GEMMs over all
//      N*B rows, each summing over rows in a fixed order (no atomics), so
//      two runs give the same gradient.
//
// Bound on the H100: operations.  At the flagship's tier 0 (N=64, B=128,
// H=1024) the products are 2 x 51.5 GFLOP forward and 4 x 51.5 backward
// (the Pallas kernel's 6 count the two recompute products this design
// keeps as residuals instead), about 104 us and 208 us at 989 TFLOP/s.
// With bf16 weights (seq_common.cuh) the GEMMs are the TMA-fed wgmma tile
// GEMM (128 x 128 tiles, one producer warp, two consumer warpgroups) and
// the chains wgmma fed by TMA through a ring of 64 x 64 boxes, with
// readiness flags instead of a grid barrier: a block loads a box of step
// t+1 as soon as the blocks that own its columns have published step t.
// The chain's plan (rnn_train.chain_plan) splits the flagship's 128 rows
// over two row groups of 16-unit blocks (64 x 2 = 128 blocks), halving the
// rows each block reads from L2 per step.  The chains are bound by their
// per-step latency (the flag, the boxes' L2 reads, the product and the
// gate math in series), not by the card's rates.  With float32 weights
// (the exact path the tests hold) the products are float32 FMAs and the
// chains meet at a grid barrier per step (8 units per block).  Gate math
// uses expf/tanhf, not the fast intrinsics.

#include "seq_common.cuh"

namespace {

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

// The block's bias sums, per unit (unit_sums), into the r, z, n columns
// of both biases: s = (r, z, xn, hn), the n column of dbih taking xn and
// that of dbhh hn.
__device__ __forceinline__ void bias_sums(const float* part, int hdim,
                                          float* __restrict__ dbih,
                                          float* __restrict__ dbhh) {
  if (threadIdx.x >= U) return;
  float a[4];
  unit_sums(part, a);
  const int j = blockIdx.x * U + threadIdx.x;
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
  Chunk next;
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
  Chunk next;
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
  for (int c = 0; c < 4; ++c) part[tid * 4 + c] = s[c];
  __syncthreads();
  bias_sums(part, hdim, dbih, dbhh);
}

// ---- bf16: wgmma chains fed by TMA (seq_common.cuh, namespace tc) ----
// A consumer thread holds, for each of its rows (cell.row(0), row(1)) and
// units (8 uh + lane2 + e), every gate of the unit: the forward's columns
// are gate-major (gate q of unit u is column q * UN + u, accumulator group
// q * UH + uh).

template <int UN, int WG, int NB>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
gruseq_fwd_chain_tc(const __grid_constant__ CUtensorMap hmap, const tc::Chain c,
              const float* __restrict__ xg, const float* __restrict__ h0,
              const bf16* __restrict__ whh, const float* __restrict__ bhh,
              bf16* hbuf, float* __restrict__ hg, float* __restrict__ hfin,
              int* flags) {
  using namespace srnn::sm90;
  constexpr int NC = 3 * UN, UH = UN / 8;
  __shared__ __align__(8) uint64_t full[tc::MAX_STAGES],
      empty[tc::MAX_STAGES];
  extern __shared__ __align__(128) uint8_t tc_raw[];
  uint8_t* ws = tc_raw + ((1024 - (smem_u32(tc_raw) & 1023)) & 1023);
  const int hdim = c.hdim, b = c.b, kch = c.kpan;
  uint8_t* ring = ws + kch * NC * 128;
  const int j0 = blockIdx.x % c.owners * UN;
  const int row0 = blockIdx.x / c.owners * c.rows;
  const int row_end = min(b, row0 + c.rows);
  tc::trace_clock(c, 2);
  tc::init_barriers(c, full, empty, WG);
  // B: row q * UN + u is Whh's column q * hdim + j0 + u, zero past hdim;
  // 8 units of a gate per 16-byte load, the lanes along k (conflict-free
  // stores)
  const int kpad = kch * 64;
  tc::stage_b(
      3 * UH * kpad,
      [&](int e) {
        const int k = e % kpad, q = e / kpad / UH, uh = e / kpad % UH;
        return k < hdim ? *reinterpret_cast<const uint4*>(
                              whh + static_cast<int64_t>(k) * 3 * hdim +
                              q * hdim + j0 + 8 * uh)
                        : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int e, uint4 raw) {
        const int k = e % kpad, q = e / kpad / UH, uh = e / kpad % UH;
        const bf16* w8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<bf16*>(
              ws + tc::ws_off(q * UN + 8 * uh + i, k, NC)) = w8[i];
      });
  fence_proxy_async();
  __syncthreads();
  if (__shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 4 * WG) {
    tc::producer<WG>(&hmap, c, flags, false, ring, full, empty);
      return;
  }
  const tc::Cell cell;
  tc::trace_clock(c, 0);
  for (int e = threadIdx.x; e < (row_end - row0) * UN; e += WG * 128) {
    const int64_t o =
        static_cast<int64_t>(row0 + e / UN) * hdim + j0 + e % UN;
    hbuf[o] = __float2bfloat16_rn(h0[o]);   // hbuf[0] = round(h0)
  }
  tc::publish(tc::flag_of(flags, blockIdx.x), 1, WG);
  float bq[3][UH][2];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int uh = 0; uh < UH; ++uh)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bq[q][uh][e] = bhh[q * hdim + j0 + 8 * uh + cell.lane2 + e];
  const uint32_t ring_u = smem_u32(ring), ws_u = smem_u32(ws);
  const int passes = c.rows / (64 * WG);
  int it = 0;
  float acc[NC / 2], hv[UH][2][2], hq[3][UH][2][2];
  for (int t = 0; t < c.n; ++t) {
    if (threadIdx.x == 0) tc::trace(c, t, 0);
    for (int p = 0; p < passes; ++p) {
      const int pr = row0 + p * 64 * WG;
      // what the gate math reads besides the product, loaded while the
      // boxes land
      float xv[3][UH][2][2], hp[UH][2][2];
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = pr + cell.row(rs);
            const int j = j0 + 8 * uh + cell.lane2 + e;
            const bool in = row < row_end;
            const int64_t g3 = (static_cast<int64_t>(t) * b + row) * 3 * hdim;
            const int64_t o = static_cast<int64_t>(row) * hdim + j;
#pragma unroll
            for (int q = 0; q < 3; ++q)
              xv[q][uh][rs][e] = in ? tc::ld(xg + g3 + q * hdim + j) : 0.f;
            hp[uh][rs][e] = !in ? 0.f : tc::ld((t == 0 ? h0 : hfin) + o);
          }
      tc::product<NC, WG, NB>(acc, it, c, t, ring_u, ws_u, full, empty);
      if (threadIdx.x == 0) tc::trace(c, t, 2);
      // every cell's gate math first (independent chains the compiler
      // can interleave), then the stores of the rows in range: h_t, which
      // the other blocks wait for, before the flag; with one pass the
      // residuals after it
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float hr = acc[4 * uh + 2 * rs + e] + bq[0][uh][e];
            const float hz = acc[4 * (UH + uh) + 2 * rs + e] + bq[1][uh][e];
            const float hn =
                acc[4 * (2 * UH + uh) + 2 * rs + e] + bq[2][uh][e];
            const float r = sigmoidf(xv[0][uh][rs][e] + hr);
            const float z = sigmoidf(xv[1][uh][rs][e] + hz);
            const float nn = tanhf(xv[2][uh][rs][e] + r * hn);
            hv[uh][rs][e] = (1.f - z) * nn + z * hp[uh][rs][e];
            hq[0][uh][rs][e] = hr;
            hq[1][uh][rs][e] = hz;
            hq[2][uh][rs][e] = hn;
          }
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = pr + cell.row(rs);
            if (row >= row_end) continue;
            const int j = j0 + 8 * uh + cell.lane2 + e;
            const int64_t g3 = (static_cast<int64_t>(t) * b + row) * 3 * hdim;
            const int64_t o = static_cast<int64_t>(row) * hdim + j;
            hbuf[static_cast<int64_t>(t + 1) * b * hdim + o] =
                __float2bfloat16_rn(hv[uh][rs][e]);
            if (passes == 1) continue;
            hfin[o] = hv[uh][rs][e];
#pragma unroll
            for (int q = 0; q < 3; ++q)
              hg[g3 + q * hdim + j] = hq[q][uh][rs][e];
          }
    }
    if (threadIdx.x == 0) tc::trace(c, t, 3);
    tc::publish(tc::flag_of(flags, blockIdx.x), t + 2, WG);
    if (passes == 1)
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = row0 + cell.row(rs);
            if (row >= row_end) continue;
            const int j = j0 + 8 * uh + cell.lane2 + e;
            const int64_t g3 = (static_cast<int64_t>(t) * b + row) * 3 * hdim;
            hfin[static_cast<int64_t>(row) * hdim + j] = hv[uh][rs][e];
#pragma unroll
            for (int q = 0; q < 3; ++q)
              hg[g3 + q * hdim + j] = hq[q][uh][rs][e];
          }
    if (threadIdx.x == 0) tc::trace(c, t, 4);
  }
  tc::trace_clock(c, 1);
}

// The backward's stores and sums of one cell that no other block waits
// for: d_xg (rounded), the bias sums in a fixed order, and g*z into dh0
// (null: the caller keeps it).
template <int UH>
__device__ __forceinline__ void gru_bwd_rest(
    const float (&dv)[4][UH][2][2], const float (&gz)[UH][2][2],
    float (&sums)[UH][2][4], bf16* dxg, float* dh0, int64_t g3, int64_t o,
    int j, int hdim, int uh, int rs, int e) {
  dxg[g3 + j] = __float2bfloat16_rn(dv[0][uh][rs][e]);
  dxg[g3 + hdim + j] = __float2bfloat16_rn(dv[1][uh][rs][e]);
  dxg[g3 + 2 * hdim + j] = __float2bfloat16_rn(dv[2][uh][rs][e]);
#pragma unroll
  for (int q = 0; q < 4; ++q) sums[uh][e][q] += dv[q][uh][rs][e];
  if (dh0) dh0[o] = gz[uh][rs][e];
}

// The backward gate math's inputs of step t that do not depend on the
// carry, for the rows of the pass at pr: rv = (dh_seq, h_{t-1}, xr, xz,
// xn), hgv = (hr, hz, hn); zero past row_end.
template <int UH>
__device__ __forceinline__ void gru_bwd_load(
    float (&rv)[5][UH][2][2], float (&hgv)[3][UH][2][2],
    const float* __restrict__ xg, const float* __restrict__ hg,
    const float* __restrict__ h0, const bf16* __restrict__ hbuf,
    const bf16* __restrict__ dh_seq, const tc::Cell& cell, int t, int pr,
    int j0, int row_end, int b, int hdim) {
  const int64_t bh = static_cast<int64_t>(b) * hdim;
#pragma unroll
  for (int rs = 0; rs < 2; ++rs)
#pragma unroll
    for (int uh = 0; uh < UH; ++uh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = pr + cell.row(rs);
        const int j = j0 + 8 * uh + cell.lane2 + e;
        const bool ok = row < row_end;
        const int64_t o = static_cast<int64_t>(row) * hdim + j;
        const int64_t g3 = (static_cast<int64_t>(t) * b + row) * 3 * hdim;
        rv[0][uh][rs][e] = ok ? tc::ld(dh_seq + t * bh + o) : 0.f;
        rv[1][uh][rs][e] = !ok ? 0.f : t == 0 ? tc::ld(h0 + o)
                         : tc::ld(hbuf + t * bh + o);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          rv[2 + q][uh][rs][e] = ok ? tc::ld(xg + g3 + q * hdim + j) : 0.f;
          hgv[q][uh][rs][e] = ok ? tc::ld(hg + g3 + q * hdim + j) : 0.f;
        }
      }
}

template <int UN, int WG, int NB>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
gruseq_bwd_chain_tc(const __grid_constant__ CUtensorMap gmap, const tc::Chain c,
              const float* __restrict__ xg, const float* __restrict__ hg,
              const float* __restrict__ h0, const bf16* __restrict__ hbuf,
              const bf16* __restrict__ dh_seq,
              const float* __restrict__ dh_fin, const bf16* __restrict__ whh,
              bf16* dxg, bf16* dhg, float* __restrict__ dh0,
              float* __restrict__ dbih, float* __restrict__ dbhh,
              float* bpart, int* flags) {
  using namespace srnn::sm90;
  constexpr int NC = UN, UH = UN / 8;
  __shared__ __align__(8) uint64_t full[tc::MAX_STAGES],
      empty[tc::MAX_STAGES];
  extern __shared__ __align__(128) uint8_t tc_raw[];
  uint8_t* ws = tc_raw + ((1024 - (smem_u32(tc_raw) & 1023)) & 1023);
  const int hdim = c.hdim, b = c.b, h3 = 3 * hdim, kch = c.kpan;
  uint8_t* ring = ws + kch * NC * 128;
  const int j0 = blockIdx.x % c.owners * UN;
  const int row0 = blockIdx.x / c.owners * c.rows;
  const int row_end = min(b, row0 + c.rows);
  tc::trace_clock(c, 2);
  tc::init_barriers(c, full, empty, WG);
  // B: row u is Whh's row j0 + u (3H long), zero past 3H
  tc::stage_b(
      NC * kch * 8,
      [&](int e) {
        const int u = e / (kch * 8), k = (e % (kch * 8)) * 8;
        return k < h3 ? *reinterpret_cast<const uint4*>(
                            whh + static_cast<int64_t>(j0 + u) * h3 + k)
                      : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int e, uint4 raw) {
        *reinterpret_cast<uint4*>(
            ws + tc::ws_off(e / (kch * 8), (e % (kch * 8)) * 8, NC)) = raw;
      });
  fence_proxy_async();
  __syncthreads();
  if (__shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 4 * WG) {
    tc::producer<WG>(&gmap, c, flags, true, ring, full, empty);
      return;
  }
  const tc::Cell cell;
  tc::trace_clock(c, 0);
  const uint32_t ring_u = smem_u32(ring), ws_u = smem_u32(ws);
  const int passes = c.rows / (64 * WG);
  float sums[UH][2][4] = {};
  int it = 0;
  float acc[NC / 2];
  // one row pass (the main paths): the carry stays in registers and the
  // next step's residuals load while this step's product runs
  const bool one = passes == 1;
  float carry[UH][2][2] = {}, rv[5][UH][2][2], hgv[3][UH][2][2];
  float dv[4][UH][2][2], gz[UH][2][2];
  if (one)
    gru_bwd_load<UH>(rv, hgv, xg, hg, h0, hbuf, dh_seq, cell, c.n - 1, row0,
                     j0, row_end, b, hdim);
  for (int s = 0; s < c.n; ++s) {
    const int t = c.n - 1 - s;
    if (threadIdx.x == 0) tc::trace(c, s, 0);
    // the gate gradients of step t for the block's rows and units
    for (int p = 0; p < passes; ++p) {
      const int pr = row0 + p * 64 * WG;
      if (!one)
        gru_bwd_load<UH>(rv, hgv, xg, hg, h0, hbuf, dh_seq, cell, t, pr, j0,
                         row_end, b, hdim);
      // every cell's gate math first, then the stores of the rows in range:
      // d_hg, which the other blocks wait for, before the flag; with one
      // pass the rest after it
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = pr + cell.row(rs);
            const bool ok = row < row_end;
            const int64_t o = static_cast<int64_t>(row) * hdim + j0 + 8 * uh +
                              cell.lane2 + e;
            const float cin = !ok ? 0.f : s == 0 ? dh_fin[o]
                            : one ? carry[uh][rs][e] : dh0[o];
            const float g = cin + rv[0][uh][rs][e];
            const float hp = rv[1][uh][rs][e];
            const float hr = hgv[0][uh][rs][e], hn = hgv[2][uh][rs][e];
            const float r = sigmoidf(rv[2][uh][rs][e] + hr);
            const float z = sigmoidf(rv[3][uh][rs][e] + hgv[1][uh][rs][e]);
            const float nn = tanhf(rv[4][uh][rs][e] + r * hn);
            const float dn = g * (1.f - z);
            const float dz = g * (hp - nn);
            const float dtanh = dn * (1.f - nn * nn);
            const float dr = dtanh * hn;
            dv[0][uh][rs][e] = dr * r * (1.f - r);      // dxr
            dv[1][uh][rs][e] = dz * z * (1.f - z);      // dxz
            dv[2][uh][rs][e] = dtanh;
            dv[3][uh][rs][e] = dtanh * r;               // dhn
            gz[uh][rs][e] = g * z;
          }
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = pr + cell.row(rs);
            if (row >= row_end) continue;
            const int j = j0 + 8 * uh + cell.lane2 + e;
            const int64_t o = static_cast<int64_t>(row) * hdim + j;
            const int64_t g3 = (static_cast<int64_t>(t) * b + row) * h3;
            const float dxr = dv[0][uh][rs][e], dxz = dv[1][uh][rs][e];
            const float dtanh = dv[2][uh][rs][e], dhn = dv[3][uh][rs][e];
            dhg[g3 + j] = __float2bfloat16_rn(dxr);
            dhg[g3 + hdim + j] = __float2bfloat16_rn(dxz);
            dhg[g3 + 2 * hdim + j] = __float2bfloat16_rn(dhn);
            if (one) continue;
            gru_bwd_rest<UH>(dv, gz, sums, dxg, dh0, g3, o, j, hdim, uh, rs,
                             e);
          }
    }
    if (threadIdx.x == 0) tc::trace(c, s, 5);
    tc::publish(tc::flag_of(flags, blockIdx.x), s + 1, WG);
    if (threadIdx.x == 0) tc::trace(c, s, 4);
    if (one)   // what no other block waits for, after the flag
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = row0 + cell.row(rs);
            if (row >= row_end) continue;
            const int j = j0 + 8 * uh + cell.lane2 + e;
            gru_bwd_rest<UH>(dv, gz, sums, dxg, nullptr,
                             (static_cast<int64_t>(t) * b + row) * h3, 0, j,
                             hdim, uh, rs, e);
            carry[uh][rs][e] = gz[uh][rs][e];
          }
    if (one && t > 0)
      gru_bwd_load<UH>(rv, hgv, xg, hg, h0, hbuf, dh_seq, cell, t - 1, row0,
                       j0, row_end, b, hdim);
    // carry_{t-1} = g*z + round(d_hg_t) @ Whh^T for the block's units
    for (int p = 0; p < passes; ++p) {
      const int pr = row0 + p * 64 * WG;
      tc::product<NC, WG, NB>(acc, it, c, s, ring_u, ws_u, full, empty);
      if (threadIdx.x == 0) tc::trace(c, s, 2);
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = pr + cell.row(rs);
            if (row >= row_end) continue;
            const int64_t o = static_cast<int64_t>(row) * hdim + j0 + 8 * uh +
                              cell.lane2 + e;
            const float v = acc[4 * uh + 2 * rs + e];
            if (one)
              carry[uh][rs][e] += v;
            else
              dh0[o] = dh0[o] + v;
          }
    }
  }
  if (one)
#pragma unroll
    for (int rs = 0; rs < 2; ++rs)
#pragma unroll
      for (int uh = 0; uh < UH; ++uh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + cell.row(rs);
          if (row < row_end)
            dh0[static_cast<int64_t>(row) * hdim + j0 + 8 * uh + cell.lane2 +
                e] = carry[uh][rs][e];
        }
  tc::trace_clock(c, 1);
  tc::bias_sums<UN, WG>(sums, reinterpret_cast<float*>(ws), bpart, flags, c,
                        c.n + 1, [&](int j, const float* a) {
                          dbih[j] = a[0];
                          dbih[hdim + j] = a[1];
                          dbih[2 * hdim + j] = a[2];
                          dbhh[j] = a[0];
                          dbhh[hdim + j] = a[1];
                          dbhh[2 * hdim + j] = a[3];
                        });
}

// float32 chains: shared memory and kernels
size_t fwd_smem(int hdim) {
  return 4 * (static_cast<size_t>(round_up(hdim, KC)) * 3 * U + ROWS * HS);
}

size_t bwd_smem(int hdim) {
  return 4 * (static_cast<size_t>(round_up(3 * hdim, KC)) * U + ROWS * HS);
}

// bf16 chains: the kernel of a plan (units, warpgroups, chunks per slot)
template <int UN, int WG, int NB>
const void* tc_pick(bool bwd) {
  return bwd ? reinterpret_cast<const void*>(&gruseq_bwd_chain_tc<UN, WG, NB>)
             : reinterpret_cast<const void*>(&gruseq_fwd_chain_tc<UN, WG, NB>);
}

template <int NB>
const void* tc_kernel_nb(bool bwd, int units, int wg) {
  if (units == 8)
    return wg == 1 ? tc_pick<8, 1, NB>(bwd) : tc_pick<8, 2, NB>(bwd);
  return wg == 1 ? tc_pick<16, 1, NB>(bwd) : tc_pick<16, 2, NB>(bwd);
}

const void* tc_kernel(bool bwd, const int* plan) {
  return plan[4] == 1 ? tc_kernel_nb<1>(bwd, plan[0], plan[1])
                      : tc_kernel_nb<8>(bwd, plan[0], plan[1]);
}

unsigned long long* g_trace = nullptr;   // srnn_gru_seq_trace

tc::Chain chain(int n, int b, int hdim, bool bwd, const int* plan) {
  const int kdim = bwd ? 3 * hdim : hdim, kch = (kdim + 63) / 64;
  const int nb = plan[4] > 0 ? plan[4] : 1;
  return tc::Chain{n, b, hdim, kdim, plan[0], plan[0] ? hdim / plan[0] : 0,
                   plan[2], plan[3], kch, nb, (kch + nb - 1) / nb * nb,
                   g_trace};
}

// plan = {units, warpgroups, rows per block, ring slots, chunks per slot}
int tc_fits(int hdim, bool bwd, const int* plan) {
  const tc::Chain c = chain(1, plan[2], hdim, bwd, plan);
  if (tc::check_plan(c, plan[1]))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = bwd ? plan[0] : 3 * plan[0];
  return chain_fits(tc_kernel(bwd, plan), c.owners,
                    tc::smem_bytes(c.kdim, nc, plan[1], plan[3], c.nb),
                    plan[1] * 128 + 32);
}

int fwd_bf16(const bf16* x, const float* h0, const bf16* wih,
             const float* bih, const bf16* whh, const float* bhh, float* xg,
             bf16* hbuf, float* hg, float* hfin, int* flags, int n, int b,
             int hdim, const int* plan, cudaStream_t s) {
  int err = gemm<false, false, float>(true, x, hdim, wih, 3 * hdim, bih, xg,
                                      3 * hdim, n * b, 3 * hdim, hdim, s);
  if (err) return err;
  const tc::Chain c = chain(n, b, hdim, false, plan);
  CUtensorMap map;
  if (!tc::rows_map(&map, hbuf, n + 1, b, hdim, c.nb))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&map, const_cast<tc::Chain*>(&c), &xg, &h0, &whh, &bhh,
                  &hbuf, &hg, &hfin, &flags};
  return tc::launch(tc_kernel(false, plan), c, plan[1],
                   3 * plan[0], args, s);
}

int bwd_bf16(const bf16* x, const float* h0, const bf16* wih,
             const bf16* whh, const bf16* hbuf, const float* xg,
             const float* hg, const bf16* dh_seq, const float* dh_fin,
             bf16* dxg, bf16* dhg, bf16* dx, float* dh0, float* dwih,
             float* dbih, float* dwhh, float* dbhh, float* bpart, int* flags,
             int n, int b, int hdim, const int* plan, cudaStream_t s) {
  const int rows = n * b, h3 = 3 * hdim;
  const tc::Chain c = chain(n, b, hdim, true, plan);
  CUtensorMap map;
  if (!tc::rows_map(&map, dhg, n, b, h3, c.nb))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&map, const_cast<tc::Chain*>(&c), &xg, &hg, &h0, &hbuf,
                  &dh_seq, &dh_fin, &whh, &dxg, &dhg, &dh0, &dbih, &dbhh,
                  &bpart, &flags};
  int err = tc::launch(tc_kernel(true, plan), c, plan[1], plan[0],
                      args, s);
  if (err) return err;
  // dX [NB, H] = d_xg [NB, 3H] @ Wih^T (Wih is [H, 3H]: B stored [N, K])
  err = gemm<false, true, bf16>(true, dxg, h3, wih, h3, nullptr, dx, hdim,
                                rows, hdim, h3, s);
  if (err) return err;
  // dWih [H, 3H] = X^T @ d_xg (X is [NB, H]: A stored [K, M])
  err = gemm<true, false, float>(true, x, hdim, dxg, h3, nullptr, dwih, h3,
                                 hdim, h3, rows, s);
  if (err) return err;
  // dWhh [H, 3H] = H_prev^T @ d_hg, H_prev = hbuf[0..N-1] as [NB, H]
  return gemm<true, false, float>(true, hbuf, hdim, dhg, h3, nullptr, dwhh,
                                  h3, hdim, h3, rows, s);
}

int fwd_f32(const float* x, const float* h0, const float* wih,
            const float* bih, const float* whh, const float* bhh, float* xg,
            float* hbuf, float* hg, float* hfin, int n, int b, int hdim,
            cudaStream_t s) {
  int err = gemm<false, false, float>(false, x, hdim, wih, 3 * hdim, bih, xg,
                                      3 * hdim, n * b, 3 * hdim, hdim, s);
  if (err) return err;
  void* args[] = {&xg, &h0, &whh, &bhh, &hbuf, &hg, &hfin, &n, &b, &hdim};
  return launch_chain(reinterpret_cast<const void*>(&gruseq_fwd_chain),
                      hdim / U, fwd_smem(hdim), args, s);
}

int bwd_f32(const float* x, const float* h0, const float* wih,
            const float* whh, const float* hbuf, const float* xg,
            const float* hg, const float* dh_seq, const float* dh_fin,
            float* dxg, float* dhg, float* dx, float* dh0, float* dwih,
            float* dbih, float* dwhh, float* dbhh, int n, int b, int hdim,
            cudaStream_t s) {
  const int rows = n * b, h3 = 3 * hdim;
  void* args[] = {&xg, &hg, &h0, &hbuf, &dh_seq, &dh_fin, &whh, &dxg, &dhg,
                  &dh0, &dbih, &dbhh, &n, &b, &hdim};
  int err = launch_chain(reinterpret_cast<const void*>(&gruseq_bwd_chain),
                         hdim / U, bwd_smem(hdim), args, s);
  if (err) return err;
  err = gemm<false, true, float>(false, dxg, h3, wih, h3, nullptr, dx, hdim,
                                 rows, hdim, h3, s);
  if (err) return err;
  err = gemm<true, false, float>(false, x, hdim, dxg, h3, nullptr, dwih, h3,
                                 hdim, h3, rows, s);
  if (err) return err;
  return gemm<true, false, float>(false, hbuf, hdim, dhg, h3, nullptr, dwhh,
                                  h3, hdim, h3, rows, s);
}

}  // namespace

// Whether both serial kernels run at width hdim on this device: 0 yes,
// 1 their shared memory exceeds a block's, 2 their blocks cannot all be
// resident, negative a cudaError_t.  bf16: for the chain plan `plan`
// ({units, warpgroups, rows per block, ring slots, chunks per slot};
// ops/kernels/rnn_train.py:
// chain_plan), one row group; float32: dim/8 blocks of the FMA chains.
extern "C" int srnn_gru_seq_fits(int hdim, int w_bf16, const int* plan) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  if (w_bf16) {
    const int f = tc_fits(hdim, false, plan);
    return f ? f : tc_fits(hdim, true, plan);
  }
  const int f = chain_fits(reinterpret_cast<const void*>(&gruseq_fwd_chain),
                           hdim / U, fwd_smem(hdim));
  return f ? f : chain_fits(reinterpret_cast<const void*>(&gruseq_bwd_chain),
                            hdim / U, bwd_smem(hdim));
}

// Forward: x [N*B, H] and the weights in the weight type; h0 [B, H],
// biases [3H] float32.  Writes xg, hg [N*B, 3H] float32, hbuf [N+1, B, H]
// in the weight type (hbuf[t+1] = h_seq[t], hbuf[0] = round(h0)) and
// hfin [B, H] float32.  bf16: `plan` as srnn_gru_seq_fits's, flags
// [blocks] int32 zero.  Returns a cudaError_t (0 = launched).
extern "C" int srnn_gru_seq_fwd(const void* x, const float* h0,
                                const void* wih, const float* bih,
                                const void* whh, const float* bhh, float* xg,
                                void* hbuf, float* hg, float* hfin,
                                int* flags, int n, int b, int hdim,
                                int w_bf16, const int* plan, void* stream) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return fwd_bf16(static_cast<const bf16*>(x), h0,
                    static_cast<const bf16*>(wih), bih,
                    static_cast<const bf16*>(whh), bhh, xg,
                    static_cast<bf16*>(hbuf), hg, hfin, flags, n, b, hdim,
                    plan, s);
  return fwd_f32(static_cast<const float*>(x), h0,
                 static_cast<const float*>(wih), bih,
                 static_cast<const float*>(whh), bhh, xg,
                 static_cast<float*>(hbuf), hg, hfin, n, b, hdim, s);
}

// Backward: the forward's inputs and residuals (x, h0, wih, whh, hbuf, xg,
// hg), dh_seq [N, B, H] in the weight type and dh_fin [B, H] float32.
// Scratch dxg, dhg [N*B, 3H] in the weight type; bf16 also bpart
// [row groups, 4, H] float32 and flags [blocks * 32] int32 zero.  Writes dx
// [N*B, H] in the weight type, dh0 [B, H], dwih, dwhh [H, 3H] and dbih,
// dbhh [3H], all float32.  Returns a cudaError_t (0 = launched).
extern "C" int srnn_gru_seq_bwd(const void* x, const float* h0,
                                const void* wih, const void* whh,
                                const void* hbuf, const float* xg,
                                const float* hg, const void* dh_seq,
                                const float* dh_fin, void* dxg, void* dhg,
                                void* dx, float* dh0, float* dwih,
                                float* dbih, float* dwhh, float* dbhh,
                                float* bpart, int* flags, int n, int b,
                                int hdim, int w_bf16, const int* plan,
                                void* stream) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return bwd_bf16(
        static_cast<const bf16*>(x), h0, static_cast<const bf16*>(wih),
        static_cast<const bf16*>(whh), static_cast<const bf16*>(hbuf), xg,
        hg, static_cast<const bf16*>(dh_seq), dh_fin,
        static_cast<bf16*>(dxg), static_cast<bf16*>(dhg),
        static_cast<bf16*>(dx), dh0, dwih, dbih, dwhh, dbhh, bpart, flags, n,
        b, hdim, plan, s);
  return bwd_f32(static_cast<const float*>(x), h0,
                 static_cast<const float*>(wih),
                 static_cast<const float*>(whh),
                 static_cast<const float*>(hbuf), xg, hg,
                 static_cast<const float*>(dh_seq), dh_fin,
                 static_cast<float*>(dxg), static_cast<float*>(dhg),
                 static_cast<float*>(dx), dh0, dwih, dbih, dwhh, dbhh, n, b,
                 hdim, s);
}

// Phase trace of the bf16 chains (scripts/seq_trace.py): a device buffer
// of int64 [tc::TRACE_STEPS * 16 + 4], or null to stop.
extern "C" void srnn_gru_seq_trace(void* buf) {
  g_trace = static_cast<unsigned long long*>(buf);
}
