// K5 lstm_sequence: the whole-sequence LSTM of a training step, forward
// and backward, in float32 gate math with products on values rounded to
// the weight type (float32 or bf16) and float32 accumulation.
//
// Replaces samplernn_pase_tpu/ops/pallas/rnn_train.py: _lstm_fwd_call (the
// pallas_call at :325, body _lstm_fwd_kernel) and _lstm_bwd_call (:346,
// body _lstm_bwd_kernel), the custom VJP behind lstm_sequence.  Gates i, f,
// g, o (the cuDNN order):
//   g = (round(x_t) @ Wih + bih) + (round(h_{t-1}) @ Whh + bhh)
//   c_t = s(g_f) * c_{t-1} + s(g_i) * tanh(g_g) ; h_t = s(g_o) * tanh(c_t)
// The Pallas kernels keep both weight matrices, their transposes and the
// float32 dW accumulators resident in VMEM; the design here is K4's
// (gru_sequence.cu; the shared parts are in seq_common.cuh):
//
// forward (srnn_lstm_seq_fwd):
//   1. G = round(X) @ Wih + bih over all N*B rows: one tiled GEMM;
//   2. the serial chain, one cooperative launch: each block owns some
//      hidden units with all four of their gate columns for some rows,
//      keeps that slice of Whh in shared memory, adds round(h_{t-1}) @ Whh
//      + bhh to its columns of G (G becomes the gate pre-activations, kept
//      as the backward pass's one residual: the reference's recompute
//      reads the same rounded operands, so the values are the same),
//      carries c in float32 (c is the block's own, no exchange) and writes
//      h_seq and c_seq rounded.
// backward (srnn_lstm_seq_bwd):
//   1. the serial chain: per step each block forms its units' gate
//      gradients from G, the rounded c_seq (c_{t-1} and c_t read back
//      rounded, as the reference does; c0 is float32) and the carries dh,
//      dc, stores them rounded to the weight type (the reference's
//      rounding point for the products), sums them unrounded for both
//      biases in a fixed order and keeps dc_{t-1} = dc * f in float32;
//      then, after the grid barrier, dh_{t-1} = round(dG_t) @ Whh^T for its
//      units with the matching Whh rows in shared memory;
//   2. dX = round(dG) @ Wih^T, dWih = round(X)^T @ round(dG) and
//      dWhh = round(H_prev)^T @ round(dG): three tiled GEMMs over all N*B
//      rows, each summing over rows in a fixed order (no atomics).
//
// Bound on the H100: operations at the long tiers, bytes at the short
// one.  Config 2 (B=64, H=1024, bf16) does 2 products of 2*B*H*4H per step
// forward and 4 backward: 69.5 / 17.4 / 4.3 us forward and 139.0 / 34.7 /
// 8.7 us backward at N = 64 / 16 / 4 at 989 TFLOP/s; at N=4 the bytes bind
// instead (the weights, G and the stored sequences, about 24 MB forward;
// the float32 dW too backward).  With bf16 weights the GEMMs and chains
// are K4's design (seq_common.cuh): at config 2's B=64 a block of 8 units
// keeps its 64 KB Whh slice and a whole step's boxes (all of h_{t-1} for
// its 64 rows, 128 KB) in shared memory; float32 (the exact path the tests
// hold) runs FMA chains with a grid barrier per step.  The chains are
// bound by their per-step latency, not by the card's rates.

#include "seq_common.cuh"

namespace {

// Forward gate math for row `row`, unit j at step t: a0..a3 = round(h_{t-1})
// @ Whh for gates i, f, g, o.  Turns G's columns into the pre-activations,
// carries c (cfin) and h (hfin) in float32, writes hbuf[t+1] = round(h_t)
// and c_seq[t] = round(c_t).
template <typename WT>
__device__ __forceinline__ void fwd_cell(float* __restrict__ g,
                                         const float* __restrict__ c0,
                                         const float* __restrict__ bhh,
                                         WT* hbuf, WT* __restrict__ cseq,
                                         float* __restrict__ hfin,
                                         float* __restrict__ cfin, float a0,
                                         float a1, float a2, float a3, int t,
                                         int row, int j, int b, int hdim) {
  const int64_t g4 = (static_cast<int64_t>(t) * b + row) * 4 * hdim + j;
  const float gi = g[g4] + (a0 + bhh[j]);
  const float gf = g[g4 + hdim] + (a1 + bhh[hdim + j]);
  const float gg = g[g4 + 2 * hdim] + (a2 + bhh[2 * hdim + j]);
  const float go = g[g4 + 3 * hdim] + (a3 + bhh[3 * hdim + j]);
  const float ig = sigmoidf(gi), fg = sigmoidf(gf), tg = tanhf(gg),
              og = sigmoidf(go);
  const int64_t o = static_cast<int64_t>(row) * hdim + j;
  const float cp = t == 0 ? c0[o] : cfin[o];
  const float cnew = fg * cp + ig * tg;
  const float hnew = og * tanhf(cnew);
  cfin[o] = cnew;
  hfin[o] = hnew;
  const int64_t st = static_cast<int64_t>(t) * b * hdim + o;
  hbuf[st + static_cast<int64_t>(b) * hdim] = from_f32<WT>(hnew);
  cseq[st] = from_f32<WT>(cnew);
  g[g4] = gi;
  g[g4 + hdim] = gf;
  g[g4 + 2 * hdim] = gg;
  g[g4 + 3 * hdim] = go;
}

// Backward, first phase of step t for row `row`, unit j: the gate
// gradients (stored rounded to WT into dg, added unrounded to s[4]) and
// dc_{t-1} = dc * f, left in dc0.  The dh carry is read from dh0 (dh_fin
// at the last step).
template <typename WT>
__device__ __forceinline__ void bwd_cell(
    const float* __restrict__ g, const float* __restrict__ c0,
    const WT* __restrict__ cseq, const WT* __restrict__ dh_seq,
    const float* __restrict__ dh_fin, const float* __restrict__ dc_fin,
    WT* dg, const float* __restrict__ dh0, float* __restrict__ dc0, float* s,
    int t, int row, int j, int n, int b, int hdim) {
  const int64_t o = static_cast<int64_t>(row) * hdim + j;
  const int64_t st = static_cast<int64_t>(t) * b * hdim + o;
  const int64_t g4 = (static_cast<int64_t>(t) * b + row) * 4 * hdim + j;
  const bool last = t == n - 1;
  const float gh = (last ? dh_fin[o] : dh0[o]) + srnn::to_f32(dh_seq[st]);
  const float dcc = last ? dc_fin[o] : dc0[o];
  const float cp = t == 0 ? c0[o]
      : srnn::to_f32(cseq[st - static_cast<int64_t>(b) * hdim]);
  const float ct = srnn::to_f32(cseq[st]);
  const float ig = sigmoidf(g[g4]), fg = sigmoidf(g[g4 + hdim]),
              tg = tanhf(g[g4 + 2 * hdim]), og = sigmoidf(g[g4 + 3 * hdim]);
  const float tc = tanhf(ct);
  const float d_o = gh * tc;
  const float dc = gh * og * (1.f - tc * tc) + dcc;
  const float di = dc * tg, df = dc * cp, dgg = dc * ig;
  const float d0 = di * ig * (1.f - ig);
  const float d1 = df * fg * (1.f - fg);
  const float d2 = dgg * (1.f - tg * tg);
  const float d3 = d_o * og * (1.f - og);
  dg[g4] = from_f32<WT>(d0);
  dg[g4 + hdim] = from_f32<WT>(d1);
  dg[g4 + 2 * hdim] = from_f32<WT>(d2);
  dg[g4 + 3 * hdim] = from_f32<WT>(d3);
  s[0] += d0;
  s[1] += d1;
  s[2] += d2;
  s[3] += d3;
  dc0[o] = dc * fg;
}

// The block's bias sums per unit (unit_sums), the same into both biases:
// g = xg + hg, so both bias paths see the same gate gradients.
__device__ __forceinline__ void bias_sums(const float* part, int hdim,
                                          float* __restrict__ dbih,
                                          float* __restrict__ dbhh) {
  if (threadIdx.x >= U) return;
  float a[4];
  unit_sums(part, a);
  const int j = blockIdx.x * U + threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dbih[q * hdim + j] = a[q];
    dbhh[q * hdim + j] = a[q];
  }
}

// ---- float32: FMA chains (the exact path the tests hold) ----
// Thread (u = tid % 8, rg = tid / 8) owns unit u and rows rg*4 .. rg*4+3
// of each 128-row pass; the staged tile is float32.

__global__ void __launch_bounds__(THREADS)
lstmseq_fwd_chain(float* __restrict__ g, const float* __restrict__ h0,
                  const float* __restrict__ c0, const float* __restrict__ whh,
                  const float* __restrict__ bhh, float* hbuf,
                  float* __restrict__ cseq, float* __restrict__ hfin,
                  float* __restrict__ cfin, int n, int b, int hdim) {
  extern __shared__ __align__(16) float smem[];
  const int kpad = round_up(hdim, KC);
  float* ws = smem;                         // [kpad][4U]: Whh columns
  float* hs = smem + kpad * 4 * U;          // [ROWS][HS]
  const int tid = threadIdx.x, u = tid % U, rg = tid / U;
  const int j = blockIdx.x * U + u;
  for (int e = tid; e < kpad * 4 * U; e += THREADS) {
    const int k = e / (4 * U), c = e % (4 * U);
    ws[e] = k < hdim ? whh[static_cast<int64_t>(k) * 4 * hdim +
                           (c / U) * hdim + blockIdx.x * U + c % U]
                     : 0.f;
  }
  cg::grid_group grid = cg::this_grid();
  round_h0(h0, hbuf, b, hdim, grid);
  Chunk next;
  for (int t = 0; t < n; ++t) {
    const float* src = hbuf + static_cast<int64_t>(t) * b * hdim;
    for (int r0 = 0; r0 < b; r0 += ROWS) {
      float acc[RT][4] = {};
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
            const float* wrow = ws + (k0 + kk + s) * 4 * U;
            const float w0 = wrow[u], w1 = wrow[U + u], w2 = wrow[2 * U + u],
                        w3 = wrow[3 * U + u];
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              const float hvs = s == 0 ? hv[i].x
                              : s == 1 ? hv[i].y
                              : s == 2 ? hv[i].z : hv[i].w;
              acc[i][0] = fmaf(hvs, w0, acc[i][0]);
              acc[i][1] = fmaf(hvs, w1, acc[i][1]);
              acc[i][2] = fmaf(hvs, w2, acc[i][2]);
              acc[i][3] = fmaf(hvs, w3, acc[i][3]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = r0 + rg * RT + i;
        if (row < b)
          fwd_cell(g, c0, bhh, hbuf, cseq, hfin, cfin, acc[i][0], acc[i][1],
                   acc[i][2], acc[i][3], t, row, j, b, hdim);
      }
    }
    __threadfence();
    grid.sync();   // h_t of every unit is in hbuf before step t+1 reads it
  }
}

__global__ void __launch_bounds__(THREADS)
lstmseq_bwd_chain(const float* __restrict__ g, const float* __restrict__ c0,
                  const float* __restrict__ cseq,
                  const float* __restrict__ dh_seq,
                  const float* __restrict__ dh_fin,
                  const float* __restrict__ dc_fin,
                  const float* __restrict__ whh, float* dg,
                  float* __restrict__ dh0, float* __restrict__ dc0,
                  float* __restrict__ dbih, float* __restrict__ dbhh, int n,
                  int b, int hdim) {
  extern __shared__ __align__(16) float smem[];
  const int h4 = 4 * hdim;
  const int kpad = round_up(h4, KC);
  float* ws = smem;                     // [kpad][U]: Whh rows j0..j0+U
  float* hs = smem + kpad * U;          // [ROWS][HS]
  const int tid = threadIdx.x, u = tid % U, rg = tid / U;
  const int j = blockIdx.x * U + u;
  for (int e = tid; e < kpad * U; e += THREADS) {
    const int k = e / U;
    ws[e] = k < h4 ? whh[static_cast<int64_t>(blockIdx.x * U + e % U) * h4 +
                         k]
                   : 0.f;
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
          bwd_cell(g, c0, cseq, dh_seq, dh_fin, dc_fin, dg, dh0, dc0, s, t,
                   row, j, n, b, hdim);
      }
    __threadfence();
    grid.sync();   // dG_t of every unit is written
    const float* src = dg + static_cast<int64_t>(t) * b * h4;
    for (int r0 = 0; r0 < b; r0 += ROWS) {
      float acc[RT] = {};
      next.fetch(src, h4, r0, b, 0, h4);
      for (int k0 = 0; k0 < h4; k0 += KC) {
        next.store(hs);
        __syncthreads();
        if (k0 + KC < h4) next.fetch(src, h4, r0, b, k0 + KC, h4);
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
        if (row < b)   // dh_{t-1} = round(dG_t) @ Whh^T
          dh0[static_cast<int64_t>(row) * hdim + j] = acc[i];
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
// As K4's: a consumer thread holds every gate of its rows' units (gate q of
// unit u is column q * UN + u forward).

// The forward's stores of one cell that no other block waits for: the
// gate pre-activations into g, c_seq (rounded), and the float32 carries.
template <int UH>
__device__ __forceinline__ void lstm_fwd_rest(
    const float (&pre)[4][UH][2][2], const float (&cv)[UH][2][2],
    const float (&hv)[UH][2][2], float* __restrict__ g,
    bf16* __restrict__ cseq, float* __restrict__ hfin,
    float* __restrict__ cfin, int64_t g4, int64_t o, int64_t st, int hdim,
    int uh, int rs, int e) {
#pragma unroll
  for (int q = 0; q < 4; ++q) g[g4 + q * hdim] = pre[q][uh][rs][e];
  cseq[st] = __float2bfloat16_rn(cv[uh][rs][e]);
  hfin[o] = hv[uh][rs][e];
  cfin[o] = cv[uh][rs][e];
}

template <int UN, int WG, int NB>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
lstmseq_fwd_chain_tc(const __grid_constant__ CUtensorMap hmap,
                     const tc::Chain c,
               float* __restrict__ g, const float* __restrict__ h0,
               const float* __restrict__ c0, const bf16* __restrict__ whh,
               const float* __restrict__ bhh, bf16* hbuf,
               bf16* __restrict__ cseq, float* __restrict__ hfin,
               float* __restrict__ cfin, int* flags) {
  using namespace srnn::sm90;
  constexpr int NC = 4 * UN, UH = UN / 8;
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
      4 * UH * kpad,
      [&](int e) {
        const int k = e % kpad, q = e / kpad / UH, uh = e / kpad % UH;
        return k < hdim ? *reinterpret_cast<const uint4*>(
                              whh + static_cast<int64_t>(k) * 4 * hdim +
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
  float bq[4][UH][2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int uh = 0; uh < UH; ++uh)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bq[q][uh][e] = bhh[q * hdim + j0 + 8 * uh + cell.lane2 + e];
  const uint32_t ring_u = smem_u32(ring), ws_u = smem_u32(ws);
  const int passes = c.rows / (64 * WG);
  const int64_t bh = static_cast<int64_t>(b) * hdim;
  int it = 0;
  float acc[NC / 2], pre[4][UH][2][2], cv[UH][2][2], hv[UH][2][2];
  for (int t = 0; t < c.n; ++t) {
    if (threadIdx.x == 0) tc::trace(c, t, 0);
    for (int p = 0; p < passes; ++p) {
      const int pr = row0 + p * 64 * WG;
      // the input pre-activations and c_{t-1}, loaded while the boxes land
      float gv[4][UH][2][2], cp[UH][2][2];
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = pr + cell.row(rs);
            const int j = j0 + 8 * uh + cell.lane2 + e;
            const bool in = row < row_end;
            const int64_t g4 =
                (static_cast<int64_t>(t) * b + row) * 4 * hdim + j;
            const int64_t o = static_cast<int64_t>(row) * hdim + j;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              gv[q][uh][rs][e] = in ? tc::ld(g + g4 + q * hdim) : 0.f;
            cp[uh][rs][e] = !in ? 0.f : tc::ld((t == 0 ? c0 : cfin) + o);
          }
      tc::product<NC, WG, NB>(acc, it, c, t, ring_u, ws_u, full, empty);
      if (threadIdx.x == 0) tc::trace(c, t, 2);
      // every cell's gate math first (independent chains the compiler
      // can interleave), then the stores of the rows in range: h_t, which
      // the other blocks wait for, before the flag; with one pass the
      // rest after it
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              pre[q][uh][rs][e] =
                  gv[q][uh][rs][e] +
                  (acc[4 * (q * UH + uh) + 2 * rs + e] + bq[q][uh][e]);
            const float ig = sigmoidf(pre[0][uh][rs][e]),
                        fg = sigmoidf(pre[1][uh][rs][e]),
                        tg = tanhf(pre[2][uh][rs][e]),
                        og = sigmoidf(pre[3][uh][rs][e]);
            cv[uh][rs][e] = fg * cp[uh][rs][e] + ig * tg;
            hv[uh][rs][e] = og * tanhf(cv[uh][rs][e]);
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
            const int64_t g4 =
                (static_cast<int64_t>(t) * b + row) * 4 * hdim + j;
            const int64_t o = static_cast<int64_t>(row) * hdim + j;
            hbuf[static_cast<int64_t>(t + 1) * bh + o] =
                __float2bfloat16_rn(hv[uh][rs][e]);
            if (passes > 1)
              lstm_fwd_rest<UH>(pre, cv, hv, g, cseq, hfin, cfin, g4, o,
                                t * bh + o, hdim, uh, rs, e);
          }
    }
    if (threadIdx.x == 0) tc::trace(c, t, 3);
    tc::publish(tc::flag_of(flags, blockIdx.x), t + 2, WG);
    if (passes == 1)   // what no other block waits for, after the flag
#pragma unroll
      for (int rs = 0; rs < 2; ++rs)
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = row0 + cell.row(rs);
            if (row >= row_end) continue;
            const int j = j0 + 8 * uh + cell.lane2 + e;
            const int64_t o = static_cast<int64_t>(row) * hdim + j;
            lstm_fwd_rest<UH>(
                pre, cv, hv, g, cseq, hfin, cfin,
                (static_cast<int64_t>(t) * b + row) * 4 * hdim + j, o,
                t * bh + o, hdim, uh, rs, e);
          }
    if (threadIdx.x == 0) tc::trace(c, t, 4);
  }
  tc::trace_clock(c, 1);
}

// The backward gate math's inputs of step t that do not depend on the
// carries, for the rows of the pass at pr: rv = (dh_seq, c_{t-1}, c_t,
// the four gate pre-activations); zero past row_end.
template <int UH>
__device__ __forceinline__ void lstm_bwd_load(
    float (&rv)[7][UH][2][2], const float* __restrict__ g,
    const float* __restrict__ c0, const bf16* __restrict__ cseq,
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
        const int64_t g4 = (static_cast<int64_t>(t) * b + row) * 4 * hdim + j;
        rv[0][uh][rs][e] = ok ? tc::ld(dh_seq + t * bh + o) : 0.f;
        rv[1][uh][rs][e] = !ok ? 0.f : t == 0 ? tc::ld(c0 + o)
                         : tc::ld(cseq + (t - 1) * bh + o);
        rv[2][uh][rs][e] = ok ? tc::ld(cseq + t * bh + o) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          rv[3 + q][uh][rs][e] = ok ? tc::ld(g + g4 + q * hdim) : 0.f;
      }
}

template <int UN, int WG, int NB>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
lstmseq_bwd_chain_tc(const __grid_constant__ CUtensorMap gmap,
                     const tc::Chain c,
               const float* __restrict__ g, const float* __restrict__ c0,
               const bf16* __restrict__ cseq,
               const bf16* __restrict__ dh_seq,
               const float* __restrict__ dh_fin,
               const float* __restrict__ dc_fin,
               const bf16* __restrict__ whh, bf16* dg,
               float* __restrict__ dh0, float* __restrict__ dc0,
               float* __restrict__ dbih, float* __restrict__ dbhh,
               float* bpart, int* flags) {
  using namespace srnn::sm90;
  constexpr int NC = UN, UH = UN / 8;
  __shared__ __align__(8) uint64_t full[tc::MAX_STAGES],
      empty[tc::MAX_STAGES];
  extern __shared__ __align__(128) uint8_t tc_raw[];
  uint8_t* ws = tc_raw + ((1024 - (smem_u32(tc_raw) & 1023)) & 1023);
  const int hdim = c.hdim, b = c.b, h4 = 4 * hdim, kch = c.kpan;
  uint8_t* ring = ws + kch * NC * 128;
  const int j0 = blockIdx.x % c.owners * UN;
  const int row0 = blockIdx.x / c.owners * c.rows;
  const int row_end = min(b, row0 + c.rows);
  tc::trace_clock(c, 2);
  tc::init_barriers(c, full, empty, WG);
  // B: row u is Whh's row j0 + u (4H long), zero past 4H
  tc::stage_b(
      NC * kch * 8,
      [&](int e) {
        const int u = e / (kch * 8), k = (e % (kch * 8)) * 8;
        return k < h4 ? *reinterpret_cast<const uint4*>(
                            whh + static_cast<int64_t>(j0 + u) * h4 + k)
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
  // one row pass (the main paths): the carries stay in registers and the
  // next step's residuals load while this step's product runs
  const bool one = passes == 1;
  float dhc[UH][2][2] = {}, dcc[UH][2][2] = {}, rv[7][UH][2][2];
  float dv[4][UH][2][2], dcn[UH][2][2];
  if (one)
    lstm_bwd_load<UH>(rv, g, c0, cseq, dh_seq, cell, c.n - 1, row0, j0,
                      row_end, b, hdim);
  for (int s = 0; s < c.n; ++s) {
    const int t = c.n - 1 - s;
    if (threadIdx.x == 0) tc::trace(c, s, 0);
    // the gate gradients of step t for the block's rows and units
    for (int p = 0; p < passes; ++p) {
      const int pr = row0 + p * 64 * WG;
      if (!one)
        lstm_bwd_load<UH>(rv, g, c0, cseq, dh_seq, cell, t, pr, j0, row_end,
                          b, hdim);
      // every cell's gate math first, then the stores of the rows in range:
      // dG, which the other blocks wait for, before the flag; with one pass
      // the sums and the dc carry after it
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
            const float hin = !ok ? 0.f : s == 0 ? dh_fin[o]
                            : one ? dhc[uh][rs][e] : dh0[o];
            const float cin = !ok ? 0.f : s == 0 ? dc_fin[o]
                            : one ? dcc[uh][rs][e] : dc0[o];
            const float gh = hin + rv[0][uh][rs][e];
            const float cp = rv[1][uh][rs][e], ct = rv[2][uh][rs][e];
            const float ig = sigmoidf(rv[3][uh][rs][e]),
                        fg = sigmoidf(rv[4][uh][rs][e]),
                        tg = tanhf(rv[5][uh][rs][e]),
                        og = sigmoidf(rv[6][uh][rs][e]);
            const float tc_ = tanhf(ct);
            const float d_o = gh * tc_;
            const float dc = gh * og * (1.f - tc_ * tc_) + cin;
            const float di = dc * tg, df = dc * cp, dgg = dc * ig;
            dv[0][uh][rs][e] = di * ig * (1.f - ig);
            dv[1][uh][rs][e] = df * fg * (1.f - fg);
            dv[2][uh][rs][e] = dgg * (1.f - tg * tg);
            dv[3][uh][rs][e] = d_o * og * (1.f - og);
            dcn[uh][rs][e] = dc * fg;
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
            const int64_t g4 =
                (static_cast<int64_t>(t) * b + row) * h4 + j;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              dg[g4 + q * hdim] = __float2bfloat16_rn(dv[q][uh][rs][e]);
            if (one) continue;
#pragma unroll
            for (int q = 0; q < 4; ++q) sums[uh][e][q] += dv[q][uh][rs][e];
            dc0[o] = dcn[uh][rs][e];
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
            if (row0 + cell.row(rs) >= row_end) continue;
#pragma unroll
            for (int q = 0; q < 4; ++q) sums[uh][e][q] += dv[q][uh][rs][e];
            dcc[uh][rs][e] = dcn[uh][rs][e];
          }
    if (one && t > 0)
      lstm_bwd_load<UH>(rv, g, c0, cseq, dh_seq, cell, t - 1, row0, j0,
                        row_end, b, hdim);
    // dh_{t-1} = round(dG_t) @ Whh^T for the block's units
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
            const float v = acc[4 * uh + 2 * rs + e];
            if (one)
              dhc[uh][rs][e] = v;
            else
              dh0[static_cast<int64_t>(row) * hdim + j0 + 8 * uh +
                  cell.lane2 + e] = v;
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
          const int64_t o = static_cast<int64_t>(row) * hdim + j0 + 8 * uh +
                            cell.lane2 + e;
          if (row < row_end) {
            dh0[o] = dhc[uh][rs][e];
            dc0[o] = dcc[uh][rs][e];
          }
        }
  tc::trace_clock(c, 1);
  tc::bias_sums<UN, WG>(sums, reinterpret_cast<float*>(ws), bpart, flags, c,
                        c.n + 1, [&](int j, const float* a) {
#pragma unroll
                          for (int q = 0; q < 4; ++q) {
                            dbih[q * hdim + j] = a[q];
                            dbhh[q * hdim + j] = a[q];
                          }
                        });
}

// float32 chains: shared memory and kernels
size_t fwd_smem(int hdim) {
  return 4 * (static_cast<size_t>(round_up(hdim, KC)) * 4 * U + ROWS * HS);
}

size_t bwd_smem(int hdim) {
  return 4 * (static_cast<size_t>(round_up(4 * hdim, KC)) * U + ROWS * HS);
}

// bf16 chains: the kernel of a plan (units, warpgroups, chunks per slot)
template <int UN, int WG, int NB>
const void* tc_pick(bool bwd) {
  return bwd ? reinterpret_cast<const void*>(&lstmseq_bwd_chain_tc<UN, WG, NB>)
             : reinterpret_cast<const void*>(&lstmseq_fwd_chain_tc<UN, WG, NB>);
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

unsigned long long* g_trace = nullptr;   // srnn_lstm_seq_trace

tc::Chain chain(int n, int b, int hdim, bool bwd, const int* plan) {
  const int kdim = bwd ? 4 * hdim : hdim, kch = (kdim + 63) / 64;
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
  const int nc = bwd ? plan[0] : 4 * plan[0];
  return chain_fits(tc_kernel(bwd, plan), c.owners,
                    tc::smem_bytes(c.kdim, nc, plan[1], plan[3], c.nb),
                    plan[1] * 128 + 32);
}

int fwd_bf16(const bf16* x, const float* h0, const float* c0,
             const bf16* wih, const float* bih, const bf16* whh,
             const float* bhh, float* g, bf16* hbuf, bf16* cseq, float* hfin,
             float* cfin, int* flags, int n, int b, int hdim,
             const int* plan, cudaStream_t s) {
  int err = gemm<false, false, float>(true, x, hdim, wih, 4 * hdim, bih, g,
                                      4 * hdim, n * b, 4 * hdim, hdim, s);
  if (err) return err;
  const tc::Chain c = chain(n, b, hdim, false, plan);
  CUtensorMap map;
  if (!tc::rows_map(&map, hbuf, n + 1, b, hdim, c.nb))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&map, const_cast<tc::Chain*>(&c), &g, &h0, &c0, &whh,
                  &bhh, &hbuf, &cseq, &hfin, &cfin, &flags};
  return tc::launch(tc_kernel(false, plan), c, plan[1],
                   4 * plan[0], args, s);
}

int bwd_bf16(const bf16* x, const float* c0, const bf16* wih,
             const bf16* whh, const bf16* hbuf, const bf16* cseq,
             const float* g, const bf16* dh_seq, const float* dh_fin,
             const float* dc_fin, bf16* dg, bf16* dx, float* dh0, float* dc0,
             float* dwih, float* dbih, float* dwhh, float* dbhh,
             float* bpart, int* flags, int n, int b, int hdim,
             const int* plan, cudaStream_t s) {
  const int rows = n * b, h4 = 4 * hdim;
  const tc::Chain c = chain(n, b, hdim, true, plan);
  CUtensorMap map;
  if (!tc::rows_map(&map, dg, n, b, h4, c.nb))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&map, const_cast<tc::Chain*>(&c), &g, &c0, &cseq,
                  &dh_seq, &dh_fin, &dc_fin, &whh, &dg, &dh0, &dc0, &dbih,
                  &dbhh, &bpart, &flags};
  int err = tc::launch(tc_kernel(true, plan), c, plan[1], plan[0],
                      args, s);
  if (err) return err;
  // dX [NB, H] = dG [NB, 4H] @ Wih^T (Wih is [H, 4H]: B stored [N, K])
  err = gemm<false, true, bf16>(true, dg, h4, wih, h4, nullptr, dx, hdim,
                                rows, hdim, h4, s);
  if (err) return err;
  // dWih [H, 4H] = X^T @ dG (X is [NB, H]: A stored [K, M])
  err = gemm<true, false, float>(true, x, hdim, dg, h4, nullptr, dwih, h4,
                                 hdim, h4, rows, s);
  if (err) return err;
  // dWhh [H, 4H] = H_prev^T @ dG, H_prev = hbuf[0..N-1] as [NB, H]
  return gemm<true, false, float>(true, hbuf, hdim, dg, h4, nullptr, dwhh,
                                  h4, hdim, h4, rows, s);
}

int fwd_f32(const float* x, const float* h0, const float* c0,
            const float* wih, const float* bih, const float* whh,
            const float* bhh, float* g, float* hbuf, float* cseq,
            float* hfin, float* cfin, int n, int b, int hdim,
            cudaStream_t s) {
  int err = gemm<false, false, float>(false, x, hdim, wih, 4 * hdim, bih, g,
                                      4 * hdim, n * b, 4 * hdim, hdim, s);
  if (err) return err;
  void* args[] = {&g, &h0, &c0, &whh, &bhh, &hbuf, &cseq, &hfin, &cfin,
                  &n, &b, &hdim};
  return launch_chain(reinterpret_cast<const void*>(&lstmseq_fwd_chain),
                      hdim / U, fwd_smem(hdim), args, s);
}

int bwd_f32(const float* x, const float* c0, const float* wih,
            const float* whh, const float* hbuf, const float* cseq,
            const float* g, const float* dh_seq, const float* dh_fin,
            const float* dc_fin, float* dg, float* dx, float* dh0,
            float* dc0, float* dwih, float* dbih, float* dwhh, float* dbhh,
            int n, int b, int hdim, cudaStream_t s) {
  const int rows = n * b, h4 = 4 * hdim;
  void* args[] = {&g, &c0, &cseq, &dh_seq, &dh_fin, &dc_fin, &whh, &dg,
                  &dh0, &dc0, &dbih, &dbhh, &n, &b, &hdim};
  int err = launch_chain(reinterpret_cast<const void*>(&lstmseq_bwd_chain),
                         hdim / U, bwd_smem(hdim), args, s);
  if (err) return err;
  err = gemm<false, true, float>(false, dg, h4, wih, h4, nullptr, dx, hdim,
                                 rows, hdim, h4, s);
  if (err) return err;
  err = gemm<true, false, float>(false, x, hdim, dg, h4, nullptr, dwih, h4,
                                 hdim, h4, rows, s);
  if (err) return err;
  return gemm<true, false, float>(false, hbuf, hdim, dg, h4, nullptr, dwhh,
                                  h4, hdim, h4, rows, s);
}

}  // namespace

// Whether both serial kernels run at width hdim on this device: 0 yes,
// 1 their shared memory exceeds a block's, 2 their blocks cannot all be
// resident, negative a cudaError_t.  bf16: for the chain plan `plan`
// ({units, warpgroups, rows per block, ring slots, chunks per slot};
// ops/kernels/rnn_train.py:
// chain_plan), one row group; float32: dim/8 blocks of the FMA chains.
extern "C" int srnn_lstm_seq_fits(int hdim, int w_bf16, const int* plan) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  if (w_bf16) {
    const int f = tc_fits(hdim, false, plan);
    return f ? f : tc_fits(hdim, true, plan);
  }
  const int f = chain_fits(reinterpret_cast<const void*>(&lstmseq_fwd_chain),
                           hdim / U, fwd_smem(hdim));
  return f ? f : chain_fits(reinterpret_cast<const void*>(&lstmseq_bwd_chain),
                            hdim / U, bwd_smem(hdim));
}

// Forward: x [N*B, H] and the weights in the weight type; h0, c0 [B, H],
// biases [4H] float32.  Writes g [N*B, 4H] float32 (the gate
// pre-activations, the backward pass's residual), hbuf [N+1, B, H] and
// cseq [N, B, H] in the weight type (hbuf[t+1] = h_seq[t], hbuf[0] =
// round(h0)), hfin and cfin [B, H] float32.  bf16: `plan` as
// srnn_lstm_seq_fits's, flags [blocks * 32] int32 zero.  Returns a cudaError_t
// (0 = launched).
extern "C" int srnn_lstm_seq_fwd(const void* x, const float* h0,
                                 const float* c0, const void* wih,
                                 const float* bih, const void* whh,
                                 const float* bhh, float* g, void* hbuf,
                                 void* cseq, float* hfin, float* cfin,
                                 int* flags, int n, int b, int hdim,
                                 int w_bf16, const int* plan, void* stream) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return fwd_bf16(static_cast<const bf16*>(x), h0, c0,
                    static_cast<const bf16*>(wih), bih,
                    static_cast<const bf16*>(whh), bhh, g,
                    static_cast<bf16*>(hbuf), static_cast<bf16*>(cseq), hfin,
                    cfin, flags, n, b, hdim, plan, s);
  return fwd_f32(static_cast<const float*>(x), h0, c0,
                 static_cast<const float*>(wih), bih,
                 static_cast<const float*>(whh), bhh, g,
                 static_cast<float*>(hbuf), static_cast<float*>(cseq), hfin,
                 cfin, n, b, hdim, s);
}

// Backward: the forward's inputs and residuals (x, c0, wih, whh, hbuf,
// cseq, g), dh_seq [N, B, H] in the weight type, dh_fin and dc_fin [B, H]
// float32.  Scratch dg [N*B, 4H] in the weight type; bf16 also bpart [row
// groups, 4, H] float32 and flags [blocks * 32] int32 zero.  Writes dx [N*B, H]
// in the weight type, dh0 and dc0 [B, H], dwih, dwhh [H, 4H] and dbih,
// dbhh [4H], all float32.  Returns a cudaError_t (0 = launched).
extern "C" int srnn_lstm_seq_bwd(const void* x, const float* c0,
                                 const void* wih, const void* whh,
                                 const void* hbuf, const void* cseq,
                                 const float* g, const void* dh_seq,
                                 const float* dh_fin, const float* dc_fin,
                                 void* dg, void* dx, float* dh0, float* dc0,
                                 float* dwih, float* dbih, float* dwhh,
                                 float* dbhh, float* bpart, int* flags, int n,
                                 int b, int hdim, int w_bf16, const int* plan,
                                 void* stream) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return bwd_bf16(
        static_cast<const bf16*>(x), c0, static_cast<const bf16*>(wih),
        static_cast<const bf16*>(whh), static_cast<const bf16*>(hbuf),
        static_cast<const bf16*>(cseq), g, static_cast<const bf16*>(dh_seq),
        dh_fin, dc_fin, static_cast<bf16*>(dg), static_cast<bf16*>(dx), dh0,
        dc0, dwih, dbih, dwhh, dbhh, bpart, flags, n, b, hdim, plan, s);
  return bwd_f32(static_cast<const float*>(x), c0,
                 static_cast<const float*>(wih),
                 static_cast<const float*>(whh),
                 static_cast<const float*>(hbuf),
                 static_cast<const float*>(cseq), g,
                 static_cast<const float*>(dh_seq), dh_fin, dc_fin,
                 static_cast<float*>(dg), static_cast<float*>(dx), dh0, dc0,
                 dwih, dbih, dwhh, dbhh, n, b, hdim, s);
}

// Phase trace of the bf16 chains (scripts/seq_trace.py): a device buffer
// of int64 [tc::TRACE_STEPS * 16 + 4], or null to stop.
extern "C" void srnn_lstm_seq_trace(void* buf) {
  g_trace = static_cast<unsigned long long*>(buf);
}
