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
//   2. the serial chain, one cooperative launch: block i owns hidden units
//      [8i, 8i+8) with all four of their gate columns, keeps that [H, 32]
//      slice of Whh in shared memory, adds round(h_{t-1}) @ Whh + bhh to
//      its columns of G (G becomes the gate pre-activations, kept as the
//      backward pass's one residual: the reference's recompute reads the
//      same rounded operands, so the values are the same), carries c in
//      float32 (c is the block's own, no exchange), writes h_seq and c_seq
//      rounded, and meets the other blocks at one grid barrier per step.
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
// the float32 dW too backward).  The chains are bound by their per-step
// latency (L2 reads of h_{t-1} or dG_t, the barrier), not by the card's
// rates.
// With bf16 weights the chains run mma.sync m16n8k16 (each thread holds
// all four gates of its 2 rows x 2 units), with float32 weights (the exact
// path the tests hold) float32 FMAs.  Shared memory per block: about
// 64*H + 34,816 bytes in bf16, 128*H + 67,584 in float32; dim/8 blocks
// must be co-resident (srnn_lstm_seq_fits).

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
template <bool MMA>
__device__ __forceinline__ void bias_sums(const float* part, int hdim,
                                          float* __restrict__ dbih,
                                          float* __restrict__ dbhh) {
  if (threadIdx.x >= U) return;
  float a[4];
  unit_sums<MMA>(part, a);
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
  Chunk<float> next;
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
  Chunk<float> next;
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
  for (int c = 0; c < 4; ++c) {
    part[(tid * 2) * 4 + c] = s[c];
    part[(tid * 2 + 1) * 4 + c] = 0.f;
  }
  __syncthreads();
  bias_sums<false>(part, hdim, dbih, dbhh);
}

// ---- bf16: tensor-core chains (seq_common.cuh's mma fragments; each
// thread holds all four gates of its 2 rows x 2 units) ----

__global__ void __launch_bounds__(THREADS)
lstmseq_fwd_chain_mma(float* __restrict__ g, const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const bf16* __restrict__ whh,
                      const float* __restrict__ bhh, bf16* hbuf,
                      bf16* __restrict__ cseq, float* __restrict__ hfin,
                      float* __restrict__ cfin, int n, int b, int hdim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bld = round_up(hdim, KC) + 8;
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);   // [4U][bld]: gate q unit u
  bf16* as = bs + 4 * U * bld;                     // [ROWS][ALD]
  const int j0 = blockIdx.x * U;
  for (int e = threadIdx.x; e < 4 * U * (bld - 8); e += THREADS) {
    const int k = e / (4 * U), c = e % (4 * U);
    bs[c * bld + k] = k < hdim ? whh[static_cast<int64_t>(k) * 4 * hdim +
                                     (c / U) * hdim + j0 + c % U]
                               : __float2bfloat16_rn(0.f);
  }
  cg::grid_group grid = cg::this_grid();
  round_h0(h0, hbuf, b, hdim, grid);
  Chunk<bf16> next;
  for (int t = 0; t < n; ++t) {
    const bf16* src = hbuf + static_cast<int64_t>(t) * b * hdim;
    for (int r0 = 0; r0 < b; r0 += ROWS) {
      float acc[4][4] = {};
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
          for (int q = 0; q < 4; ++q) {
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
          fwd_cell(g, c0, bhh, hbuf, cseq, hfin, cfin, acc[0][i], acc[1][i],
                   acc[2][i], acc[3][i], t, row, j0 + mma_unit(i), b, hdim);
      }
    }
    __threadfence();
    grid.sync();   // h_t of every unit is in hbuf before step t+1 reads it
  }
}

__global__ void __launch_bounds__(THREADS)
lstmseq_bwd_chain_mma(const float* __restrict__ g,
                      const float* __restrict__ c0,
                      const bf16* __restrict__ cseq,
                      const bf16* __restrict__ dh_seq,
                      const float* __restrict__ dh_fin,
                      const float* __restrict__ dc_fin,
                      const bf16* __restrict__ whh, bf16* dg,
                      float* __restrict__ dh0, float* __restrict__ dc0,
                      float* __restrict__ dbih, float* __restrict__ dbhh,
                      int n, int b, int hdim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h4 = 4 * hdim;
  const int bld = round_up(h4, KC) + 8;
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);   // [U][bld]: Whh rows
  bf16* as = bs + U * bld;                         // [ROWS][ALD]
  const int j0 = blockIdx.x * U;
  for (int e = threadIdx.x; e < U * (bld - 8); e += THREADS) {
    const int u = e / (bld - 8), k = e % (bld - 8);
    bs[u * bld + k] = k < h4 ? whh[static_cast<int64_t>(j0 + u) * h4 + k]
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
          bwd_cell(g, c0, cseq, dh_seq, dh_fin, dc_fin, dg, dh0, dc0,
                   s[i & 1], t, row, j0 + mma_unit(i), n, b, hdim);
      }
    __threadfence();
    grid.sync();   // dG_t of every unit is written
    const bf16* src = dg + static_cast<int64_t>(t) * b * h4;
    for (int r0 = 0; r0 < b; r0 += ROWS) {
      float acc[4] = {};
      next.fetch(src, h4, r0, b, 0, h4);
      for (int k0 = 0; k0 < h4; k0 += KC) {
        next.store_raw(as);
        __syncthreads();
        if (k0 + KC < h4) next.fetch(src, h4, r0, b, k0 + KC, h4);
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
        if (row < b)   // dh_{t-1} = round(dG_t) @ Whh^T
          dh0[static_cast<int64_t>(row) * hdim + j0 + mma_unit(i)] = acc[i];
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

size_t fwd_smem(int hdim, bool bf) {
  return bf ? 2 * (static_cast<size_t>(4 * U) * (round_up(hdim, KC) + 8) +
                   ROWS * ALD)
            : 4 * (static_cast<size_t>(round_up(hdim, KC)) * 4 * U +
                   ROWS * HS);
}

size_t bwd_smem(int hdim, bool bf) {
  return bf ? 2 * (static_cast<size_t>(U) * (round_up(4 * hdim, KC) + 8) +
                   ROWS * ALD)
            : 4 * (static_cast<size_t>(round_up(4 * hdim, KC)) * U +
                   ROWS * HS);
}

const void* fwd_kernel(bool bf) {
  return bf ? reinterpret_cast<const void*>(&lstmseq_fwd_chain_mma)
            : reinterpret_cast<const void*>(&lstmseq_fwd_chain);
}

const void* bwd_kernel(bool bf) {
  return bf ? reinterpret_cast<const void*>(&lstmseq_bwd_chain_mma)
            : reinterpret_cast<const void*>(&lstmseq_bwd_chain);
}

template <typename WT>
int seq_fwd(const void* x, const float* h0, const float* c0, const void* wih,
            const float* bih, const void* whh, const float* bhh, float* g,
            void* hbuf, void* cseq, float* hfin, float* cfin, int n, int b,
            int hdim, cudaStream_t s) {
  const bool bf = std::is_same<WT, bf16>::value;
  const int64_t rows = static_cast<int64_t>(n) * b;
  int err = gemm<false, false, float>(bf, x, hdim, wih, 4 * hdim, bih, g,
                                      4 * hdim, static_cast<int>(rows),
                                      4 * hdim, hdim, s);
  if (err) return err;
  const WT* w = static_cast<const WT*>(whh);
  WT* hb = static_cast<WT*>(hbuf);
  WT* cs = static_cast<WT*>(cseq);
  void* args[] = {&g, &h0, &c0, &w, &bhh, &hb, &cs, &hfin, &cfin,
                  &n, &b, &hdim};
  return launch_chain(fwd_kernel(bf), hdim / U, fwd_smem(hdim, bf), args, s);
}

template <typename WT>
int seq_bwd(const void* x, const float* c0, const void* wih, const void* whh,
            const void* hbuf, const void* cseq, const float* g,
            const void* dh_seq, const float* dh_fin, const float* dc_fin,
            void* dg, void* dx, float* dh0, float* dc0, float* dwih,
            float* dbih, float* dwhh, float* dbhh, int n, int b, int hdim,
            cudaStream_t s) {
  const bool bf = std::is_same<WT, bf16>::value;
  const int rows = n * b;
  const int h4 = 4 * hdim;
  const WT* cs = static_cast<const WT*>(cseq);
  const WT* dhs = static_cast<const WT*>(dh_seq);
  const WT* w = static_cast<const WT*>(whh);
  WT* dgw = static_cast<WT*>(dg);
  void* args[] = {&g, &c0, &cs, &dhs, &dh_fin, &dc_fin, &w, &dgw, &dh0,
                  &dc0, &dbih, &dbhh, &n, &b, &hdim};
  int err = launch_chain(bwd_kernel(bf), hdim / U, bwd_smem(hdim, bf), args,
                         s);
  if (err) return err;
  // dX [NB, H] = dG [NB, 4H] @ Wih^T (Wih is [H, 4H]: B stored [N, K])
  err = gemm<false, true, WT>(bf, dg, h4, wih, h4, nullptr,
                              static_cast<WT*>(dx), hdim, rows, hdim, h4, s);
  if (err) return err;
  // dWih [H, 4H] = X^T @ dG (X is [NB, H]: A stored [K, M])
  err = gemm<true, false, float>(bf, x, hdim, dg, h4, nullptr, dwih, h4,
                                 hdim, h4, rows, s);
  if (err) return err;
  // dWhh [H, 4H] = H_prev^T @ dG, H_prev = hbuf[0..N-1] as [NB, H]
  return gemm<true, false, float>(bf, hbuf, hdim, dg, h4, nullptr, dwhh, h4,
                                  hdim, h4, rows, s);
}

}  // namespace

// Whether both serial kernels run at width hdim on this device: 0 yes,
// 1 their shared memory exceeds a block's, 2 the hdim/8 blocks cannot all
// be resident for the grid barrier, negative a cudaError_t.
extern "C" int srnn_lstm_seq_fits(int hdim, int w_bf16) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = w_bf16 != 0;
  const int f = chain_fits(fwd_kernel(bf), hdim / U, fwd_smem(hdim, bf));
  return f ? f : chain_fits(bwd_kernel(bf), hdim / U, bwd_smem(hdim, bf));
}

// Forward: x [N*B, H] and the weights in the weight type; h0, c0 [B, H],
// biases [4H] float32.  Writes g [N*B, 4H] float32 (the gate
// pre-activations, the backward pass's residual), hbuf [N+1, B, H] and
// cseq [N, B, H] in the weight type (hbuf[t+1] = h_seq[t], hbuf[0] =
// round(h0)), hfin and cfin [B, H] float32.  Returns a cudaError_t (0 =
// launched).
extern "C" int srnn_lstm_seq_fwd(const void* x, const float* h0,
                                 const float* c0, const void* wih,
                                 const float* bih, const void* whh,
                                 const float* bhh, float* g, void* hbuf,
                                 void* cseq, float* hfin, float* cfin, int n,
                                 int b, int hdim, int w_bf16, void* stream) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_bf16 ? seq_fwd<bf16>(x, h0, c0, wih, bih, whh, bhh, g, hbuf, cseq,
                                hfin, cfin, n, b, hdim, s)
                : seq_fwd<float>(x, h0, c0, wih, bih, whh, bhh, g, hbuf,
                                 cseq, hfin, cfin, n, b, hdim, s);
}

// Backward: the forward's inputs and residuals (x, c0, wih, whh, hbuf,
// cseq, g), dh_seq [N, B, H] in the weight type, dh_fin and dc_fin [B, H]
// float32.  Scratch dg [N*B, 4H] in the weight type.  Writes dx [N*B, H]
// in the weight type, dh0 and dc0 [B, H], dwih, dwhh [H, 4H] and dbih,
// dbhh [4H], all float32.  Returns a cudaError_t (0 = launched).
extern "C" int srnn_lstm_seq_bwd(const void* x, const float* c0,
                                 const void* wih, const void* whh,
                                 const void* hbuf, const void* cseq,
                                 const float* g, const void* dh_seq,
                                 const float* dh_fin, const float* dc_fin,
                                 void* dg, void* dx, float* dh0, float* dc0,
                                 float* dwih, float* dbih, float* dwhh,
                                 float* dbhh, int n, int b, int hdim,
                                 int w_bf16, void* stream) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_bf16
      ? seq_bwd<bf16>(x, c0, wih, whh, hbuf, cseq, g, dh_seq, dh_fin, dc_fin,
                      dg, dx, dh0, dc0, dwih, dbih, dwhh, dbhh, n, b, hdim, s)
      : seq_bwd<float>(x, c0, wih, whh, hbuf, cseq, g, dh_seq, dh_fin,
                       dc_fin, dg, dx, dh0, dc0, dwih, dbih, dwhh, dbhh, n, b,
                       hdim, s);
}
