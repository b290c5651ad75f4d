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
// rates.  Gate math uses expf/tanhf, not the fast intrinsics.  The GEMMs,
// the staged loads, the mma fragments and the cooperative launch are
// shared with K5 (seq_common.cuh).

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
template <bool MMA>
__device__ __forceinline__ void bias_sums(const float* part, int hdim,
                                          float* __restrict__ dbih,
                                          float* __restrict__ dbhh) {
  if (threadIdx.x >= U) return;
  float a[4];
  unit_sums<MMA>(part, a);
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

// ---- bf16: tensor-core chains (seq_common.cuh's mma fragments; each
// thread holds all three gates of its 2 rows x 2 units) ----

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
