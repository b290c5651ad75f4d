// The serial chains of the whole-sequence RNN kernels (K4 gru_sequence.cu,
// K5 lstm_sequence.cu), written once over a cell type, and the host side
// that plans and launches them.  The design (seq_common.cuh has the engine
// parts):
//
// forward: after one tiled GEMM of the input gates over all N*B rows, the
//   chain runs the whole sequence in one cooperative launch: each block
//   owns some hidden units with all G of their gate columns for some rows,
//   keeps that slice of Whh in shared memory, multiplies round(h_{t-1}) of
//   its rows by it, computes the gates and writes h_t (rounded to the
//   weight type) and the residuals the backward reads back.
// backward: the chain forms, per step, the gate gradients of each block's
//   units (stored rounded to the weight type, the reference's rounding
//   point for the products) and their bias sums (unrounded, in a fixed
//   order), publishes them, then computes its units' dh carry with
//   round(dG_t) @ Whh^T from the matching Whh rows in shared memory; three
//   tiled GEMMs over all N*B rows give dX, dWih and dWhh.
//
// bf16 weights (namespace tc): TMA-fed wgmma with readiness flags instead
// of a grid barrier.  float32 weights (the exact path the tests hold): FMA
// products, blocks of U units meeting at one grid barrier per step.  Gate
// math uses expf/tanhf, not the fast intrinsics.
//
// A library includes this header once and supplies its cell (GruCell,
// LstmCell): the gate count G, the backward's carries K (dh first), the
// chains' arguments Fwd<WT> and Bwd<WT> (pointers in the order of its
// kernels' parameters), and per row and unit the loads, the gate math and
// the stores of both directions.  The bodies below never branch on the
// cell.  Its kernels are thin wrappers over them under the library's own
// names (the profiler's traces and the benchmark's metrics find K4 and K5
// by those names), and a struct `Lib`, derived from the cell, names them
// for the host side: fma_chain(bwd), tc_chain<UN, WG, NB>(bwd).
#pragma once

#include "seq_common.cuh"

namespace {

// Row `row`, unit j at step t of a sequence of width hdim and batch b: its
// offset in [B, H] (o), in [N, B, H] at step s (seq), and of gate q in
// [N*B, g*H] (gate).
struct Elem {
  int t, row, j, b, hdim;
  __device__ int64_t o() const { return static_cast<int64_t>(row) * hdim + j; }
  __device__ int64_t seq(int s) const {
    return static_cast<int64_t>(s) * b * hdim + o();
  }
  __device__ int64_t gate(int g, int q) const {
    return (static_cast<int64_t>(t) * b + row) * g * hdim + q * hdim + j;
  }
};

// How a cell reads its inputs: the float32 chains with plain loads, the
// bf16 chains with loads that stay where they stand (tc::ld).
struct PlainLoad {
  template <typename T>
  __device__ __forceinline__ float operator()(const T* q) const {
    return srnn::to_f32(*q);
  }
};
struct FixedLoad {
  template <typename T>
  __device__ __forceinline__ float operator()(const T* q) const {
    return tc::ld(q);
  }
};

// ---- float32: FMA chains ----
// Thread (u = tid % 8, rg = tid / 8) owns unit u and rows rg*4 .. rg*4+3
// of each 128-row pass; the staged tile is float32.

template <class Cell>
__device__ __forceinline__ void fma_fwd_chain(
    const typename Cell::template Fwd<float>& p, int n, int b, int hdim) {
  constexpr int G = Cell::G;
  extern __shared__ __align__(16) float smem[];
  const int kpad = round_up(hdim, KC);
  float* ws = smem;                         // [kpad][G*U]: Whh columns
  float* hs = smem + kpad * G * U;          // [ROWS][HS]
  const int tid = threadIdx.x, u = tid % U, rg = tid / U;
  const int j = blockIdx.x * U + u;
  for (int e = tid; e < kpad * G * U; e += THREADS) {
    const int k = e / (G * U), c = e % (G * U);
    ws[e] = k < hdim ? p.whh[static_cast<int64_t>(k) * G * hdim +
                             (c / U) * hdim + blockIdx.x * U + c % U]
                     : 0.f;
  }
  cg::grid_group grid = cg::this_grid();
  round_h0(p.h0, p.hbuf, b, hdim, grid);
  Chunk next;
  for (int t = 0; t < n; ++t) {
    const float* src = p.hbuf + static_cast<int64_t>(t) * b * hdim;
    for (int r0 = 0; r0 < b; r0 += ROWS) {
      float acc[RT][G] = {};
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
            const float* wrow = ws + (k0 + kk + s) * G * U;
            float w[G];
#pragma unroll
            for (int q = 0; q < G; ++q) w[q] = wrow[q * U + u];
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              const float hvs = s == 0 ? hv[i].x
                              : s == 1 ? hv[i].y
                              : s == 2 ? hv[i].z : hv[i].w;
#pragma unroll
              for (int q = 0; q < G; ++q)
                acc[i][q] = fmaf(hvs, w[q], acc[i][q]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const Elem at{t, r0 + rg * RT + i, j, b, hdim};
        if (at.row >= b) continue;
        typename Cell::FwdIn in;
        Cell::fwd_load(p, in, at, true, PlainLoad());
        float hq[G];   // round(h_{t-1}) @ Whh + bhh
#pragma unroll
        for (int q = 0; q < G; ++q) hq[q] = acc[i][q] + p.bhh[q * hdim + j];
        typename Cell::FwdOut out;
        Cell::fwd_math(in, hq, out);
        p.hbuf[at.seq(t + 1)] = out.h;
        Cell::fwd_store(p, out, at);
      }
    }
    __threadfence();
    grid.sync();   // h_t of every unit is in hbuf before step t+1 reads it
  }
}

// dg: the gate gradients the carry's product reads, [N, B, G*H]
template <class Cell>
__device__ __forceinline__ void fma_bwd_chain(
    const typename Cell::template Bwd<float>& p, const float* dg, int n,
    int b, int hdim) {
  constexpr int K = Cell::K;
  extern __shared__ __align__(16) float smem[];
  const int gh = Cell::G * hdim;
  const int kpad = round_up(gh, KC);
  float* ws = smem;                     // [kpad][U]: Whh rows j0..j0+U
  float* hs = smem + kpad * U;          // [ROWS][HS]
  const int tid = threadIdx.x, u = tid % U, rg = tid / U;
  const int j = blockIdx.x * U + u;
  for (int e = tid; e < kpad * U; e += THREADS) {
    const int k = e / U;
    ws[e] = k < gh ? p.whh[static_cast<int64_t>(blockIdx.x * U + e % U) * gh +
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
        const Elem at{t, r0 + rg * RT + i, j, b, hdim};
        if (at.row >= b) continue;
        typename Cell::BwdIn in;
        Cell::bwd_load(p, in, at, true, PlainLoad());
        float cin[K], dv[4], mid[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          cin[k] = t == n - 1 ? p.dfin[k][at.o()] : p.d0[k][at.o()];
        Cell::bwd_math(in, cin, dv, mid);
        Cell::store_dg(p, dv, at);
        Cell::store_rest(p, dv, at);
        Cell::hand_on(mid, [&](int k) -> float& { return p.d0[k][at.o()]; });
#pragma unroll
        for (int q = 0; q < 4; ++q) s[q] += dv[q];
      }
    __threadfence();
    grid.sync();   // dG_t of every unit is written
    const float* src = dg + static_cast<int64_t>(t) * b * gh;
    for (int r0 = 0; r0 < b; r0 += ROWS) {
      float acc[RT] = {};
      next.fetch(src, gh, r0, b, 0, gh);
      for (int k0 = 0; k0 < gh; k0 += KC) {
        next.store(hs);
        __syncthreads();
        if (k0 + KC < gh) next.fetch(src, gh, r0, b, k0 + KC, gh);
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
        if (row < b) {   // dh_{t-1} from round(dG_t) @ Whh^T (dh_after)
          const int64_t o = static_cast<int64_t>(row) * hdim + j;
          p.d0[0][o] = Cell::dh_after(p.d0[0][o], acc[i]);
        }
      }
    }
  }
  __syncthreads();
  float* part = smem;                   // Whh no longer needed
#pragma unroll
  for (int c = 0; c < 4; ++c) part[tid * 4 + c] = s[c];
  __syncthreads();
  if (threadIdx.x >= U) return;
  float a[4];
  unit_sums(part, a);
  Cell::bias(p, a, blockIdx.x * U + threadIdx.x, hdim);
}

// ---- bf16: wgmma chains fed by TMA (seq_common.cuh, namespace tc) ----
// A consumer thread holds, for each of its rows (pl.row(0), row(1)) and
// units (8 uh + lane2 + e), every gate of the unit: the forward's columns
// are gate-major (gate q of unit u is column q * UN + u, accumulator group
// q * UH + uh).

// f(uh, rs, e) for each of a consumer thread's elements (rows rs outermost)
template <int UH, class F>
__device__ __forceinline__ void each_elem(F f) {
#pragma unroll
  for (int rs = 0; rs < 2; ++rs)
#pragma unroll
    for (int uh = 0; uh < UH; ++uh)
#pragma unroll
      for (int e = 0; e < 2; ++e) f(uh, rs, e);
}

template <class Cell, int UN, int WG, int NB>
__device__ __forceinline__ void tc_fwd_chain(
    const CUtensorMap* hmap, const tc::Chain& c,
    const typename Cell::template Fwd<bf16>& p, int* flags) {
  using namespace srnn::sm90;
  constexpr int G = Cell::G, NC = G * UN, UH = UN / 8;
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
      G * UH * kpad,
      [&](int e) {
        const int k = e % kpad, q = e / kpad / UH, uh = e / kpad % UH;
        return k < hdim ? *reinterpret_cast<const uint4*>(
                              p.whh + static_cast<int64_t>(k) * G * hdim +
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
    tc::producer<WG>(hmap, c, flags, false, ring, full, empty);
    return;
  }
  const tc::Place pl;
  tc::trace_clock(c, 0);
  for (int e = threadIdx.x; e < (row_end - row0) * UN; e += WG * 128) {
    const int64_t o =
        static_cast<int64_t>(row0 + e / UN) * hdim + j0 + e % UN;
    p.hbuf[o] = __float2bfloat16_rn(p.h0[o]);   // hbuf[0] = round(h0)
  }
  tc::publish(tc::flag_of(flags, blockIdx.x), 1, WG);
  float bq[G][UH][2];
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int uh = 0; uh < UH; ++uh)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bq[q][uh][e] = p.bhh[q * hdim + j0 + 8 * uh + pl.lane2 + e];
  const uint32_t ring_u = smem_u32(ring), ws_u = smem_u32(ws);
  const int passes = c.rows / (64 * WG);
  auto at_of = [&](int t, int pr, int uh, int rs, int e) {
    return Elem{t, pr + pl.row(rs), j0 + 8 * uh + pl.lane2 + e, b, hdim};
  };
  int it = 0;
  float acc[NC / 2];
  typename Cell::FwdOut out[UH][2][2];
  for (int t = 0; t < c.n; ++t) {
    if (threadIdx.x == 0) tc::trace(c, t, 0);
    for (int pass = 0; pass < passes; ++pass) {
      const int pr = row0 + pass * 64 * WG;
      // what the gate math reads besides the product, loaded while the
      // boxes land
      typename Cell::FwdIn in[UH][2][2];
      each_elem<UH>([&](int uh, int rs, int e) {
        const Elem at = at_of(t, pr, uh, rs, e);
        Cell::fwd_load(p, in[uh][rs][e], at, at.row < row_end, FixedLoad());
      });
      tc::product<NC, WG, NB>(acc, it, c, t, ring_u, ws_u, full, empty);
      if (threadIdx.x == 0) tc::trace(c, t, 2);
      // every element's gate math first (independent chains the compiler
      // can interleave), then the stores of the rows in range: h_t, which
      // the other blocks wait for, before the flag; with one pass the
      // rest after it
      each_elem<UH>([&](int uh, int rs, int e) {
        float hq[G];   // round(h_{t-1}) @ Whh + bhh
#pragma unroll
        for (int q = 0; q < G; ++q)
          hq[q] = acc[4 * (q * UH + uh) + 2 * rs + e] + bq[q][uh][e];
        Cell::fwd_math(in[uh][rs][e], hq, out[uh][rs][e]);
      });
      each_elem<UH>([&](int uh, int rs, int e) {
        const Elem at = at_of(t, pr, uh, rs, e);
        if (at.row >= row_end) return;
        p.hbuf[at.seq(t + 1)] = __float2bfloat16_rn(out[uh][rs][e].h);
        if (passes > 1) Cell::fwd_store(p, out[uh][rs][e], at);
      });
    }
    if (threadIdx.x == 0) tc::trace(c, t, 3);
    tc::publish(tc::flag_of(flags, blockIdx.x), t + 2, WG);
    if (passes == 1)   // what no other block waits for, after the flag
      each_elem<UH>([&](int uh, int rs, int e) {
        const Elem at = at_of(t, row0, uh, rs, e);
        if (at.row < row_end) Cell::fwd_store(p, out[uh][rs][e], at);
      });
    if (threadIdx.x == 0) tc::trace(c, t, 4);
  }
  tc::trace_clock(c, 1);
}

template <class Cell, int UN, int WG, int NB>
__device__ __forceinline__ void tc_bwd_chain(
    const CUtensorMap* gmap, const tc::Chain& c,
    const typename Cell::template Bwd<bf16>& p, float* bpart, int* flags) {
  using namespace srnn::sm90;
  constexpr int K = Cell::K, NC = UN, UH = UN / 8;
  __shared__ __align__(8) uint64_t full[tc::MAX_STAGES],
      empty[tc::MAX_STAGES];
  extern __shared__ __align__(128) uint8_t tc_raw[];
  uint8_t* ws = tc_raw + ((1024 - (smem_u32(tc_raw) & 1023)) & 1023);
  const int hdim = c.hdim, b = c.b, gh = Cell::G * hdim, kch = c.kpan;
  uint8_t* ring = ws + kch * NC * 128;
  const int j0 = blockIdx.x % c.owners * UN;
  const int row0 = blockIdx.x / c.owners * c.rows;
  const int row_end = min(b, row0 + c.rows);
  tc::trace_clock(c, 2);
  tc::init_barriers(c, full, empty, WG);
  // B: row u is Whh's row j0 + u (G * hdim long), zero past its end
  tc::stage_b(
      NC * kch * 8,
      [&](int e) {
        const int u = e / (kch * 8), k = (e % (kch * 8)) * 8;
        return k < gh ? *reinterpret_cast<const uint4*>(
                            p.whh + static_cast<int64_t>(j0 + u) * gh + k)
                      : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int e, uint4 raw) {
        *reinterpret_cast<uint4*>(
            ws + tc::ws_off(e / (kch * 8), (e % (kch * 8)) * 8, NC)) = raw;
      });
  fence_proxy_async();
  __syncthreads();
  if (__shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 4 * WG) {
    tc::producer<WG>(gmap, c, flags, true, ring, full, empty);
    return;
  }
  const tc::Place pl;
  tc::trace_clock(c, 0);
  const uint32_t ring_u = smem_u32(ring), ws_u = smem_u32(ws);
  const int passes = c.rows / (64 * WG);
  auto at_of = [&](int t, int pr, int uh, int rs, int e) {
    return Elem{t, pr + pl.row(rs), j0 + 8 * uh + pl.lane2 + e, b, hdim};
  };
  float sums[UH][2][4] = {};
  int it = 0;
  float acc[NC / 2];
  // one row pass (the main paths): the carries stay in registers and the
  // next step's residuals load while this step's product runs
  const bool one = passes == 1;
  float carry[UH][2][2][K] = {}, dv[UH][2][2][4], mid[UH][2][2][K];
  typename Cell::BwdIn in[UH][2][2];
  // the gate math's inputs of step t that do not depend on the carries,
  // for the rows of the pass at pr; zero past row_end
  auto load = [&](int t, int pr) {
    each_elem<UH>([&](int uh, int rs, int e) {
      const Elem at = at_of(t, pr, uh, rs, e);
      Cell::bwd_load(p, in[uh][rs][e], at, at.row < row_end, FixedLoad());
    });
  };
  if (one) load(c.n - 1, row0);
  for (int s = 0; s < c.n; ++s) {
    const int t = c.n - 1 - s;
    if (threadIdx.x == 0) tc::trace(c, s, 0);
    // the gate gradients of step t for the block's rows and units
    for (int pass = 0; pass < passes; ++pass) {
      const int pr = row0 + pass * 64 * WG;
      if (!one) load(t, pr);
      // every element's gate math first, then the stores of the rows in
      // range: the gate gradients the other blocks wait for, before the
      // flag; with one pass the rest after it
      each_elem<UH>([&](int uh, int rs, int e) {
        const Elem at = at_of(t, pr, uh, rs, e);
        const bool ok = at.row < row_end;
        const int64_t o = at.o();
        float cin[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          cin[k] = !ok ? 0.f : s == 0 ? p.dfin[k][o]
                 : one ? carry[uh][rs][e][k] : p.d0[k][o];
        Cell::bwd_math(in[uh][rs][e], cin, dv[uh][rs][e], mid[uh][rs][e]);
      });
      each_elem<UH>([&](int uh, int rs, int e) {
        const Elem at = at_of(t, pr, uh, rs, e);
        if (at.row >= row_end) return;
        Cell::store_dg(p, dv[uh][rs][e], at);
        if (one) return;
        Cell::store_rest(p, dv[uh][rs][e], at);
#pragma unroll
        for (int q = 0; q < 4; ++q) sums[uh][e][q] += dv[uh][rs][e][q];
        Cell::hand_on(mid[uh][rs][e],
                      [&](int k) -> float& { return p.d0[k][at.o()]; });
      });
    }
    if (threadIdx.x == 0) tc::trace(c, s, 5);
    tc::publish(tc::flag_of(flags, blockIdx.x), s + 1, WG);
    if (threadIdx.x == 0) tc::trace(c, s, 4);
    if (one)   // what no other block waits for, after the flag
      each_elem<UH>([&](int uh, int rs, int e) {
        const Elem at = at_of(t, row0, uh, rs, e);
        if (at.row >= row_end) return;
        Cell::store_rest(p, dv[uh][rs][e], at);
#pragma unroll
        for (int q = 0; q < 4; ++q) sums[uh][e][q] += dv[uh][rs][e][q];
        Cell::hand_on(mid[uh][rs][e],
                      [&](int k) -> float& { return carry[uh][rs][e][k]; });
      });
    if (one && t > 0) load(t - 1, row0);
    // dh_{t-1} from round(dG_t) @ Whh^T for the block's units (dh_after)
    for (int pass = 0; pass < passes; ++pass) {
      const int pr = row0 + pass * 64 * WG;
      tc::product<NC, WG, NB>(acc, it, c, s, ring_u, ws_u, full, empty);
      if (threadIdx.x == 0) tc::trace(c, s, 2);
      each_elem<UH>([&](int uh, int rs, int e) {
        const Elem at = at_of(t, pr, uh, rs, e);
        if (at.row >= row_end) return;
        const float v = acc[4 * uh + 2 * rs + e];
        if (one)
          carry[uh][rs][e][0] = Cell::dh_after(carry[uh][rs][e][0], v);
        else
          p.d0[0][at.o()] = Cell::dh_after(p.d0[0][at.o()], v);
      });
    }
  }
  if (one)
    each_elem<UH>([&](int uh, int rs, int e) {
      const Elem at = at_of(0, row0, uh, rs, e);
      if (at.row >= row_end) return;
#pragma unroll
      for (int k = 0; k < K; ++k) p.d0[k][at.o()] = carry[uh][rs][e][k];
    });
  tc::trace_clock(c, 1);
  tc::bias_sums<UN, WG>(sums, reinterpret_cast<float*>(ws), bpart, flags, c,
                        c.n + 1, [&](int j, const float* a) {
                          Cell::bias(p, a, j, hdim);
                        });
}

// ------------------------------------------------------------- host --

unsigned long long* g_trace = nullptr;   // the library's srnn_*_seq_trace

// float32 chains' dynamic shared memory: the Whh slice (forward hdim rows
// of G * U columns, backward U rows of G * hdim) and the staged tile
template <class Lib>
size_t fma_smem(int hdim, bool bwd) {
  const size_t ws =
      bwd ? static_cast<size_t>(round_up(Lib::G * hdim, KC)) * U
          : static_cast<size_t>(round_up(hdim, KC)) * Lib::G * U;
  return 4 * (ws + ROWS * HS);
}

// bf16 chains: the kernel of a plan (units, warpgroups, chunks per slot)
template <class Lib, int NB>
const void* tc_kernel_nb(bool bwd, int units, int wg) {
  if (units == 8)
    return wg == 1 ? Lib::template tc_chain<8, 1, NB>(bwd)
                   : Lib::template tc_chain<8, 2, NB>(bwd);
  return wg == 1 ? Lib::template tc_chain<16, 1, NB>(bwd)
                 : Lib::template tc_chain<16, 2, NB>(bwd);
}

template <class Lib>
const void* tc_kernel(bool bwd, const int* plan) {
  return plan[4] == 1 ? tc_kernel_nb<Lib, 1>(bwd, plan[0], plan[1])
                      : tc_kernel_nb<Lib, 8>(bwd, plan[0], plan[1]);
}

// plan = {units, warpgroups, rows per block, ring slots, chunks per slot};
// the staged rows are h (hdim wide) forward, dG (G * hdim) backward
template <class Lib>
tc::Chain chain(int n, int b, int hdim, bool bwd, const int* plan) {
  const int kdim = bwd ? Lib::G * hdim : hdim, kch = (kdim + 63) / 64;
  const int nb = plan[4] > 0 ? plan[4] : 1;
  return tc::Chain{n, b, hdim, kdim, plan[0], plan[0] ? hdim / plan[0] : 0,
                   plan[2], plan[3], kch, nb, (kch + nb - 1) / nb * nb,
                   g_trace};
}

// The B operand's columns: every gate of the block's units forward, its
// units backward
template <class Lib>
int chain_nc(bool bwd, const int* plan) {
  return bwd ? plan[0] : Lib::G * plan[0];
}

// Whether both serial kernels run at width hdim on this device: 0 yes,
// 1 their shared memory exceeds a block's, 2 their blocks cannot all be
// resident, negative a cudaError_t.  bf16: for the chain plan `plan`
// (ops/kernels/rnn_train.py:chain_plan), one row group; float32: dim/8
// blocks of the FMA chains.
template <class Lib>
int seq_fits(int hdim, int w_bf16, const int* plan) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  for (int bwd = 0; bwd < 2; ++bwd) {
    int f;
    if (w_bf16) {
      const tc::Chain c = chain<Lib>(1, plan[2], hdim, bwd, plan);
      if (tc::check_plan(c, plan[1]))
        return static_cast<int>(cudaErrorInvalidValue);
      f = chain_fits(tc_kernel<Lib>(bwd, plan), c.owners,
                     tc::smem_bytes(c.kdim, chain_nc<Lib>(bwd, plan),
                                    plan[1], plan[3], c.nb),
                     plan[1] * 128 + 32);
    } else {
      f = chain_fits(Lib::fma_chain(bwd), hdim / U, fma_smem<Lib>(hdim, bwd));
    }
    if (f) return f;
  }
  return 0;
}

// A bf16 chain over the staged rows at `rows` (forward hbuf [N+1, B, H],
// backward dG [N, B, G*H]); `a` are its kernel's arguments after the map
// and the plan.
template <class Lib, typename... A>
int launch_tc(bool bwd, const void* rows, int n, int b, int hdim,
              const int* plan, cudaStream_t s, A... a) {
  const tc::Chain c = chain<Lib>(n, b, hdim, bwd, plan);
  CUtensorMap map;
  if (!tc::rows_map(&map, rows, bwd ? n : n + 1, b, c.kdim, c.nb))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&map, const_cast<tc::Chain*>(&c), &a...};
  return tc::launch(tc_kernel<Lib>(bwd, plan), c, plan[1],
                    chain_nc<Lib>(bwd, plan), args, s);
}

// A float32 chain, dim / U blocks; `a` are its kernel's arguments.
template <class Lib, typename... A>
int launch_fma(bool bwd, int hdim, cudaStream_t s, A... a) {
  void* args[] = {&a...};
  return launch_chain(Lib::fma_chain(bwd), hdim / U, fma_smem<Lib>(hdim, bwd),
                      args, s);
}

// The backward's tiled GEMMs over all N*B rows, each summing over rows in a
// fixed order (no atomics), so two runs give the same gradient: dX =
// round(dG_x) @ Wih^T, dWih = round(X)^T @ round(dG_x) and dWhh =
// round(H_prev)^T @ round(dG_h), H_prev = hbuf[0..N-1] (the GRU's d_xg and
// d_hg; the LSTM's one dG for both).
template <class Lib>
int bwd_gemms(int w_bf16, const void* x, const void* wih, const void* hbuf,
              const void* dxg, const void* dhg, void* dx, float* dwih,
              float* dwhh, int n, int b, int hdim, cudaStream_t s) {
  const int rows = n * b, gh = Lib::G * hdim;
  // dX [NB, H] = dG_x [NB, GH] @ Wih^T (Wih is [H, GH]: B stored [N, K])
  int err = w_bf16 ? gemm<false, true, bf16>(true, dxg, gh, wih, gh, nullptr,
                                             static_cast<bf16*>(dx), hdim,
                                             rows, hdim, gh, s)
                   : gemm<false, true, float>(false, dxg, gh, wih, gh,
                                              nullptr, static_cast<float*>(dx),
                                              hdim, rows, hdim, gh, s);
  if (err) return err;
  // dWih [H, GH] = X^T @ dG_x (X is [NB, H]: A stored [K, M])
  err = gemm<true, false, float>(w_bf16, x, hdim, dxg, gh, nullptr, dwih, gh,
                                 hdim, gh, rows, s);
  if (err) return err;
  // dWhh [H, GH] = H_prev^T @ dG_h
  return gemm<true, false, float>(w_bf16, hbuf, hdim, dhg, gh, nullptr, dwhh,
                                  gh, hdim, gh, rows, s);
}

}  // namespace
