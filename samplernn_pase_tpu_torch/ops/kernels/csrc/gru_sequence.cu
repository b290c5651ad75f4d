// K4 gru_sequence: the whole-sequence GRU of a training step, forward and
// backward, in float32 gate math with products on values rounded to the
// weight type (float32 or bf16) and float32 accumulation.
//
// Replaces samplernn_pase_tpu/ops/pallas/rnn_train.py: _fwd_call (the
// pallas_call at :137, body _fwd_kernel) and _bwd_call (:156, body
// _bwd_kernel), the custom VJP behind gru_sequence.  The Pallas kernels
// keep both weight matrices, their transposes, the [N,B,H] residuals and
// the float32 dW accumulators in VMEM (~117 MB at the flagship's tier 0);
// an H100 SM has 228 KB of shared memory, so the work is split instead,
// into tiled GEMMs and serial chains (seq_chain.cuh, with this file's GRU
// cell):
//
// forward (srnn_gru_seq_fwd): XG = round(X) @ Wih + bih over all N*B rows,
//   then the chain.  HG = round(h_{t-1}) @ Whh + bhh is kept as a residual
//   beside XG, so the backward pass needs no recompute product.
// backward (srnn_gru_seq_bwd): the chain forms the gate gradients d_xg and
//   d_hg and computes its units' carry g*z + round(d_hg) @ Whh^T; then dX
//   = round(d_xg) @ Wih^T, dWih = round(X)^T @ round(d_xg) and dWhh =
//   round(H_prev)^T @ round(d_hg).
//
// Bound on the H100: operations.  At the flagship's tier 0 (N=64, B=128,
// H=1024) the products are 2 x 51.5 GFLOP forward and 4 x 51.5 backward
// (the Pallas kernel's 6 count the two recompute products this design
// keeps as residuals instead), about 104 us and 208 us at 989 TFLOP/s.
// With bf16 weights the chain's plan (rnn_train.chain_plan) splits the
// flagship's 128 rows over two row groups of 16-unit blocks (64 x 2 = 128
// blocks), halving the rows each block reads from L2 per step.  The chains
// are bound by their per-step latency (the flag, the boxes' L2 reads, the
// product and the gate math in series), not by the card's rates.

#include "seq_chain.cuh"

namespace {

// The GRU cell (gates r, z, n) of the chains, for row at.row, unit at.j:
// the forward keeps xg and hg as residuals, the backward carries dh.
struct GruCell {
  static constexpr int G = 3;   // gates
  static constexpr int K = 1;   // the backward's carries: dh

  template <typename WT>
  struct Fwd {   // the forward chain's arguments
    const float *xg, *h0;
    const WT* whh;
    const float* bhh;
    WT* hbuf;
    float *hg, *hfin;
  };
  struct FwdIn { float x[3], hp; };    // xg's gates, h_{t-1} (float32)
  struct FwdOut { float h, hq[3]; };   // h_t, hg's gates

  template <typename WT, class LD>
  static __device__ __forceinline__ void fwd_load(const Fwd<WT>& p,
                                                  FwdIn& in, const Elem& at,
                                                  bool ok, LD ld) {
#pragma unroll
    for (int q = 0; q < 3; ++q) in.x[q] = ok ? ld(p.xg + at.gate(3, q)) : 0.f;
    in.hp = !ok ? 0.f : ld((at.t == 0 ? p.h0 : p.hfin) + at.o());
  }

  // hq = round(h_{t-1}) @ Whh + bhh
  static __device__ __forceinline__ void fwd_math(const FwdIn& in,
                                                  const float (&hq)[3],
                                                  FwdOut& out) {
    const float r = sigmoidf(in.x[0] + hq[0]);
    const float z = sigmoidf(in.x[1] + hq[1]);
    const float nn = tanhf(in.x[2] + r * hq[2]);
    out.h = (1.f - z) * nn + z * in.hp;
#pragma unroll
    for (int q = 0; q < 3; ++q) out.hq[q] = hq[q];
  }

  // what no other block waits for: the carried h and hg
  template <typename WT>
  static __device__ __forceinline__ void fwd_store(const Fwd<WT>& p,
                                                   const FwdOut& out,
                                                   const Elem& at) {
    p.hfin[at.o()] = out.h;
#pragma unroll
    for (int q = 0; q < 3; ++q) p.hg[at.gate(3, q)] = out.hq[q];
  }

  template <typename WT>
  struct Bwd {   // the backward chain's arguments
    const float *xg, *hg, *h0;
    const WT *hbuf, *dh_seq;
    const float* dfin[K];   // dh_fin
    const WT* whh;
    WT *dxg, *dhg;
    float* d0[K];           // dh0, which holds the carry between steps
    float *dbih, *dbhh;
  };
  // dh_seq, h_{t-1} (h0, else the stored round(h_{t-1})), xg's and hg's
  // gates
  struct BwdIn { float dh, hp, x[3], hq[3]; };

  template <typename WT, class LD>
  static __device__ __forceinline__ void bwd_load(const Bwd<WT>& p,
                                                  BwdIn& in, const Elem& at,
                                                  bool ok, LD ld) {
    in.dh = ok ? ld(p.dh_seq + at.seq(at.t)) : 0.f;
    in.hp = !ok ? 0.f : at.t == 0 ? ld(p.h0 + at.o())
          : ld(p.hbuf + at.seq(at.t));
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      in.x[q] = ok ? ld(p.xg + at.gate(3, q)) : 0.f;
      in.hq[q] = ok ? ld(p.hg + at.gate(3, q)) : 0.f;
    }
  }

  // The gate gradients dv = (dxr, dxz, dxn, dhn): d_xg's three and d_hg's
  // n (d_hg's r and z are d_xg's); mid = g*z, the carry's first term.
  static __device__ __forceinline__ void bwd_math(const BwdIn& in,
                                                  const float (&cin)[K],
                                                  float (&dv)[4],
                                                  float (&mid)[K]) {
    const float g = cin[0] + in.dh;
    const float hr = in.hq[0], hn = in.hq[2];
    const float r = sigmoidf(in.x[0] + hr);
    const float z = sigmoidf(in.x[1] + in.hq[1]);
    const float nn = tanhf(in.x[2] + r * hn);
    const float dn = g * (1.f - z);
    const float dz = g * (in.hp - nn);
    const float dtanh = dn * (1.f - nn * nn);
    const float dr = dtanh * hn;
    dv[0] = dr * r * (1.f - r);
    dv[1] = dz * z * (1.f - z);
    dv[2] = dtanh;
    dv[3] = dtanh * r;
    mid[0] = g * z;
  }

  // d_hg, which the other blocks' products wait for
  template <typename WT>
  static __device__ __forceinline__ void store_dg(const Bwd<WT>& p,
                                                  const float (&dv)[4],
                                                  const Elem& at) {
    p.dhg[at.gate(3, 0)] = from_f32<WT>(dv[0]);
    p.dhg[at.gate(3, 1)] = from_f32<WT>(dv[1]);
    p.dhg[at.gate(3, 2)] = from_f32<WT>(dv[3]);
  }

  // what no other block waits for: d_xg
  template <typename WT>
  static __device__ __forceinline__ void store_rest(const Bwd<WT>& p,
                                                    const float (&dv)[4],
                                                    const Elem& at) {
#pragma unroll
    for (int q = 0; q < 3; ++q) p.dxg[at.gate(3, q)] = from_f32<WT>(dv[q]);
  }

  // The carries the gate math hands on, to dst(k) (registers, or dh0
  // between the row passes): g*z, to which the product is added.
  template <class Dst>
  static __device__ __forceinline__ void hand_on(const float (&mid)[K],
                                                 Dst dst) {
    dst(0) = mid[0];
  }

  // carry_{t-1} = g*z + round(d_hg_t) @ Whh^T
  static __device__ __forceinline__ float dh_after(float mid, float prod) {
    return mid + prod;
  }

  // The block's bias sums a = (r, z, xn, hn) for unit j into the r, z, n
  // columns of both biases: the n column of dbih takes xn, that of dbhh hn.
  template <typename WT>
  static __device__ __forceinline__ void bias(const Bwd<WT>& p,
                                              const float* a, int j,
                                              int hdim) {
    p.dbih[j] = a[0];
    p.dbih[hdim + j] = a[1];
    p.dbih[2 * hdim + j] = a[2];
    p.dbhh[j] = a[0];
    p.dbhh[hdim + j] = a[1];
    p.dbhh[2 * hdim + j] = a[3];
  }
};

// ---- the chains' kernels (the bodies are in seq_chain.cuh) ----

__global__ void __launch_bounds__(THREADS)
gruseq_fwd_chain(const float* __restrict__ xg, const float* __restrict__ h0,
                 const float* __restrict__ whh, const float* __restrict__ bhh,
                 float* hbuf, float* __restrict__ hg,
                 float* __restrict__ hfin, int n, int b, int hdim) {
  fma_fwd_chain<GruCell>({xg, h0, whh, bhh, hbuf, hg, hfin}, n, b, hdim);
}

__global__ void __launch_bounds__(THREADS)
gruseq_bwd_chain(const float* __restrict__ xg, const float* __restrict__ hg,
                 const float* __restrict__ h0, const float* __restrict__ hbuf,
                 const float* __restrict__ dh_seq,
                 const float* __restrict__ dh_fin,
                 const float* __restrict__ whh, float* dxg, float* dhg,
                 float* __restrict__ dh0, float* __restrict__ dbih,
                 float* __restrict__ dbhh, int n, int b, int hdim) {
  fma_bwd_chain<GruCell>({xg, hg, h0, hbuf, dh_seq, {dh_fin}, whh, dxg, dhg,
                          {dh0}, dbih, dbhh},
                         dhg, n, b, hdim);
}

template <int UN, int WG, int NB>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
gruseq_fwd_chain_tc(const __grid_constant__ CUtensorMap hmap, const tc::Chain c,
              const float* __restrict__ xg, const float* __restrict__ h0,
              const bf16* __restrict__ whh, const float* __restrict__ bhh,
              bf16* hbuf, float* __restrict__ hg, float* __restrict__ hfin,
              int* flags) {
  tc_fwd_chain<GruCell, UN, WG, NB>(&hmap, c,
                                    {xg, h0, whh, bhh, hbuf, hg, hfin}, flags);
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
  tc_bwd_chain<GruCell, UN, WG, NB>(
      &gmap, c,
      {xg, hg, h0, hbuf, dh_seq, {dh_fin}, whh, dxg, dhg, {dh0}, dbih, dbhh},
      bpart, flags);
}

// The kernels by plan, for the host side (seq_chain.cuh)
struct Lib : GruCell {
  static const void* fma_chain(bool bwd) {
    return bwd ? reinterpret_cast<const void*>(&gruseq_bwd_chain)
               : reinterpret_cast<const void*>(&gruseq_fwd_chain);
  }
  template <int UN, int WG, int NB>
  static const void* tc_chain(bool bwd) {
    return bwd
        ? reinterpret_cast<const void*>(&gruseq_bwd_chain_tc<UN, WG, NB>)
        : reinterpret_cast<const void*>(&gruseq_fwd_chain_tc<UN, WG, NB>);
  }
};

}  // namespace

// Whether both serial kernels run at width hdim on this device (seq_fits):
// 0 yes, 1 their shared memory exceeds a block's, 2 their blocks cannot all
// be resident, negative a cudaError_t.  `plan` as rnn_train.chain_plan's
// ({units, warpgroups, rows per block, ring slots, chunks per slot}).
extern "C" int srnn_gru_seq_fits(int hdim, int w_bf16, const int* plan) {
  return seq_fits<Lib>(hdim, w_bf16, plan);
}

// Forward: x [N*B, H] and the weights in the weight type; h0 [B, H],
// biases [3H] float32.  Writes xg, hg [N*B, 3H] float32, hbuf [N+1, B, H]
// in the weight type (hbuf[t+1] = h_seq[t], hbuf[0] = round(h0)) and
// hfin [B, H] float32.  bf16: `plan` as srnn_gru_seq_fits's, flags
// [blocks * 32] int32 zero.  Returns a cudaError_t (0 = launched).
extern "C" int srnn_gru_seq_fwd(const void* x, const float* h0,
                                const void* wih, const float* bih,
                                const void* whh, const float* bhh, float* xg,
                                void* hbuf, float* hg, float* hfin,
                                int* flags, int n, int b, int hdim,
                                int w_bf16, const int* plan, void* stream) {
  if (hdim % U) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = gemm<false, false, float>(w_bf16, x, hdim, wih, 3 * hdim,
                                            bih, xg, 3 * hdim, n * b,
                                            3 * hdim, hdim, s);
  if (err) return err;
  if (w_bf16)
    return launch_tc<Lib>(false, hbuf, n, b, hdim, plan, s, xg, h0, whh, bhh,
                          hbuf, hg, hfin, flags);
  return launch_fma<Lib>(false, hdim, s, xg, h0, whh, bhh, hbuf, hg, hfin, n,
                         b, hdim);
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
  const int err =
      w_bf16 ? launch_tc<Lib>(true, dhg, n, b, hdim, plan, s, xg, hg, h0,
                              hbuf, dh_seq, dh_fin, whh, dxg, dhg, dh0, dbih,
                              dbhh, bpart, flags)
             : launch_fma<Lib>(true, hdim, s, xg, hg, h0, hbuf, dh_seq,
                               dh_fin, whh, dxg, dhg, dh0, dbih, dbhh, n, b,
                               hdim);
  if (err) return err;
  return bwd_gemms<Lib>(w_bf16, x, wih, hbuf, dxg, dhg, dx, dwih, dwhh, n, b,
                        hdim, s);
}

// Phase trace of the bf16 chains (scripts/seq_trace.py): a device buffer
// of int64 [tc::TRACE_STEPS * 16 + 4], or null to stop.
extern "C" void srnn_gru_seq_trace(void* buf) {
  g_trace = static_cast<unsigned long long*>(buf);
}
