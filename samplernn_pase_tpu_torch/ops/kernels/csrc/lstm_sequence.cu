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
// float32 dW accumulators resident in VMEM; the design here is K4's, one
// chain engine (seq_chain.cuh) with this file's LSTM cell:
//
// forward (srnn_lstm_seq_fwd): G = round(X) @ Wih + bih over all N*B rows,
//   then the chain adds round(h_{t-1}) @ Whh + bhh to its columns of G (G
//   becomes the gate pre-activations, kept as the backward pass's one
//   residual: the reference's recompute reads the same rounded operands,
//   so the values are the same), carries c in float32 (c is the block's
//   own, no exchange) and writes h_seq and c_seq rounded.
// backward (srnn_lstm_seq_bwd): the chain forms its units' gate gradients
//   from G, the rounded c_seq (c_{t-1} and c_t read back rounded, as the
//   reference does; c0 is float32) and the carries dh, dc, keeps dc_{t-1}
//   = dc * f in float32, then computes dh_{t-1} = round(dG_t) @ Whh^T;
//   then dX = round(dG) @ Wih^T, dWih = round(X)^T @ round(dG) and dWhh =
//   round(H_prev)^T @ round(dG).
//
// Bound on the H100: operations at the long tiers, bytes at the short
// one.  Config 2 (B=64, H=1024, bf16) does 2 products of 2*B*H*4H per step
// forward and 4 backward: 69.5 / 17.4 / 4.3 us forward and 139.0 / 34.7 /
// 8.7 us backward at N = 64 / 16 / 4 at 989 TFLOP/s; at N=4 the bytes bind
// instead (the weights, G and the stored sequences, about 24 MB forward;
// the float32 dW too backward).  With bf16 weights, at config 2's B=64 a
// block of 8 units keeps its 64 KB Whh slice and a whole step's boxes (all
// of h_{t-1} for its 64 rows, 128 KB) in shared memory.  The chains are
// bound by their per-step latency, not by the card's rates.

#include "seq_chain.cuh"

namespace {

// The LSTM cell (gates i, f, g, o) of the chains, for row at.row, unit
// at.j: the forward keeps the pre-activations in G, the backward carries
// dh and dc.
struct LstmCell {
  static constexpr int G = 4;   // gates
  static constexpr int K = 2;   // the backward's carries: dh, dc

  template <typename WT>
  struct Fwd {   // the forward chain's arguments
    float* g;   // round(x) @ Wih + bih in, the pre-activations out
    const float *h0, *c0;
    const WT* whh;
    const float* bhh;
    WT *hbuf, *cseq;
    float *hfin, *cfin;
  };
  struct FwdIn { float x[4], cp; };        // G's gates, c_{t-1} (float32)
  struct FwdOut { float pre[4], c, h; };   // the pre-activations, c_t, h_t

  template <typename WT, class LD>
  static __device__ __forceinline__ void fwd_load(const Fwd<WT>& p,
                                                  FwdIn& in, const Elem& at,
                                                  bool ok, LD ld) {
#pragma unroll
    for (int q = 0; q < 4; ++q) in.x[q] = ok ? ld(p.g + at.gate(4, q)) : 0.f;
    in.cp = !ok ? 0.f : ld((at.t == 0 ? p.c0 : p.cfin) + at.o());
  }

  // hq = round(h_{t-1}) @ Whh + bhh
  static __device__ __forceinline__ void fwd_math(const FwdIn& in,
                                                  const float (&hq)[4],
                                                  FwdOut& out) {
#pragma unroll
    for (int q = 0; q < 4; ++q) out.pre[q] = in.x[q] + hq[q];
    const float ig = sigmoidf(out.pre[0]), fg = sigmoidf(out.pre[1]),
                tg = tanhf(out.pre[2]), og = sigmoidf(out.pre[3]);
    out.c = fg * in.cp + ig * tg;
    out.h = og * tanhf(out.c);
  }

  // what no other block waits for: the pre-activations into G, c_seq
  // (rounded) and the float32 carries
  template <typename WT>
  static __device__ __forceinline__ void fwd_store(const Fwd<WT>& p,
                                                   const FwdOut& out,
                                                   const Elem& at) {
#pragma unroll
    for (int q = 0; q < 4; ++q) p.g[at.gate(4, q)] = out.pre[q];
    p.cseq[at.seq(at.t)] = from_f32<WT>(out.c);
    p.hfin[at.o()] = out.h;
    p.cfin[at.o()] = out.c;
  }

  template <typename WT>
  struct Bwd {   // the backward chain's arguments
    const float *g, *c0;
    const WT *cseq, *dh_seq;
    const float* dfin[K];   // dh_fin, dc_fin
    const WT* whh;
    WT* dg;
    float* d0[K];           // dh0, dc0, which hold the carries between steps
    float *dbih, *dbhh;
  };
  // dh_seq, c_{t-1} (c0, else the stored round(c_{t-1})), round(c_t), the
  // pre-activations
  struct BwdIn { float dh, cp, ct, g[4]; };

  template <typename WT, class LD>
  static __device__ __forceinline__ void bwd_load(const Bwd<WT>& p,
                                                  BwdIn& in, const Elem& at,
                                                  bool ok, LD ld) {
    in.dh = ok ? ld(p.dh_seq + at.seq(at.t)) : 0.f;
    in.cp = !ok ? 0.f : at.t == 0 ? ld(p.c0 + at.o())
          : ld(p.cseq + at.seq(at.t - 1));
    in.ct = ok ? ld(p.cseq + at.seq(at.t)) : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) in.g[q] = ok ? ld(p.g + at.gate(4, q)) : 0.f;
  }

  // The gate gradients dv = dG's four; mid[1] = dc * f, the dc carry (dh's
  // is the product alone: mid[0] is not set).
  static __device__ __forceinline__ void bwd_math(const BwdIn& in,
                                                  const float (&cin)[K],
                                                  float (&dv)[4],
                                                  float (&mid)[K]) {
    const float gh = cin[0] + in.dh;
    const float ig = sigmoidf(in.g[0]), fg = sigmoidf(in.g[1]),
                tg = tanhf(in.g[2]), og = sigmoidf(in.g[3]);
    const float tc = tanhf(in.ct);
    const float d_o = gh * tc;
    const float dc = gh * og * (1.f - tc * tc) + cin[1];
    const float di = dc * tg, df = dc * in.cp, dgg = dc * ig;
    dv[0] = di * ig * (1.f - ig);
    dv[1] = df * fg * (1.f - fg);
    dv[2] = dgg * (1.f - tg * tg);
    dv[3] = d_o * og * (1.f - og);
    mid[1] = dc * fg;
  }

  // dG, which the other blocks' products wait for
  template <typename WT>
  static __device__ __forceinline__ void store_dg(const Bwd<WT>& p,
                                                  const float (&dv)[4],
                                                  const Elem& at) {
#pragma unroll
    for (int q = 0; q < 4; ++q) p.dg[at.gate(4, q)] = from_f32<WT>(dv[q]);
  }

  // nothing else: dG serves both products (g = xg + hg)
  template <typename WT>
  static __device__ __forceinline__ void store_rest(const Bwd<WT>&,
                                                    const float (&)[4],
                                                    const Elem&) {}

  // The carries the gate math hands on, to dst(k) (registers, or dc0
  // between the row passes): dc_{t-1}.
  template <class Dst>
  static __device__ __forceinline__ void hand_on(const float (&mid)[K],
                                                 Dst dst) {
    dst(1) = mid[1];
  }

  // dh_{t-1} = round(dG_t) @ Whh^T
  static __device__ __forceinline__ float dh_after(float, float prod) {
    return prod;
  }

  // The block's bias sums for unit j, the same into both biases: g = xg +
  // hg, so both bias paths see the same gate gradients.
  template <typename WT>
  static __device__ __forceinline__ void bias(const Bwd<WT>& p,
                                              const float* a, int j,
                                              int hdim) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      p.dbih[q * hdim + j] = a[q];
      p.dbhh[q * hdim + j] = a[q];
    }
  }
};

// ---- the chains' kernels (the bodies are in seq_chain.cuh) ----

__global__ void __launch_bounds__(THREADS)
lstmseq_fwd_chain(float* __restrict__ g, const float* __restrict__ h0,
                  const float* __restrict__ c0, const float* __restrict__ whh,
                  const float* __restrict__ bhh, float* hbuf,
                  float* __restrict__ cseq, float* __restrict__ hfin,
                  float* __restrict__ cfin, int n, int b, int hdim) {
  fma_fwd_chain<LstmCell>({g, h0, c0, whh, bhh, hbuf, cseq, hfin, cfin}, n, b,
                          hdim);
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
  fma_bwd_chain<LstmCell>({g, c0, cseq, dh_seq, {dh_fin, dc_fin}, whh, dg,
                           {dh0, dc0}, dbih, dbhh},
                          dg, n, b, hdim);
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
  tc_fwd_chain<LstmCell, UN, WG, NB>(
      &hmap, c, {g, h0, c0, whh, bhh, hbuf, cseq, hfin, cfin}, flags);
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
  tc_bwd_chain<LstmCell, UN, WG, NB>(
      &gmap, c,
      {g, c0, cseq, dh_seq, {dh_fin, dc_fin}, whh, dg, {dh0, dc0}, dbih,
       dbhh},
      bpart, flags);
}

// The kernels by plan, for the host side (seq_chain.cuh)
struct Lib : LstmCell {
  static const void* fma_chain(bool bwd) {
    return bwd ? reinterpret_cast<const void*>(&lstmseq_bwd_chain)
               : reinterpret_cast<const void*>(&lstmseq_fwd_chain);
  }
  template <int UN, int WG, int NB>
  static const void* tc_chain(bool bwd) {
    return bwd
        ? reinterpret_cast<const void*>(&lstmseq_bwd_chain_tc<UN, WG, NB>)
        : reinterpret_cast<const void*>(&lstmseq_fwd_chain_tc<UN, WG, NB>);
  }
};

}  // namespace

// Whether both serial kernels run at width hdim on this device (seq_fits):
// 0 yes, 1 their shared memory exceeds a block's, 2 their blocks cannot all
// be resident, negative a cudaError_t.  `plan` as rnn_train.chain_plan's
// ({units, warpgroups, rows per block, ring slots, chunks per slot}).
extern "C" int srnn_lstm_seq_fits(int hdim, int w_bf16, const int* plan) {
  return seq_fits<Lib>(hdim, w_bf16, plan);
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
  const int err = gemm<false, false, float>(w_bf16, x, hdim, wih, 4 * hdim,
                                            bih, g, 4 * hdim, n * b,
                                            4 * hdim, hdim, s);
  if (err) return err;
  if (w_bf16)
    return launch_tc<Lib>(false, hbuf, n, b, hdim, plan, s, g, h0, c0, whh,
                          bhh, hbuf, cseq, hfin, cfin, flags);
  return launch_fma<Lib>(false, hdim, s, g, h0, c0, whh, bhh, hbuf, cseq,
                         hfin, cfin, n, b, hdim);
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
  const int err =
      w_bf16 ? launch_tc<Lib>(true, dg, n, b, hdim, plan, s, g, c0, cseq,
                              dh_seq, dh_fin, dc_fin, whh, dg, dh0, dc0, dbih,
                              dbhh, bpart, flags)
             : launch_fma<Lib>(true, hdim, s, g, c0, cseq, dh_seq, dh_fin,
                               dc_fin, whh, dg, dh0, dc0, dbih, dbhh, n, b,
                               hdim);
  if (err) return err;
  return bwd_gemms<Lib>(w_bf16, x, wih, hbuf, dg, dg, dx, dwih, dwhh, n, b,
                        hdim, s);
}

// Phase trace of the bf16 chains (scripts/seq_trace.py): a device buffer
// of int64 [tc::TRACE_STEPS * 16 + 4], or null to stop.
extern "C" void srnn_lstm_seq_trace(void* buf) {
  g_trace = static_cast<unsigned long long*>(buf);
}
