// K6 lstm_gates: the LSTM cell's elementwise gate math.
//
// Replaces the LSTM gate step of samplernn_pase_tpu/ops/pallas/megagen.py
// (_gates, LSTM branch) and ops/pallas/decode.py (_tier_frame_kernel,
// :113-123): with g = (x@W_ih + b_ih) + (h@W_hh + b_hh) (gates i, f, g, o
// in the cuDNN order; K2 forms it in one buffer, its epilogue adding the
// input gates to the recurrent product),
//   c' = sigmoid(g_f) * c + sigmoid(g_i) * tanh(g_g),
//   h' = sigmoid(g_o) * tanh(c'),
// all float32.
//
// Bound on the H100: bytes.  At B=128, H=1024 it reads 2 MB of gates and
// 0.5 MB of cell state and writes 2 x 0.5 MB, about 1.0 us at 3.35 TB/s
// (less from L2, where the gates were just written); one thread per
// output element with coalesced rows is all it needs, as K3.

#include "common.cuh"

namespace {

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void lstm_gates_kernel(const float* __restrict__ g, int64_t ldg,
                                  const float* __restrict__ c, int64_t ldc,
                                  float* __restrict__ h_out,
                                  float* __restrict__ c_out, int b,
                                  int hdim) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(b) * hdim) return;
  const int row = static_cast<int>(idx / hdim);
  const int col = static_cast<int>(idx % hdim);
  const float* gr = g + row * ldg + col;
  const float ig = sigmoidf(gr[0]);
  const float fg = sigmoidf(gr[hdim]);
  const float tg = tanhf(gr[2 * hdim]);
  const float og = sigmoidf(gr[3 * hdim]);
  const float cnew = fg * c[row * ldc + col] + ig * tg;
  c_out[idx] = cnew;
  h_out[idx] = og * tanhf(cnew);
}

}  // namespace

// g [B, 4H] and c [B, H] float32 with row strides ldg and ldc; writes
// h_out and c_out [B, H] float32, contiguous.  Returns a cudaError_t.
extern "C" int srnn_lstm_gates(const float* g, int64_t ldg, const float* c,
                               int64_t ldc, float* h_out, float* c_out, int b,
                               int hdim, void* stream) {
  const int threads = 256;
  const int64_t total = static_cast<int64_t>(b) * hdim;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  lstm_gates_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      g, ldg, c, ldc, h_out, c_out, b, hdim);
  return static_cast<int>(cudaGetLastError());
}
