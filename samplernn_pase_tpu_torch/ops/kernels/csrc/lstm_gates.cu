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
// Bound on the H100: bytes, about 1.1 us at 3.35 TB/s at B=128, H=1024
// (2 MB of gates and 0.5 MB of cell state read, 2 x 0.5 MB written; the
// gates come from L2, where K2 has just written them).  What a call
// costs beyond that is the launch (an empty kernel on the same grid takes
// about 0.9 us on the card), the loads' latency and the special-function
// unit: each cell takes five exp2 and five reciprocals.  So the kernel
// runs as one wave of 512-thread blocks over a 2-D grid (rows in y,
// column groups in x: no division), each walking rows and columns by
// grid strides, and a thread takes VEC = 2 consecutive units of a row
// where the rows allow 8-byte accesses (decode.lstm_gates_route decides:
// srnn_lstm_gates_vec), one unit otherwise (srnn_lstm_gates).  On the
// card 2 units per thread beat 1 and 4 at every block size from 256 to
// 1024 threads (PERF.md).  The cell's arithmetic
// is the same expression on both routes and the same as before the
// redesign.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int VEC = 2;
constexpr int WAVE_THREADS = 2048;   // resident threads per SM

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void cell(float gi, float gf, float gg, float go,
                                     float c, float* h_out, float* c_out) {
  const float ig = sigmoidf(gi);
  const float fg = sigmoidf(gf);
  const float tg = tanhf(gg);
  const float og = sigmoidf(go);
  const float cnew = fg * c + ig * tg;
  *c_out = cnew;
  *h_out = og * tanhf(cnew);
}

template <int V>
__global__ void __launch_bounds__(THREADS)
lstm_gates_kernel(const float* __restrict__ g, int64_t ldg,
                  const float* __restrict__ c, int64_t ldc,
                  float* __restrict__ h_out, float* __restrict__ c_out,
                  int b, int hdim) {
  const int cols = hdim / V;   // V-unit groups per row
  for (int row = blockIdx.y; row < b; row += gridDim.y) {
    const float* gr = g + row * ldg;
    const float* cr = c + row * ldc;
    const int64_t orow = static_cast<int64_t>(row) * hdim;
    for (int k = blockIdx.x * THREADS + threadIdx.x; k < cols;
         k += gridDim.x * THREADS) {
      const int col = k * V;
      if constexpr (V == 2) {
        const float2 i2 = *reinterpret_cast<const float2*>(gr + col);
        const float2 f2 = *reinterpret_cast<const float2*>(gr + hdim + col);
        const float2 g2 =
            *reinterpret_cast<const float2*>(gr + 2 * hdim + col);
        const float2 o2 =
            *reinterpret_cast<const float2*>(gr + 3 * hdim + col);
        const float2 c2 = *reinterpret_cast<const float2*>(cr + col);
        float2 h, cn;
        cell(i2.x, f2.x, g2.x, o2.x, c2.x, &h.x, &cn.x);
        cell(i2.y, f2.y, g2.y, o2.y, c2.y, &h.y, &cn.y);
        *reinterpret_cast<float2*>(h_out + orow + col) = h;
        *reinterpret_cast<float2*>(c_out + orow + col) = cn;
      } else {
        cell(gr[col], gr[hdim + col], gr[2 * hdim + col], gr[3 * hdim + col],
             cr[col], h_out + orow + col, c_out + orow + col);
      }
    }
  }
}

// One wave: THREADS-thread blocks over (column groups, rows), as many as
// the card's SMs hold at once, rows beyond that by the grid stride.
// Returns a cudaError_t.
int wave_grid(int b, int hdim, int v, dim3* grid) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int gx = (hdim / v + THREADS - 1) / THREADS;
  const int wave = (sms * (WAVE_THREADS / THREADS) + gx - 1) / gx;
  *grid = dim3(gx, b < wave ? b : wave);
  return 0;
}

template <int V>
int launch(const float* g, int64_t ldg, const float* c, int64_t ldc,
           float* h_out, float* c_out, int b, int hdim, void* stream) {
  if (b <= 0 || hdim <= 0) return 0;
  dim3 grid;
  if (int err = wave_grid(b, hdim, V, &grid)) return err;
  lstm_gates_kernel<V><<<grid, THREADS, 0, static_cast<cudaStream_t>(
      stream)>>>(g, ldg, c, ldc, h_out, c_out, b, hdim);
  return static_cast<int>(cudaGetLastError());
}

// K6's floor on the card: a kernel that does nothing, on the vector
// route's grid (chip_smoke.py times it beside K6; the port never calls it)
__global__ void __launch_bounds__(THREADS) empty_kernel() {}

}  // namespace

// g [B, 4H] and c [B, H] float32 with row strides ldg and ldc; writes
// h_out and c_out [B, H] float32, contiguous.  Returns a cudaError_t.
// One unit per thread: every shape and stride.
extern "C" int srnn_lstm_gates(const float* g, int64_t ldg, const float* c,
                               int64_t ldc, float* h_out, float* c_out, int b,
                               int hdim, void* stream) {
  return launch<1>(g, ldg, c, ldc, h_out, c_out, b, hdim, stream);
}

// The same with VEC consecutive units per thread, for rows that allow
// 8-byte accesses: hdim, ldg and ldc even and every pointer 8-byte
// aligned.  decode.lstm_gates_route chooses this entry by the same test
// (keep the two in step); here it only guards the 8-byte accesses:
// anything else is refused with cudaErrorInvalidValue.
extern "C" int srnn_lstm_gates_vec(const float* g, int64_t ldg,
                                   const float* c, int64_t ldc, float* h_out,
                                   float* c_out, int b, int hdim,
                                   void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(c) |
                          reinterpret_cast<uintptr_t>(h_out) |
                          reinterpret_cast<uintptr_t>(c_out);
  if ((align & (4 * VEC - 1)) || (hdim | ldg | ldc) % VEC)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<VEC>(g, ldg, c, ldc, h_out, c_out, b, hdim, stream);
}

// The empty kernel on the vector route's grid at [b, hdim].
extern "C" int srnn_lstm_gates_floor(int b, int hdim, void* stream) {
  if (b <= 0 || hdim <= 0) return 0;
  dim3 grid;
  if (int err = wave_grid(b, hdim, VEC, &grid)) return err;
  empty_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
