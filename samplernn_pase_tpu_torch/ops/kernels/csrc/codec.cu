// K7 codec: the mu-law encode and decode of [rows, cols] arrays.
//
// Replaces samplernn_pase_tpu/ops/pallas/codec.py (_encode_kernel,
// _decode_kernel through _tiled_call): elementwise tiles of 2048 columns,
// float32 waveform -> int32 levels and back, the decode tail of the
// generation path.  The function is ops/mulaw.py's, in its order of
// operations:
//   encode: x = clamp(x, -1, 1)
//           y = sign(x) * log1p(mu * |x|) / log1p(mu)
//           level = clamp(floor((y + 1) * 0.5 * mu + 0.5), 0, q - 1)
//   decode: y = 2 * (level / mu) - 1
//           x = sign(y) * expm1(|y| * log1p(mu)) / mu
// with mu = q - 1.  Each product, sum and quotient is its own correctly
// rounded float32 operation (__fmul_rn, __fadd_rn, __fdiv_rn), so nvcc
// cannot contract two of them into one FMA: PyTorch runs each as a
// separate elementwise kernel, rounding after every step, and a fused
// multiply-add that rounds once can move a level at a boundary.  log1pf
// and expm1f are the CUDA math library's, the functions PyTorch's
// log1p/expm1 kernels call on the card (not correctly rounded there, nor
// on the CPU: the reference holds the decode within 3 ulp across them).
//
// Bound on the H100: bytes.  Each element reads 4 bytes and writes 4; at
// [128, 16384] that is 16.8 MB, 5.0 us at 3.35 TB/s; the arithmetic, two
// transcendental functions per element, is far below the float32 rate.
// A block walks one row (grid y) in 256-column strides (grid x), so no
// thread divides an index and consecutive threads read and write
// consecutive addresses.  Rows may be strided (a view of the generation
// buffer needs no copy); the last axis is contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// torch.sign: 1, -1 or 0 (NaN stays NaN through the product)
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__global__ void __launch_bounds__(THREADS)
mu_law_encode_kernel(const float* __restrict__ x, int64_t ldx,
                     int32_t* __restrict__ out, int64_t ldo, int rows,
                     int cols, int q_levels) {
  const float mu = static_cast<float>(q_levels - 1);
  const float lmu = log1pf(mu);
  const float top = static_cast<float>(q_levels - 1);
  for (int r = blockIdx.y; r < rows; r += gridDim.y)
  for (int c = blockIdx.x * THREADS + threadIdx.x; c < cols;
       c += gridDim.x * THREADS) {
    float v = x[r * ldx + c];
    v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);   // torch.clamp keeps NaN
    const float y = __fdiv_rn(
        __fmul_rn(sign_of(v), log1pf(__fmul_rn(mu, fabsf(v)))), lmu);
    float lv = floorf(__fadd_rn(
        __fmul_rn(__fmul_rn(__fadd_rn(y, 1.f), 0.5f), mu), 0.5f));
    lv = lv < 0.f ? 0.f : (lv > top ? top : lv);
    out[r * ldo + c] = static_cast<int32_t>(lv);
  }
}

__global__ void __launch_bounds__(THREADS)
mu_law_decode_kernel(const int32_t* __restrict__ lv, int64_t ldl,
                     float* __restrict__ out, int64_t ldo, int rows,
                     int cols, int q_levels) {
  const float mu = static_cast<float>(q_levels - 1);
  const float lmu = log1pf(mu);
  for (int r = blockIdx.y; r < rows; r += gridDim.y)
  for (int c = blockIdx.x * THREADS + threadIdx.x; c < cols;
       c += gridDim.x * THREADS) {
    const float l = static_cast<float>(lv[r * ldl + c]);
    const float y = __fadd_rn(__fmul_rn(2.f, __fdiv_rn(l, mu)), -1.f);
    out[r * ldo + c] = __fdiv_rn(
        __fmul_rn(sign_of(y), expm1f(__fmul_rn(fabsf(y), lmu))), mu);
  }
}

dim3 grid_for(int rows, int cols) {
  const int x = (cols + THREADS - 1) / THREADS;
  return dim3(x < 1 ? 1 : (x > 65535 ? 65535 : x),
              rows < 1 ? 1 : (rows > 65535 ? 65535 : rows));
}

}  // namespace

extern "C" int srnn_mu_law_encode(const float* x, int64_t ldx, int32_t* out,
                                  int64_t ldo, int rows, int cols,
                                  int q_levels, void* stream) {
  mu_law_encode_kernel<<<grid_for(rows, cols), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, ldx, out, ldo, rows, cols, q_levels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srnn_mu_law_decode(const int32_t* lv, int64_t ldl, float* out,
                                  int64_t ldo, int rows, int cols,
                                  int q_levels, void* stream) {
  mu_law_decode_kernel<<<grid_for(rows, cols), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lv, ldl, out, ldo, rows, cols, q_levels);
  return static_cast<int>(cudaGetLastError());
}
