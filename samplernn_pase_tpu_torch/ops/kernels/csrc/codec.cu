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
// Bound on the H100: bytes, 4 read and 4 written per element (5.0 us at
// [128, 16384] over 3.35 TB/s).  The issue and MUFU bounds, reckoned from
// the item loops of this file's SASS (scripts/codec_bench.py counts them
// in the built library: about 66 instructions and 1 MUFU an element to
// encode, 20 and none to decode, on CUDA 12.8), are below it; the
// one-element-a-thread kernel this replaced issued 84 an element, over
// the bytes bound.  The design:
// * One wave.  The plan (ops/kernels/codec.py, codec_plan: the one owner)
//   sizes the grid to at most the blocks the card holds at once
//   (srnn_codec_resident).  Each block walks a flat range of (row, column
//   chunk) items, row and chunk kept as counters: at most one division per
//   thread, at its start, none per item.
// * 16-byte accesses.  Where every row's input and output start at the
//   same offset within 16 bytes (both pointers agree mod 16 and the two
//   leading dimensions mod 4), a chunk is THREADS x VPT float4 / int4 of
//   the row's aligned body, neighbouring threads on neighbouring vectors;
//   each thread issues its VPT loads before it uses any (VPT 1 where its
//   items fit one wave, else 4).  The row's first 0-3 elements
//   (up to its first 16-byte boundary) are scalar, taken by its first
//   chunk, and its last 0-3 by its last chunk.  Elsewhere every access is
//   scalar, 4 of them per thread.
// * Decode through a table.  A block fills a shared-memory table of the q
//   levels with decode_level, the function the formula path runs, so each
//   entry is the formula's value by construction; it does so after its
//   first loads are issued.  An element is then a load, a range check, a
//   shared-memory read and a store.  A level outside [0, q) takes the
//   formula (the plain version gives it a value too).  Above TABLE_CAP
//   levels decode runs the formula throughout.
// * Encode keeps its rounded arithmetic (log1pf and the IEEE division by
//   log1p(mu) in their order: a reciprocal would round differently); only
//   the exact steps around it are cheaper (encode_level).
// Rows may be strided (a view of the generation buffer needs no copy);
// the last axis is contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TABLE_CAP = 4096;        // levels: 16 KB of shared memory

// torch.sign: 1, -1 or 0 (NaN stays NaN through the product)
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// sign(x) * log1p(mu |x|) is a product by +-1 or 0, exact: copying x's
// sign onto log1p(mu |x|) gives the same y but for the sign of a zero,
// which y + 1 drops.  floor, the clamp to [0, q - 1] and the conversion
// are one round-down conversion and an integer clamp (a NaN converts to
// 0 either way).
__device__ __forceinline__ int32_t encode_level(float v, float mu, float lmu,
                                                int top) {
  v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);     // torch.clamp keeps NaN
  const float y = __fdiv_rn(
      copysignf(log1pf(__fmul_rn(mu, fabsf(v))), v), lmu);
  const int lv = __float2int_rd(__fadd_rn(
      __fmul_rn(__fmul_rn(__fadd_rn(y, 1.f), 0.5f), mu), 0.5f));
  return lv < 0 ? 0 : (lv > top ? top : lv);
}

__device__ __forceinline__ float decode_level(int32_t lv, float mu,
                                              float lmu) {
  const float l = static_cast<float>(lv);
  const float y = __fadd_rn(__fmul_rn(2.f, __fdiv_rn(l, mu)), -1.f);
  return __fdiv_rn(
      __fmul_rn(sign_of(y), expm1f(__fmul_rn(fabsf(y), lmu))), mu);
}

// The same functions out of line, for the paths an item rarely takes (a
// row's scalar head and tail, a level outside [0, q)): the item loop
// keeps only the call, so its SASS is the hot path's.
__device__ __noinline__ int32_t encode_one(float v, float mu, float lmu,
                                           int top) {
  return encode_level(v, mu, lmu, top);
}

__device__ __noinline__ float decode_one(int32_t lv, float mu, float lmu) {
  return decode_level(lv, mu, lmu);
}

struct Encode {
  using In = float;
  using Out = int32_t;
  static constexpr bool kTable = false;
  float mu, lmu;
  int top;
  __device__ explicit Encode(int q)
      : mu(static_cast<float>(q - 1)), lmu(log1pf(mu)), top(q - 1) {}
  __device__ int32_t one(float v) const {
    return encode_one(v, mu, lmu, top);
  }
  template <int N>
  __device__ void run(const float* v, int32_t* o) const {
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = encode_level(v[k], mu, lmu, top);
  }
};

template <bool TABLE>
struct Decode {
  using In = int32_t;
  using Out = float;
  static constexpr bool kTable = TABLE;
  float mu, lmu;
  int q;
  const float* tab = nullptr;
  __device__ explicit Decode(int q_levels)
      : mu(static_cast<float>(q_levels - 1)), lmu(log1pf(mu)),
        q(q_levels) {}
  __device__ void fill(float* table) const {
    for (int l = threadIdx.x; l < q; l += THREADS)
      table[l] = decode_level(l, mu, lmu);
  }
  __device__ bool in_range(int32_t l) const {
    return static_cast<unsigned>(l) < static_cast<unsigned>(q);
  }
  __device__ float one(int32_t l) const {
    return TABLE && in_range(l) ? tab[l] : decode_one(l, mu, lmu);
  }
  template <int N>
  __device__ void run(const int32_t* v, float* o) const {
    if constexpr (TABLE) {
      bool all = true;
#pragma unroll
      for (int k = 0; k < N; ++k) all &= in_range(v[k]);
      if (all) {
#pragma unroll
        for (int k = 0; k < N; ++k) o[k] = tab[v[k]];
      } else {    // a level outside [0, q) (rare): the formula, out of line
#pragma unroll
        for (int k = 0; k < N; ++k) o[k] = decode_one(v[k], mu, lmu);
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) o[k] = decode_level(v[k], mu, lmu);
    }
  }
};

template <class T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int32_t> { using type = int4; };

template <int W, class T>
__device__ __forceinline__ void load(const T* p, T* dst) {
  if constexpr (W == 4) {
    const typename Vec4<T>::type t =
        __ldg(reinterpret_cast<const typename Vec4<T>::type*>(p));
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else {
    dst[0] = __ldg(p);
  }
}

template <int W, class T>
__device__ __forceinline__ void store(T* p, const T* src) {
  if constexpr (W == 4) {
    typename Vec4<T>::type t;
    t.x = src[0]; t.y = src[1]; t.z = src[2]; t.w = src[3];
    *reinterpret_cast<typename Vec4<T>::type*>(p) = t;
  } else {
    p[0] = src[0];
  }
}

// The body of both kernels: W elements per access (4: float4/int4, 1:
// scalar), VPT accesses per thread per item.  An item is one chunk of
// THREADS * VPT accesses of one row (`chunks` of them a row, the last 0-3
// elements of a vector row with its last); block b takes items
// [b * per_block, (b + 1) * per_block) of `items`.
template <class Op, int W, int VPT>
__device__ __forceinline__ void codec_body(
    const typename Op::In* __restrict__ x, int64_t ldx,
    typename Op::Out* __restrict__ out, int64_t ldo, int cols, int chunks,
    int per_block, int items, int q, float* table) {
  using In = typename Op::In;
  using Out = typename Op::Out;
  constexpr int PER = THREADS * VPT;
  int i = blockIdx.x * per_block;
  const int end = i + per_block < items ? i + per_block : items;
  if (i >= end) return;                          // the whole block
  int r = i, c = 0;              // rows of one chunk: no division
  if (chunks > 1) {
    r = i / chunks;
    c = i - r * chunks;
  }
  const int t = threadIdx.x;
  // row r's pointers and, for 16-byte accesses, its scalar head (elements
  // before its first 16-byte line) and its body in accesses
  const In* xr;
  Out* orow;
  int head, body;
  auto row = [&] {
    xr = x + r * ldx;
    orow = out + r * ldo;
    head = 0;
    body = cols;
    if constexpr (W == 4) {
      head = static_cast<int>(
          (0u - static_cast<unsigned>(reinterpret_cast<uintptr_t>(xr) >> 2))
          & 3u);
      head = head < cols ? head : cols;
      body = (cols - head) >> 2;
    }
  };
  In v[VPT * W];
  Out o[VPT * W];
  auto load_item = [&] {          // all VPT loads before any is used
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int a = c * PER + j * THREADS + t;
      if (a < body) load<W>(xr + head + a * W, v + j * W);
    }
  };
  row();
  load_item();
  Op op(q);                       // log1p(mu) on the card, as the plain's
  if constexpr (Op::kTable) {     // the table, while the first loads fly
    op.tab = table;
    op.fill(table);
    __syncthreads();
  }
  for (;;) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int a = c * PER + j * THREADS + t;
      if (a < body) {
        op.template run<W>(v + j * W, o + j * W);
        store<W>(orow + head + a * W, o + j * W);
      }
    }
    if constexpr (W == 4) {
      if (c == 0 && t < head) orow[t] = op.one(xr[t]);
      const int e = head + 4 * body + t;          // the row's last 0-3
      if (c == chunks - 1 && e < cols) orow[e] = op.one(xr[e]);
    }
    if (++i == end) break;
    if (++c == chunks) {
      c = 0;
      ++r;
      row();
    }
    load_item();
  }
}

template <int W, int VPT>
__global__ void __launch_bounds__(THREADS)
mu_law_encode_kernel(const float* __restrict__ x, int64_t ldx,
                     int32_t* __restrict__ out, int64_t ldo, int cols,
                     int chunks, int per_block, int items, int q) {
  codec_body<Encode, W, VPT>(x, ldx, out, ldo, cols, chunks, per_block,
                             items, q, nullptr);
}

template <bool TABLE, int W, int VPT>
__global__ void __launch_bounds__(THREADS)
mu_law_decode_kernel(const int32_t* __restrict__ lv, int64_t ldl,
                     float* __restrict__ out, int64_t ldo, int cols,
                     int chunks, int per_block, int items, int q) {
  extern __shared__ float table[];               // q floats with TABLE
  codec_body<Decode<TABLE>, W, VPT>(lv, ldl, out, ldo, cols, chunks,
                                    per_block, items, q, table);
}

using EncodeFn = void (*)(const float*, int64_t, int32_t*, int64_t, int, int,
                          int, int, int);
using DecodeFn = void (*)(const int32_t*, int64_t, float*, int64_t, int, int,
                          int, int, int);

// The instantiation of a plan's (vec, vpt), or null: the pairs
// codec_plan gives.
EncodeFn encode_kernel(int vec, int vpt) {
  if (vec == 4 && vpt == 1) return mu_law_encode_kernel<4, 1>;
  if (vec == 4 && vpt == 4) return mu_law_encode_kernel<4, 4>;
  if (vec == 1 && vpt == 4) return mu_law_encode_kernel<1, 4>;
  return nullptr;
}

template <bool TABLE>
DecodeFn decode_kernel(int vec, int vpt) {
  if (vec == 4 && vpt == 1) return mu_law_decode_kernel<TABLE, 4, 1>;
  if (vec == 4 && vpt == 4) return mu_law_decode_kernel<TABLE, 4, 4>;
  if (vec == 1 && vpt == 4) return mu_law_decode_kernel<TABLE, 1, 4>;
  return nullptr;
}

constexpr int VPT_PAIRS[3][2] = {{4, 1}, {4, 4}, {1, 4}};

// plan: {vec, vpt, threads, blocks, table}, codec.py's CodecPlan.  Fills
// g = {chunks a row, items a block, items} and returns 0 if the plan fits
// the call: 256 threads, at least one block, items and blocks below 2**31,
// and 16-byte accesses only where every row's input and output agree mod
// 16 bytes.
int plan_grid(const void* x, int64_t ldx, const void* out, int64_t ldo,
              int rows, int cols, int q, const int* plan, int* g) {
  if (!plan || q < 2 || rows < 0 || cols < 0 || plan[2] != THREADS ||
      plan[3] < 1 || (plan[0] != 4 && plan[0] != 1) || plan[1] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (plan[0] == 4 && (((reinterpret_cast<uintptr_t>(x) ^
                         reinterpret_cast<uintptr_t>(out)) & 15) ||
                       ((ldx - ldo) & 3)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per = static_cast<int64_t>(THREADS) * plan[1];
  const int64_t width = plan[0] == 4 ? cols / 4 : cols;
  const int64_t chunks = width > per ? (width + per - 1) / per : 1;
  const int64_t items = rows * chunks;
  if (items + plan[3] >= (int64_t{1} << 31))   // block starts fit an int
    return static_cast<int>(cudaErrorInvalidValue);
  g[0] = static_cast<int>(chunks);
  g[1] = static_cast<int>((items + plan[3] - 1) / plan[3]);
  g[2] = static_cast<int>(items);
  return 0;
}

__global__ void codec_floor_kernel() {}

}  // namespace

// K7's entries: the plan's kernel on `stream`, or cudaErrorInvalidValue
// for a plan that does not fit the call (nothing launched).  An encode
// plan carries table 0.
extern "C" int srnn_mu_law_encode(const float* x, int64_t ldx, int32_t* out,
                                  int64_t ldo, int rows, int cols,
                                  int q_levels, const int* plan,
                                  void* stream) {
  int g[3];
  int err = plan_grid(x, ldx, out, ldo, rows, cols, q_levels, plan, g);
  if (!err && plan[4]) err = static_cast<int>(cudaErrorInvalidValue);
  const EncodeFn k = err ? nullptr : encode_kernel(plan[0], plan[1]);
  if (!k) return err ? err : static_cast<int>(cudaErrorInvalidValue);
  k<<<plan[3], THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ldx, out, ldo, cols, g[0], g[1], g[2], q_levels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srnn_mu_law_decode(const int32_t* lv, int64_t ldl, float* out,
                                  int64_t ldo, int rows, int cols,
                                  int q_levels, const int* plan,
                                  void* stream) {
  int g[3];
  int err = plan_grid(lv, ldl, out, ldo, rows, cols, q_levels, plan, g);
  if (!err && plan[4] && q_levels > TABLE_CAP)
    err = static_cast<int>(cudaErrorInvalidValue);
  const DecodeFn k = err ? nullptr
                         : plan[4] ? decode_kernel<true>(plan[0], plan[1])
                                   : decode_kernel<false>(plan[0], plan[1]);
  if (!k) return err ? err : static_cast<int>(cudaErrorInvalidValue);
  k<<<plan[3], THREADS, plan[4] ? q_levels * sizeof(float) : 0,
      static_cast<cudaStream_t>(stream)>>>(lv, ldl, out, ldo, cols, g[0],
                                           g[1], g[2], q_levels);
  return static_cast<int>(cudaGetLastError());
}

// out[0]: the blocks of THREADS each SM holds at once, the fewest over one
// direction's kernels (decode's table ones with TABLE_CAP levels); out[1]:
// the current device's SMs.  codec_plan sizes one wave from them; the
// wrapper asks once per device and direction.
extern "C" int srnn_codec_resident(int decode, int* out) {
  int dev = 0, least = 1 << 30;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount,
                                 dev);
  for (int table = 0; table <= decode && !err; ++table) {
    for (const auto& p : VPT_PAIRS) {
      const void* fn =
          !decode ? reinterpret_cast<const void*>(encode_kernel(p[0], p[1]))
          : table ? reinterpret_cast<const void*>(
                        decode_kernel<true>(p[0], p[1]))
                  : reinterpret_cast<const void*>(
                        decode_kernel<false>(p[0], p[1]));
      int n = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fn, THREADS, table ? TABLE_CAP * sizeof(float) : 0);
      least = n < least ? n : least;
      if (err) break;
    }
  }
  out[0] = least;
  return static_cast<int>(err);
}

// An empty kernel on a grid of gx x gy blocks of `threads`: the launch
// floor beside K7's own time (scripts/codec_bench.py).
extern "C" int srnn_codec_floor(int gx, int gy, int threads, void* stream) {
  codec_floor_kernel<<<dim3(gx, gy), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
