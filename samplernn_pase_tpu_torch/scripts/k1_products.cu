// K1's tensor-core products in isolation (csrc/frame_decode.cu, namespace
// tcd): the product of resident weight boxes with a 16-lane panel, timed
// in each form a block of two warpgroups can run it, against the shared-
// memory floor.  Nothing of the kind runs in the package.  Built and run
// by
//
//   python -m samplernn_pase_tpu_torch.scripts.k1_products
//
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//  -o build/k1_products samplernn_pase_tpu_torch/scripts/k1_products.cu).
//
// One block of 256 threads holds four boxes in K1's layout (128 K-rows x
// 64 columns of bf16 with the 128-byte swizzle: two K-chunks x two
// 64-column tiles) and 16 lanes over those 256 rows (K-major 64-column
// panels with the same swizzle, the layout of h1 and h2), and multiplies
// them `reps` times in one of six forms:
//   0 ss_wgmma  warpgroup w on tile w: 8 wgmma m64n16k16 a box, weights
//               and lanes read by descriptor (K1 before the mma.sync
//               products);
//   1 rs_wgmma  the same with the weights in registers (ldmatrix.trans);
//   2 mma16     mma.sync m16n8k16 from ldmatrix fragments, warpgroup w on
//               tile w, each warp 16 columns over all 256 rows;
//   3 mma32     K1's layer-2 split: warp w takes K-chunk w / 4 and 32
//               columns of one tile, each lane fragment used 4 times;
//   4, 5        mma32 with K1's mbarrier traffic a box: every thread
//               waits for the box to have landed (a completed phase), and
//               frees it with an arrival of every thread (4,
//               mma32_arrive_thread) or of one lane a warp (5,
//               mma32_arrive_warp).
// Every form loads its fragments anew each rep (the addresses carry a
// term that is 0 but unknown to the compiler, so no load is hoisted).
// Each form's sum is checked against the host's (the inputs are
// multiples of 1/128, so every sum is exact in float32).  Then each form
// runs `reps` times and prints SM clocks per box (clock64) and us per box
// (the SM clock against %globaltimer), per 16,384 multiply-adds (one
// m64n16k16; a box is 8), and its ratio to the floor: each box (16 KB)
// and panel (4 KB) read once from shared memory at 128 bytes a clock,
// 160 clocks a box.

#include "../ops/kernels/csrc/sm90.cuh"

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

using namespace srnn::sm90;

namespace {

constexpr int LT = 16;                   // lanes
constexpr int BOXB = 128 * 64 * 2;       // bytes of a box
constexpr int NBOX = 4;                  // (K-chunk, tile), chunk-major
constexpr int KTOT = 256;                // rows of the four boxes
constexpr int NCOL = 128;                // columns of the two tiles
constexpr int SMEM = 1024 + NBOX * BOXB + LT * KTOT * 2;
constexpr int FLOOR_CLOCKS = (BOXB + LT * 128 * 2) / 128;
constexpr int FORMS = 6;
const char* const NAMES[FORMS] = {"ss_wgmma", "rs_wgmma", "mma16",
                                 "mma32", "mma32_arrive_thread",
                                 "mma32_arrive_warp"};

#define CHECK(x)                                                        \
  do {                                                                  \
    const cudaError_t e_ = (x);                                         \
    if (e_ != cudaSuccess) {                                            \
      std::printf("CUDA error %s at line %d\n", cudaGetErrorString(e_), \
                  __LINE__);                                            \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

// inputs: multiples of 1/128 in [-1, 1), exact in bf16
__host__ __device__ inline float value(uint32_t i) {
  i ^= i >> 16;
  i *= 0x7feb352du;
  i ^= i >> 15;
  i *= 0x846ca68bu;
  i ^= i >> 16;
  return static_cast<float>(static_cast<int>(i & 0xFF) - 128) / 128.f;
}
__host__ __device__ inline float w_at(int k, int n) {
  return value(static_cast<uint32_t>(k * NCOL + n));
}
__host__ __device__ inline float h_at(int l, int k) {
  return value((1u << 20) | static_cast<uint32_t>(l * KTOT + k));
}

// byte offset of weight (k, n) in the boxes, and of lane l's row k
__device__ inline int box_off(int k, int n) {
  const int b = (k / 128) * 2 + n / 64, kr = k % 128, c = n % 64;
  return b * BOXB + kr * 128 + (((c / 8) ^ (kr % 8)) * 16) + (c % 8) * 2;
}
__device__ inline int kmajor(int l, int k) {
  return (k / 64) * LT * 128 + l * 128 + ((((k % 64) / 8) ^ (l % 8)) * 16) +
         (k % 8) * 2;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// D += A[64x16] @ B[16x16] with A from registers (each warp's 16 rows as
// an mma.sync A fragment) and B by descriptor, K-major
__device__ __forceinline__ void wgmma_rs16(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int FORM>
__global__ void __launch_bounds__(256, 1)
products(float* out, int reps, unsigned long long* clk) {
  __shared__ __align__(8) uint64_t bars[2];   // a landed box, its reads
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* boxes = smem;
  uint8_t* h = smem + NBOX * BOXB;
  const int tid = threadIdx.x;
  for (int e = tid; e < KTOT * NCOL; e += 256)
    *reinterpret_cast<__nv_bfloat16*>(boxes + box_off(e / NCOL, e % NCOL)) =
        __float2bfloat16_rn(w_at(e / NCOL, e % NCOL));
  for (int e = tid; e < LT * KTOT; e += 256)
    *reinterpret_cast<__nv_bfloat16*>(h + kmajor(e / KTOT, e % KTOT)) =
        __float2bfloat16_rn(h_at(e / KTOT, e % KTOT));
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 256);
    mbar_arrive(&bars[0]);   // phase 0 of "landed" complete
  }
  fence_proxy_async();   // the generic writes, to wgmma
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wg = warp / 4, wi = warp % 4;
  const int lane = tid % 32, g = lane / 4, c = lane % 4, mi = lane / 8;
  const uint32_t box_u = smem_u32(boxes), h_u = smem_u32(h);
  // ldmatrix rows: the lanes' (A) row and K half, the weights' (B) K row
  // within a 16-row step and 8-column half
  const int al = (mi & 1) * 8 + lane % 8, ak = mi >> 1;
  const int bk = (mi & 1) * 8 + lane % 8, bc = mi >> 1;
  auto lanes_at = [&](int s) {   // A fragment address of K-step s
    return h_u + kmajor(al, 16 * s + 8 * ak);
  };
  auto weights_at = [&](uint32_t box, int sl, int col) {   // col % 16 == 0
    const int kr = 16 * sl + bk;
    return box + kr * 128 + ((((col / 8) + bc) ^ (kr % 8)) * 16);
  };
  unsigned long long t0 = 0, n0 = 0;
  if (tid == 0) {
    n0 = globaltimer();
    t0 = clock64();
  }

  // 0 for every rep, though the compiler cannot tell: the fragments are
  // loaded anew each rep, not hoisted out of the loop
  const uint32_t zero = static_cast<uint32_t>(reps >> 30);
  if constexpr (FORM <= 1) {
    float acc[8] = {};
    uint32_t ra[2][8][4];
    for (int r = 0; r < reps; ++r) {
      const uint32_t salt = (r & zero) * 1024;
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        const uint32_t a0 = box_u + (kc * 2 + wg) * BOXB + salt;
        const uint32_t b0 = h_u + kc * 2 * LT * 128;
        if constexpr (FORM == 1) {
#pragma unroll
          for (int sl = 0; sl < 8; ++sl) {   // rows 16 wi.. of the tile
            const int k = 16 * sl + (mi >> 1) * 8 + lane % 8;
            ldmatrix4<true>(ra[kc][sl],
                            a0 + k * 128 +
                                (((2 * wi + (mi & 1)) ^ (k % 8)) * 16));
          }
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const uint64_t db =
              desc(b0 + (s / 4) * LT * 128 + (s % 4) * 32, 16, 1024, 1);
          if constexpr (FORM == 0)
            wgmma<LT, 1, 0>(acc, desc(a0 + s * 2048, 8192, 1024, 1), db, 1);
          else
            wgmma_rs16(acc, ra[kc][s], db);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();
    if (tid == 0) {
      clk[0] = clock64() - t0;
      clk[1] = globaltimer() - n0;
    }
    const int m0 = 16 * wi + g;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          out[(8 * nn + 2 * c + jj) * NCOL + 64 * wg + m0 + 8 * hh] =
              acc[4 * nn + 2 * hh + jj];
  } else {
    constexpr int NT = FORM == 2 ? 2 : 4;   // n8 tiles a warp
    float acc[NT][4] = {};
    const int kh = FORM == 2 ? 0 : wg;
    const int mt = FORM == 2 ? wg : wi / 2;
    const int col = FORM == 2 ? 16 * wi : 32 * (wi % 2);   // in the tile
    for (int r = 0; r < reps; ++r) {
      const uint32_t salt = (r & zero) * 1024;
#pragma unroll
      for (int kc = FORM == 2 ? 0 : kh; kc < (FORM == 2 ? 2 : kh + 1); ++kc) {
        const uint32_t box = box_u + (kc * 2 + mt) * BOXB + salt;
        if constexpr (FORM >= 4) {   // K1's wait for the landed box
          uint32_t done = 0;
          while (!done)
            asm volatile(
                "{\n.reg .pred p;\n"
                "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                "selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done) : "r"(smem_u32(&bars[0])) : "memory");
        }
#pragma unroll
        for (int sl = 0; sl < 8; ++sl) {
          uint32_t a[4], b[4];
          ldmatrix4<false>(a, lanes_at(8 * kc + sl) + salt);
#pragma unroll
          for (int q = 0; q < NT / 2; ++q) {
            ldmatrix4<true>(b, weights_at(box, sl, col + 16 * q));
            mma_bf16(acc[2 * q], a, b[0], b[1]);
            mma_bf16(acc[2 * q + 1], a, b[2], b[3]);
          }
        }
        if constexpr (FORM == 4) {   // the box freed by every thread
          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], 4;\n"
                       :: "r"(smem_u32(&bars[1])) : "memory");
        } else if constexpr (FORM == 5) {   // or by one lane a warp
          __syncwarp();
          if (lane == 0)
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], 128;\n"
                         :: "r"(smem_u32(&bars[1])) : "memory");
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      clk[0] = clock64() - t0;
      clk[1] = globaltimer() - n0;
    }
    float* o = out + kh * LT * NCOL;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          o[(g + 8 * hh) * NCOL + 64 * mt + col + 8 * t + 2 * c + jj] =
              acc[t][2 * hh + jj];
  }
}

struct Result {
  double err, clocks_per_box, ghz;
};

template <int FORM>
Result run(float* d_out, unsigned long long* d_clk,
           const std::vector<double>& ref, int reps) {
  CHECK(cudaFuncSetAttribute(products<FORM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM));
  std::vector<float> got(2 * LT * NCOL);
  CHECK(cudaMemset(d_out, 0, got.size() * sizeof(float)));
  products<FORM><<<1, 256, SMEM>>>(d_out, 1, d_clk);
  CHECK(cudaGetLastError());
  CHECK(cudaDeviceSynchronize());
  CHECK(cudaMemcpy(got.data(), d_out, got.size() * sizeof(float),
                   cudaMemcpyDeviceToHost));
  Result res{0.0, 0.0, 0.0};
  for (int e = 0; e < LT * NCOL; ++e)
    res.err = std::fmax(res.err,
                        std::fabs(got[e] + got[LT * NCOL + e] - ref[e]));
  products<FORM><<<1, 256, SMEM>>>(d_out, reps / 8, d_clk);   // warm
  products<FORM><<<1, 256, SMEM>>>(d_out, reps, d_clk);
  CHECK(cudaGetLastError());
  CHECK(cudaDeviceSynchronize());
  unsigned long long clk[2];
  CHECK(cudaMemcpy(clk, d_clk, sizeof(clk), cudaMemcpyDeviceToHost));
  res.clocks_per_box = static_cast<double>(clk[0]) / (4.0 * reps);
  res.ghz = static_cast<double>(clk[0]) / static_cast<double>(clk[1]);
  return res;
}

}  // namespace

int main(int argc, char** argv) {
  const int reps = argc > 1 ? std::atoi(argv[1]) : 4096;
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::vector<double> ref(LT * NCOL, 0.0);
  for (int l = 0; l < LT; ++l)
    for (int n = 0; n < NCOL; ++n)
      for (int k = 0; k < KTOT; ++k)
        ref[l * NCOL + n] += static_cast<double>(h_at(l, k)) * w_at(k, n);
  float* d_out;
  unsigned long long* d_clk;
  CHECK(cudaMalloc(&d_out, 2 * LT * NCOL * sizeof(float)));
  CHECK(cudaMalloc(&d_clk, 2 * sizeof(unsigned long long)));
  const Result res[FORMS] = {
      run<0>(d_out, d_clk, ref, reps), run<1>(d_out, d_clk, ref, reps),
      run<2>(d_out, d_clk, ref, reps), run<3>(d_out, d_clk, ref, reps),
      run<4>(d_out, d_clk, ref, reps), run<5>(d_out, d_clk, ref, reps)};
  std::printf("%s: %d reps of 4 boxes (128 x 64 bf16) x 16 lanes; floor "
              "%d SM clocks a box (box and panel read once at 128 B a "
              "clock)\n", prop.name, reps, FLOOR_CLOCKS);
  bool ok = true;
  std::string json;
  for (int f = 0; f < FORMS; ++f) {
    const Result& r = res[f];
    const double us = r.clocks_per_box / r.ghz / 1e3;
    ok = ok && r.err <= 1e-3;
    std::printf("%-19s max err %.3g, %.1f SM clocks (%.4f us at %.3f GHz) a "
                "box, %.2f a 16,384 multiply-adds, %.2fx the floor\n",
                NAMES[f], r.err, r.clocks_per_box, us, r.ghz,
                r.clocks_per_box / 8, r.clocks_per_box / FLOOR_CLOCKS);
    char buf[512];
    std::snprintf(buf, sizeof(buf),
                  "%s\"%s\": {\"max_err\": %.3g, \"clocks_per_box\": %.2f, "
                  "\"us_per_box\": %.5f, \"clocks_per_16k_mac\": %.3f, "
                  "\"x_floor\": %.3f, \"sm_ghz\": %.4f}",
                  f ? ", " : "", NAMES[f], r.err, r.clocks_per_box, us,
                  r.clocks_per_box / 8, r.clocks_per_box / FLOOR_CLOCKS,
                  r.ghz);
    json += buf;
  }
  std::printf("{\"card\": \"%s\", \"reps\": %d, \"floor_clocks_per_box\": "
              "%d, \"forms\": {%s}, \"ok\": %s}\n", prop.name, reps,
              FLOOR_CLOCKS, json.c_str(), ok ? "true" : "false");
  return ok ? 0 : 1;
}
