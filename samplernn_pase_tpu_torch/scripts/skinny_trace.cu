// Phase trace of K2's skinny wgmma core on the card: where a product's
// time goes inside the kernel (nothing of the kind runs in the package).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -DSKINNY_TRACE -o build/skinny_trace \
//     samplernn_pase_tpu_torch/scripts/skinny_trace.cu && build/skinny_trace
//
// It builds csrc/gemm_bias.cu with the core's trace points compiled in
// (skinny_gemm.cuh, SKINNY_TRACE), runs K2 (srnn_gemm_bias) at the main
// decode paths' bf16 products with the plans decode.gemm_plan gives them,
// and prints per product: the time per launch over 200 back-to-back
// launches (CUDA events), the span of one launch from the first CTA's
// entry to the last CTA's exit (%globaltimer), and for each phase of the
// first tile the mean and the largest time since the CTA's entry over the
// CTAs (clock64, converted at the SM clock measured against %globaltimer).
// Inputs are zeros: the time does not depend on the values.

#include "../ops/kernels/csrc/gemm_bias.cu"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>

#define CHECK(x)                                                    \
  do {                                                              \
    const cudaError_t e_ = (x);                                     \
    if (e_ != cudaSuccess) {                                        \
      std::printf("CUDA error %s at line %d\n", cudaGetErrorString(e_), \
                  __LINE__);                                        \
      std::exit(1);                                                 \
    }                                                               \
  } while (0)

// SM cycles per ns: clock64 against %globaltimer over 2 ms
__global__ void clock_rate(unsigned long long* out) {
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  } while (t1 - t0 < 2000000ull);
  out[0] = t1 - t0;
  out[1] = clock64() - c0;
}

struct Case {
  const char* name;
  int m, k, n, levels, with_add, split, bn, groups;   // plan: gemm_plan's
};

int main() {
  const Case cases[] = {
      {"tier0 input +bias +add", 128, 16, 1024, 1, 1, 1, 64, 16},
      {"tier1 input +bias", 128, 64, 1024, 1, 0, 1, 64, 16},
      {"config 2 tier2 input +bias", 128, 256, 1024, 1, 0, 1, 64, 16},
      {"GRU gate +bias", 128, 1024, 3072, 0, 0, 4, 128, 24},
      {"LSTM gate +bias +xg", 128, 1024, 4096, 0, 1, 2, 64, 64},
      {"bottom upsample +bias", 128, 1024, 16384, 0, 0, 1, 128, 128},
      {"cond projection", 3456, 256, 1024, 0, 0, 1, 64, 16},
  };
  const int phases[] = {1, 2, 10, 30, 11, 31, 12, 32, 13, 4, 5, 6, 7, 8};
  const char* phase_names[] = {
      "barriers ready", "A panel 0",   "W stage 0", "A panel 1",
      "W stage 1",      "A panel 2",   "W stage 2", "A panel 3",
      "W stage 3",      "last issued", "wgmma done", "partials",
      "epilogue done",  "exit"};

  unsigned long long* rate;
  CHECK(cudaMalloc(&rate, 16));
  clock_rate<<<1, 1>>>(rate);
  unsigned long long hr[2];
  CHECK(cudaMemcpy(hr, rate, 16, cudaMemcpyDeviceToHost));
  const double ghz = static_cast<double>(hr[1]) / static_cast<double>(hr[0]);
  std::printf("SM clock %.3f GHz\n", ghz);

  cudaStream_t s;
  CHECK(cudaStreamCreate(&s));
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  constexpr int MAX_CTAS = 4096, REPS = 200;
  unsigned long long* trace;
  CHECK(cudaMalloc(&trace, MAX_CTAS * 64 * 8));
  std::vector<unsigned long long> h(MAX_CTAS * 64);
  for (const Case& c : cases) {
    void* a;
    __nv_bfloat16* w;
    float *bias, *add, *out;
    CHECK(cudaMalloc(&a, size_t(c.m) * c.k * 4));
    CHECK(cudaMalloc(&w, size_t(c.k) * c.n * 2));
    CHECK(cudaMalloc(&bias, size_t(c.n) * 4));
    CHECK(cudaMalloc(&add, size_t(c.m) * c.n * 4));
    CHECK(cudaMalloc(&out, size_t(c.m) * c.n * 4));
    CHECK(cudaMemset(a, 0, size_t(c.m) * c.k * 4));
    CHECK(cudaMemset(w, 0, size_t(c.k) * c.n * 2));
    CHECK(cudaMemset(bias, 0, size_t(c.n) * 4));
    CHECK(cudaMemset(add, 0, size_t(c.m) * c.n * 4));
    auto run = [&]() {
      const int err = srnn_gemm_bias(
          a, c.levels, c.k, w, 1, bias, c.with_add ? add : nullptr, c.n, out,
          c.n, c.m, c.n, c.k, 128.f, nullptr, 0, 0, 0, nullptr, 0, 1, c.split,
          c.bn, c.groups, 0, s);
      if (err) {
        std::printf("%s: launch failed (%d)\n", c.name, err);
        std::exit(1);
      }
    };
    unsigned long long* off = nullptr;
    CHECK(cudaMemcpyToSymbol(srnn::skinny::g_trace, &off, sizeof(off)));
    for (int i = 0; i < 20; ++i) run();
    CHECK(cudaEventRecord(e0, s));
    for (int i = 0; i < REPS; ++i) run();
    CHECK(cudaEventRecord(e1, s));
    CHECK(cudaEventSynchronize(e1));
    float ms = 0.f;
    CHECK(cudaEventElapsedTime(&ms, e0, e1));
    // one traced launch after a traced warm one
    CHECK(cudaMemcpyToSymbol(srnn::skinny::g_trace, &trace, sizeof(trace)));
    run();
    CHECK(cudaStreamSynchronize(s));
    CHECK(cudaMemset(trace, 0, MAX_CTAS * 64 * 8));
    run();
    CHECK(cudaStreamSynchronize(s));
    CHECK(cudaMemcpy(h.data(), trace, MAX_CTAS * 64 * 8,
                     cudaMemcpyDeviceToHost));
    const int ctas = c.split * c.groups * ((c.m + 127) / 128);
    unsigned long long first = ~0ull, last = 0;
    for (int i = 0; i < ctas; ++i) {
      first = std::min(first, h[i * 64 + 62]);
      last = std::max(last, h[i * 64 + 63]);
    }
    std::printf("%s [%d,%d]@[%d,%d], plan (%d, %d, %d), %d CTAs: %.2f us "
                "per launch, span %.2f us\n",
                c.name, c.m, c.k, c.k, c.n, c.split, c.bn, c.groups, ctas,
                ms * 1e3 / REPS, (last - first) / 1e3);
    for (int q = 0; q < int(sizeof(phases) / sizeof(phases[0])); ++q) {
      double sum = 0.0, most = 0.0;
      int seen = 0;
      for (int i = 0; i < ctas; ++i) {
        const unsigned long long v = h[i * 64 + phases[q]];
        if (!v) continue;
        const double us = static_cast<double>(v - h[i * 64]) / ghz / 1e3;
        sum += us;
        most = std::max(most, us);
        ++seen;
      }
      if (seen)
        std::printf("  %-15s mean %6.2f max %6.2f us\n", phase_names[q],
                    sum / seen, most);
    }
    CHECK(cudaFree(a));
    CHECK(cudaFree(w));
    CHECK(cudaFree(bias));
    CHECK(cudaFree(add));
    CHECK(cudaFree(out));
  }
  return 0;
}
