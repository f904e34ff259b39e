// The Fq Montgomery product in each schedule, counted and timed on the card:
//   cios      `redc_product` (field.cuh), C++ 64-bit CIOS, what K1, K3, K4,
//             K6 and K7 use;
//   chain     `redc_product_cc` (field.cuh), even/odd PTX carry chains, what
//             K2, the window sums, K5 and the bucket loop use.
// `probe_<schedule>[_canonical]` computes one product, for counting its SASS
// instructions (`cuobjdump --dump-sass`); `loop_<schedule>` chains 256
// redundant-form products a thread. main() times the loops over 270,336
// threads, checks that every schedule gives the same bits, and prints one
// line per schedule. Not part of the kernel library: `chip_smoke.py` phase 1
// builds it with `nvcc -I csrc` and runs it.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include "field.cuh"

namespace {

using F = pht::Fq;
constexpr int L = pht::kLimbs;

// kForm: 0 cios, 1 chain (redundant form); 2 cios, 3 chain (canonical).
template <int kForm>
__device__ __forceinline__ void product(uint32_t r[L], const uint32_t a[L], const uint32_t b[L]) {
  if (kForm == 0) pht::mul_lazy<F>(r, a, b);
  if (kForm == 1) pht::mul_lazy_cc<F>(r, a, b);
  if (kForm == 2) pht::mul<F>(r, a, b);
  if (kForm == 3) pht::mul_cc<F>(r, a, b);
}

template <int kForm>
__device__ __forceinline__ void one_product(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t x[L], y[L], z[L];
  pht::load(x, a, 1, 0);
  pht::load(y, b, 1, 0);
  product<kForm>(z, x, y);
  pht::store(r, 1, 0, z);
}

template <int kForm>
__global__ void loop_kernel(const uint32_t* x, const uint32_t* y, uint32_t* out, int n,
                            int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[L], b[L], r[L];
  pht::load(a, x, n, i);
  pht::load(b, y, n, i);
#pragma unroll 1
  for (int it = 0; it < iters; it++) {
    product<kForm>(r, a, b);
    pht::copy(a, r);
  }
  pht::store(out, n, i, a);
}

}  // namespace

extern "C" __global__ void probe_cios(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  one_product<0>(a, b, r);
}
extern "C" __global__ void probe_chain(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  one_product<1>(a, b, r);
}
extern "C" __global__ void probe_cios_canonical(const uint32_t* a, const uint32_t* b,
                                                uint32_t* r) {
  one_product<2>(a, b, r);
}
extern "C" __global__ void probe_chain_canonical(const uint32_t* a, const uint32_t* b,
                                                 uint32_t* r) {
  one_product<3>(a, b, r);
}

int main() {
  const int n = 132 * 16 * 128, iters = 256, threads = 128, reps = 5;
  std::vector<uint32_t> hx(L * n), hy(L * n), ref(L * n), got(L * n);
  uint32_t s = 12345u;  // xorshift; top limb below p's keeps every value below p
  for (int k = 0; k < L * n; k++) {
    s ^= s << 13, s ^= s >> 17, s ^= s << 5;
    hx[k] = s;
    s ^= s << 13, s ^= s >> 17, s ^= s << 5;
    hy[k] = s;
  }
  for (int i = 0; i < n; i++) hx[7 * n + i] %= 0x30644e72u, hy[7 * n + i] %= 0x30644e72u;
  uint32_t *x, *y, *o;
  const size_t bytes = sizeof(uint32_t) * L * n;
  cudaMalloc(&x, bytes), cudaMalloc(&y, bytes), cudaMalloc(&o, bytes);
  cudaMemcpy(x, hx.data(), bytes, cudaMemcpyHostToDevice);
  cudaMemcpy(y, hy.data(), bytes, cudaMemcpyHostToDevice);
  const char* names[2] = {"cios", "chain"};
  int failed = 0;
  for (int v = 0; v < 2; v++) {
    auto launch = [&]() {
      const int grid = (n + threads - 1) / threads;
      if (v == 0) loop_kernel<0><<<grid, threads>>>(x, y, o, n, iters);
      if (v == 1) loop_kernel<1><<<grid, threads>>>(x, y, o, n, iters);
    };
    launch();
    cudaEvent_t start, end;
    cudaEventCreate(&start), cudaEventCreate(&end);
    cudaEventRecord(start);
    for (int r = 0; r < reps; r++) launch();
    cudaEventRecord(end);
    cudaEventSynchronize(end);
    float ms = 0;
    cudaEventElapsedTime(&ms, start, end);
    ms /= reps;
    cudaMemcpy(got.data(), o, bytes, cudaMemcpyDeviceToHost);
    if (v == 0) ref = got;
    const bool same = std::memcmp(ref.data(), got.data(), bytes) == 0;
    const cudaError_t err = cudaGetLastError();
    failed |= !same || err != cudaSuccess;
    std::printf("%s: %d threads x %d chained products in %.4f ms = %.3f G products/s; "
                "bits equal to cios: %s; %s\n",
                names[v], n, iters, ms, (double)n * iters / ms / 1e6, same ? "yes" : "NO",
                cudaGetErrorString(err));
  }
  return failed;
}
