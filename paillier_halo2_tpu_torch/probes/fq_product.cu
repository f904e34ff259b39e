// The Fq Montgomery product (`redc_product_cc`, field.cuh: even/odd PTX
// carry chains, what every kernel uses), counted and timed on the card.
// `probe_chain[_canonical]` computes one product in the redundant form
// (`mul_lazy_cc`) or the canonical one (`mul_cc`), for counting its SASS
// instructions (`cuobjdump --dump-sass`); `loop_kernel` chains 256
// redundant-form products a thread. main() times the loop over 270,336
// threads, checks the first 256 threads' results against the same chain
// computed on the host (word-by-word CIOS in 64-bit C++), and prints one
// line. Not part of the kernel library: `chip_smoke.py` phase 1 builds it
// with `nvcc -I csrc` and runs it.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <vector>

#include "field.cuh"

namespace {

using F = pht::Fq;
constexpr int L = pht::kLimbs;
constexpr uint32_t kP[L] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                            0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
constexpr uint32_t kInv = 0xe4866389u;

// kCanonical: mul_cc, else mul_lazy_cc.
template <bool kCanonical>
__device__ __forceinline__ void one_product(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t x[L], y[L], z[L];
  pht::load(x, a, 1, 0);
  pht::load(y, b, 1, 0);
  if (kCanonical) {
    pht::mul_cc<F>(z, x, y);
  } else {
    pht::mul_lazy_cc<F>(z, x, y);
  }
  pht::store(r, 1, 0, z);
}

__global__ void loop_kernel(const uint32_t* x, const uint32_t* y, uint32_t* out, int n,
                            int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[L], b[L], r[L];
  pht::load(a, x, n, i);
  pht::load(b, y, n, i);
#pragma unroll 1
  for (int it = 0; it < iters; it++) {
    pht::mul_lazy_cc<F>(r, a, b);
    pht::copy(a, r);
  }
  pht::store(out, n, i, a);
}

// (a*b + m*p) / R on the host, CIOS with 64-bit accumulators: the value
// `redc_product_cc` computes.
void host_mul_lazy(uint32_t r[L], const uint32_t a[L], const uint32_t b[L]) {
  uint32_t t[L + 2] = {0};
  for (int i = 0; i < L; i++) {
    uint64_t c = 0;
    for (int j = 0; j < L; j++) {
      const uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[L] + c;
    t[L] = (uint32_t)s;
    t[L + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * kInv;
    s = (uint64_t)m * kP[0] + t[0];
    c = s >> 32;
    for (int j = 1; j < L; j++) {
      s = (uint64_t)m * kP[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[L] + c;
    t[L - 1] = (uint32_t)s;
    t[L] = t[L + 1] + (uint32_t)(s >> 32);
  }
  for (int k = 0; k < L; k++) r[k] = t[k];
}

}  // namespace

extern "C" __global__ void probe_chain(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  one_product<false>(a, b, r);
}
extern "C" __global__ void probe_chain_canonical(const uint32_t* a, const uint32_t* b,
                                                 uint32_t* r) {
  one_product<true>(a, b, r);
}

int main() {
  const int n = 132 * 16 * 128, iters = 256, threads = 128, reps = 5, checked = 256;
  std::vector<uint32_t> hx(L * n), hy(L * n), got(L * n);
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
  const int grid = (n + threads - 1) / threads;
  loop_kernel<<<grid, threads>>>(x, y, o, n, iters);
  cudaEvent_t start, end;
  cudaEventCreate(&start), cudaEventCreate(&end);
  cudaEventRecord(start);
  for (int r = 0; r < reps; r++) loop_kernel<<<grid, threads>>>(x, y, o, n, iters);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms = 0;
  cudaEventElapsedTime(&ms, start, end);
  ms /= reps;
  cudaMemcpy(got.data(), o, bytes, cudaMemcpyDeviceToHost);
  const cudaError_t err = cudaGetLastError();
  bool same = true;
  for (int i = 0; i < checked; i++) {
    uint32_t a[L], b[L], r[L];
    for (int k = 0; k < L; k++) a[k] = hx[k * n + i], b[k] = hy[k * n + i];
    for (int it = 0; it < iters; it++) {
      host_mul_lazy(r, a, b);
      for (int k = 0; k < L; k++) a[k] = r[k];
    }
    for (int k = 0; k < L; k++) same &= got[k * n + i] == a[k];
  }
  std::printf("chain: %d threads x %d chained products in %.4f ms = %.3f G products/s; "
              "bits equal to host CIOS on %d threads: %s; %s\n",
              n, iters, ms, (double)n * iters / ms / 1e6, checked, same ? "yes" : "NO",
              cudaGetErrorString(err));
  return !same || err != cudaSuccess;
}
