// K1: batched Montgomery product over Fr or Fq.
//
// Replaces the Pallas kernel paillier_halo2_tpu/ff/pallas_mulmod.py:372
// (`mont_mul_pallas`, body `MulPlan._body_conv` :284-330), which computed the
// product on 32 x 8-bit digits with bf16 MXU convolutions. Here each thread
// owns one lane and runs 8 x 32-bit CIOS on PTX carry chains (field.cuh
// `mul_cc`); no digit convolutions, no shared memory.
//
// Bound: at 2^16 lanes and above, memory: 96 B per lane (two 32 B operands
// in, one 32 B result out) at 3.35 TB/s, against 264 32-bit multiply-adds
// per product at the card's integer rate, which is about twice as fast.
// Loads are coalesced by the limb-first (8, N) layout. Fusing the product
// into its callers, which would move fewer bytes, is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

template <class F>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[pht::kLimbs], y[pht::kLimbs], r[pht::kLimbs];
  pht::load(x, a, n, i);
  pht::load(y, b, n, i);
  pht::mul_cc<F>(r, x, y);
  pht::store(out, n, i, r);
}

}  // namespace

// a, b, out: (8, n) uint32 limb-first. field: 0 = Fr, 1 = Fq.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pht_mont_mul(const void* a, const void* b, void* out, long long n, int field,
                            void* stream) {
  if (n <= 0) return 0;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  if (field == 0) {
    mont_mul_kernel<pht::Fr><<<grid, kThreads, 0, s>>>(pa, pb, po, n);
  } else if (field == 1) {
    mont_mul_kernel<pht::Fq><<<grid, kThreads, 0, s>>>(pa, pb, po, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
