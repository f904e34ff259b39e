// K7: batched lazy Montgomery product over Fr or Fq, redundant form.
//
// Replaces the Pallas kernel paillier_halo2_tpu/ff/lazy_mont.py:301
// (`mont_mul_lazy_pallas`, body `lmul` :142-185), which multiplied signed
// int16 digit rows and left the result a*b*R^-1 + k*p for a small k. Here
// each thread owns one lane and runs the 8 x 32-bit CIOS of K1 without its
// final conditional subtraction (field.cuh `mul_lazy`): inputs and output in
// [0, 2p), the output congruent to a*b*R^-1 mod p. The int16 digit storage
// was a TPU trick to halve HBM traffic on a 5-8 GB chip; I/O here is the
// port's (8, N) limb format.
//
// Bound: at 2^16 lanes and above, memory: 96 B per lane (two 32 B operands
// in, one out) at 3.35 TB/s against 264 32-bit multiply-adds per product at
// the card's integer rate, which is about twice as fast. Loads coalesce
// through the limb-first layout. Faster forms are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

template <class F>
__global__ void mont_mul_lazy_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b,
                                     uint32_t* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[pht::kLimbs], y[pht::kLimbs], r[pht::kLimbs];
  pht::load(x, a, n, i);
  pht::load(y, b, n, i);
  pht::mul_lazy<F>(r, x, y);
  pht::store(out, n, i, r);
}

}  // namespace

// a, b, out: (8, n) uint32 limb-first, values in [0, 2p). field: 0 = Fr,
// 1 = Fq. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pht_mont_mul_lazy(const void* a, const void* b, void* out, long long n,
                                 int field, void* stream) {
  if (n <= 0) return 0;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  if (field == 0) {
    mont_mul_lazy_kernel<pht::Fr><<<grid, kThreads, 0, s>>>(pa, pb, po, n);
  } else if (field == 1) {
    mont_mul_lazy_kernel<pht::Fq><<<grid, kThreads, 0, s>>>(pa, pb, po, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
