// Batched addition and subtraction over Fr or Fq, one launch a call, on any
// two broadcastable limb-first operands.
//
// Replaces the Python carry loops of ff/field.py (`add_plain`, `sub_plain`):
// 8 limbs widened to int64, a carry chain, a conditional subtraction of p,
// a select, two stacks and the narrowing to int32, about 87 elementwise
// launches a call. The JAX package left these ops to XLA
// (paillier_halo2_tpu/ff/field_jax.py `add`, `sub`), so no `pallas_call` is
// this kernel's counterpart. Each thread owns one lane of the contiguous
// (8, *batch) output: it finds its lane's offsets in a and b from up to four
// batch dimensions' sizes and strides (stride 0 for a broadcast dimension)
// and each operand's limb stride, so broadcast, narrowed and strided views
// are read where they lie, with no copy. It runs field.cuh's `add_cc` or
// `sub_cc`, which take the plain version's steps on PTX carry chains, and
// stores the canonical result limb-first.
//
// Bound: memory, 96 B a lane (two 32 B operands in, one 32 B result out) at
// 3.35 TB/s. The carry chains are about 40 integer instructions a lane, and
// the lane's index is split by at most three 32-bit divisions (an output of
// 2^32 lanes would take 137 GB, more than the card holds); both hide under
// the loads. A broadcast operand is read once
// from memory and then from cache. Fusing the add into its callers' products
// and stacks, which would move fewer bytes, is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 4;

// Where each operand's lanes lie, in elements: the batch dimensions
// outermost first (the first `ndim` entries are used), and the limb stride.
struct Layout {
  int64_t size[kMaxDims];
  int64_t stride_a[kMaxDims];
  int64_t stride_b[kMaxDims];
  int64_t limb_a, limb_b;
};

template <class F, bool kSub>
__global__ void field_addsub_kernel(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b,
                                    uint32_t* __restrict__ out, Layout d, int ndim, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t rem = (uint32_t)i;
  int64_t oa = 0, ob = 0;
#pragma unroll
  for (int k = kMaxDims - 1; k > 0; k--) {  // innermost first; dimension 0 takes the rest
    if (k < ndim) {
      const uint32_t s = (uint32_t)d.size[k];
      const uint32_t q = rem / s;
      const int64_t j = (int64_t)(rem - q * s);
      oa += j * d.stride_a[k];
      ob += j * d.stride_b[k];
      rem = q;
    }
  }
  oa += (int64_t)rem * d.stride_a[0];
  ob += (int64_t)rem * d.stride_b[0];
  uint32_t x[pht::kLimbs], y[pht::kLimbs], r[pht::kLimbs];
#pragma unroll
  for (int k = 0; k < pht::kLimbs; k++) {
    x[k] = a[oa + k * d.limb_a];
    y[k] = b[ob + k * d.limb_b];
  }
  if constexpr (kSub) {
    pht::sub_cc<F>(r, x, y);
  } else {
    pht::add_cc<F>(r, x, y);
  }
  pht::store(out, n, i, r);
}

template <class F, bool kSub>
void launch(const uint32_t* a, const uint32_t* b, uint32_t* out, const Layout& d, int ndim,
            int64_t n, cudaStream_t s) {
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  field_addsub_kernel<F, kSub><<<grid, kThreads, 0, s>>>(a, b, out, d, ndim, n);
}

template <class F>
void launch_op(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, const Layout& d,
               int ndim, int64_t n, cudaStream_t s) {
  if (op) {
    launch<F, true>(a, b, out, d, ndim, n, s);
  } else {
    launch<F, false>(a, b, out, d, ndim, n, s);
  }
}

}  // namespace

// out: (8, n) uint32 limb-first, contiguous; a, b: the operands' first
// elements. layout: 14 int64s, the batch sizes (4), a's strides (4), b's
// strides (4), a's and b's limb strides; ndim in [1, 4]; n below 2^32.
// op: 0 = add, 1 = sub. field: 0 = Fr, 1 = Fq. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int pht_field_addsub(const void* a, const void* b, void* out, const long long* layout,
                                int ndim, long long n, int op, int field, void* stream) {
  if (n <= 0) return 0;
  if (n > (long long)UINT32_MAX || ndim < 1 || ndim > kMaxDims || op < 0 || op > 1) {
    return (int)cudaErrorInvalidValue;
  }
  Layout d;
  for (int k = 0; k < kMaxDims; k++) {
    d.size[k] = layout[k];
    d.stride_a[k] = layout[kMaxDims + k];
    d.stride_b[k] = layout[2 * kMaxDims + k];
  }
  d.limb_a = layout[3 * kMaxDims];
  d.limb_b = layout[3 * kMaxDims + 1];
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  if (field == 0) {
    launch_op<pht::Fr>(op, pa, pb, po, d, ndim, n, s);
  } else if (field == 1) {
    launch_op<pht::Fq>(op, pa, pb, po, d, ndim, n, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
