// K5, K6: the signed-window MSM's G1 additions over Fq on redundant-form
// accumulators (field.cuh: every coordinate in [0, 2p), Montgomery form,
// infinity encoded as Z == 0 exactly).
//
// Replaces the Pallas kernels of paillier_halo2_tpu/ec/lazy_point.py:
//   g1_madd_lazy -> K5 `padd_mixed_packed_lazy` (:172, `_mixed_kernel` :150-168,
//                   formula `_mixed_add_lazy` :51-92): one bucket step, the
//                   accumulator plus an affine point from a packed (n, 16) row,
//                   negated (y -> p - y) where `neg` is set, passed through
//                   where `mask_off` is set;
//   g1_jadd_lazy -> K6 `padd_lazy` (:220, `_jadd_kernel` :205-216, formula
//                   `_jacobian_add_lazy` :95-129): the sub-accumulator merge,
//                   either side possibly at infinity.
// The formulas are K3's and K2's (g1_add.cu) with every product, sum and
// difference taken in the redundant form, so no normalisation runs inside
// the hot formula; the MSM canonicalises once after the merge. Both are
// nodouble only: a lane with P == +-Q gets h == 0 mod p, so Z3 = Z1*h (K5)
// or Z1*Z2*h (K6) is zero mod p -- a soft infinity that canonicalises to
// Z == 0, never a wrong finite point (lazy_point.py:11-14). The selects keep
// the JAX package's order: in K6 the q_inf select is outermost (:124-126),
// so with both sides at infinity X3, Y3 come from P, unlike K2.
//
// One thread per lane, 128 threads a block, ragged edge masked in the kernel.
// Bound: integer multiply-adds, 11 (K5) or 16 (K6) Montgomery products of
// 264 each per lane, against 258 or 288 bytes of traffic; registers limit
// the blocks in flight, as for the nodouble variants of g1_add.cu.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using F = pht::Fq;
constexpr int kThreads = 128;
constexpr int L = pht::kLimbs;

// (X1, Y1, Z1) + affine (X2, Y2), as `_mixed_add_lazy`; q_inf marks the
// affine operand as infinity (the bucket loop's mask_off).
__device__ __forceinline__ void madd_lazy(uint32_t X3[L], uint32_t Y3[L], uint32_t Z3[L],
                                          const uint32_t X1[L], const uint32_t Y1[L],
                                          const uint32_t Z1[L], const uint32_t X2[L],
                                          const uint32_t Y2[L], bool q_inf) {
  uint32_t z1z1[L], u2[L], s2[L], h[L], r[L], t[L], hhh[L], v[L];
  pht::mul_lazy<F>(z1z1, Z1, Z1);
  pht::mul_lazy<F>(u2, X2, z1z1);
  pht::mul_lazy<F>(t, Z1, z1z1);
  pht::mul_lazy<F>(s2, Y2, t);
  pht::sub_lazy<F>(h, u2, X1);
  pht::sub_lazy<F>(r, s2, Y1);

  pht::mul_lazy<F>(t, h, h);      // hh
  pht::mul_lazy<F>(hhh, h, t);    // hhh
  pht::mul_lazy<F>(v, X1, t);     // v = X1 * hh
  pht::mul_lazy<F>(t, r, r);      // rr
  pht::sub_lazy<F>(X3, t, hhh);
  pht::add_lazy<F>(t, v, v);
  pht::sub_lazy<F>(X3, X3, t);
  pht::sub_lazy<F>(t, v, X3);
  pht::mul_lazy<F>(t, r, t);
  pht::mul_lazy<F>(u2, Y1, hhh);  // u2 reused as Y1 * hhh
  pht::sub_lazy<F>(Y3, t, u2);
  pht::mul_lazy<F>(Z3, Z1, h);

  const bool p_inf = pht::is_zero(Z1);
  uint32_t one[L], zero[L];
  pht::set_one<F>(one);
  pht::set_zero(zero);
  // inf + Q -> Q with Z = one (or infinity when Q is too)
  pht::select(X3, p_inf, X2, X3);
  pht::select(Y3, p_inf, Y2, Y3);
  pht::select(t, q_inf, zero, one);
  pht::select(Z3, p_inf, t, Z3);
  // P + inf -> P
  pht::select(X3, q_inf, X1, X3);
  pht::select(Y3, q_inf, Y1, Y3);
  pht::select(Z3, q_inf, Z1, Z3);
}

// (X1, Y1, Z1) + (X2, Y2, Z2), as `_jacobian_add_lazy`.
__device__ __forceinline__ void jadd_lazy(uint32_t X3[L], uint32_t Y3[L], uint32_t Z3[L],
                                          const uint32_t X1[L], const uint32_t Y1[L],
                                          const uint32_t Z1[L], const uint32_t X2[L],
                                          const uint32_t Y2[L], const uint32_t Z2[L]) {
  uint32_t z1z1[L], z2z2[L], u1[L], u2[L], s1[L], s2[L], h[L], r[L], t[L], hhh[L], v[L];
  pht::mul_lazy<F>(z1z1, Z1, Z1);
  pht::mul_lazy<F>(z2z2, Z2, Z2);
  pht::mul_lazy<F>(u1, X1, z2z2);
  pht::mul_lazy<F>(u2, X2, z1z1);
  pht::mul_lazy<F>(t, Z2, z2z2);
  pht::mul_lazy<F>(s1, Y1, t);
  pht::mul_lazy<F>(t, Z1, z1z1);
  pht::mul_lazy<F>(s2, Y2, t);
  pht::sub_lazy<F>(h, u2, u1);
  pht::sub_lazy<F>(r, s2, s1);

  pht::mul_lazy<F>(t, h, h);      // hh
  pht::mul_lazy<F>(hhh, h, t);    // hhh
  pht::mul_lazy<F>(v, u1, t);     // v = u1 * hh
  pht::mul_lazy<F>(t, r, r);      // rr
  pht::sub_lazy<F>(X3, t, hhh);
  pht::add_lazy<F>(t, v, v);
  pht::sub_lazy<F>(X3, X3, t);
  pht::sub_lazy<F>(t, v, X3);
  pht::mul_lazy<F>(t, r, t);
  pht::mul_lazy<F>(s1, s1, hhh);
  pht::sub_lazy<F>(Y3, t, s1);
  pht::mul_lazy<F>(t, Z1, Z2);
  pht::mul_lazy<F>(Z3, t, h);

  const bool p_inf = pht::is_zero(Z1);
  const bool q_inf = pht::is_zero(Z2);
  pht::select(X3, p_inf, X2, X3);
  pht::select(Y3, p_inf, Y2, Y3);
  pht::select(Z3, p_inf, Z2, Z3);
  pht::select(X3, q_inf, X1, X3);
  pht::select(Y3, q_inf, Y1, Y3);
  pht::select(Z3, q_inf, Z1, Z3);
}

// The affine operand arrives as (n, 16) rows, words 0-7 = X limbs, 8-15 = Y
// limbs (canonical Montgomery, the pack_points_dense layout K4 reads).
__global__ void g1_madd_lazy_kernel(const uint32_t* __restrict__ x1,
                                    const uint32_t* __restrict__ y1,
                                    const uint32_t* __restrict__ z1,
                                    const uint32_t* __restrict__ rows,
                                    const uint8_t* __restrict__ mask_off,
                                    const uint8_t* __restrict__ neg, uint32_t* __restrict__ ox,
                                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                                    int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t X1[L], Y1[L], Z1[L], X2[L], Y2[L], X3[L], Y3[L], Z3[L];
  pht::load(X1, x1, n, i);
  pht::load(Y1, y1, n, i);
  pht::load(Z1, z1, n, i);
  const uint32_t* row = rows + i * 2 * L;
#pragma unroll
  for (int k = 0; k < L; k++) {
    X2[k] = row[k];
    Y2[k] = row[L + k];
  }
  if (neg[i]) {  // -P = (x, p - y): y in [0, p) gives p - y in (0, p]
    uint32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < L; k++) {
      uint64_t t = (uint64_t)F::p(k) - Y2[k] - borrow;
      Y2[k] = (uint32_t)t;
      borrow = (uint32_t)(t >> 63);
    }
  }
  madd_lazy(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, mask_off[i] != 0);
  pht::store(ox, n, i, X3);
  pht::store(oy, n, i, Y3);
  pht::store(oz, n, i, Z3);
}

__global__ void g1_jadd_lazy_kernel(const uint32_t* __restrict__ x1,
                                    const uint32_t* __restrict__ y1,
                                    const uint32_t* __restrict__ z1,
                                    const uint32_t* __restrict__ x2,
                                    const uint32_t* __restrict__ y2,
                                    const uint32_t* __restrict__ z2, uint32_t* __restrict__ ox,
                                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                                    int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t X1[L], Y1[L], Z1[L], X2[L], Y2[L], Z2[L], X3[L], Y3[L], Z3[L];
  pht::load(X1, x1, n, i);
  pht::load(Y1, y1, n, i);
  pht::load(Z1, z1, n, i);
  pht::load(X2, x2, n, i);
  pht::load(Y2, y2, n, i);
  pht::load(Z2, z2, n, i);
  jadd_lazy(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
  pht::store(ox, n, i, X3);
  pht::store(oy, n, i, Y3);
  pht::store(oz, n, i, Z3);
}

inline dim3 grid_for(long long n) { return dim3((unsigned)((n + kThreads - 1) / kThreads)); }

}  // namespace

// Accumulators and outputs (8, n) uint32 limb-first in [0, 2p); rows (n, 16)
// uint32; mask_off and neg (n,) bytes, nonzero = set. Each entry returns
// cudaGetLastError() after its launch (0 on success).

extern "C" int pht_g1_madd_lazy(const void* x1, const void* y1, const void* z1, const void* rows,
                                const void* mask_off, const void* neg, void* ox, void* oy,
                                void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  g1_madd_lazy_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)rows,
      (const uint8_t*)mask_off, (const uint8_t*)neg, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int pht_g1_jadd_lazy(const void* x1, const void* y1, const void* z1, const void* x2,
                                const void* y2, const void* z2, void* ox, void* oy, void* oz,
                                long long n, void* stream) {
  if (n <= 0) return 0;
  g1_jadd_lazy_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}
