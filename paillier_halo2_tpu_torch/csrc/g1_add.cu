// K2, K3, K4: batched BN254 G1 point additions over Fq, Jacobian coordinates
// in Montgomery form, infinity encoded as Z == 0 whatever X and Y hold.
//
// Replaces the Pallas kernels of paillier_halo2_tpu/ec/pallas_point.py:
//   g1_jadd<nodouble>          -> K2 `padd_pallas` (:230, `_jacobian_add_full` :137-202)
//   g1_madd<nodouble, false>   -> K3 `padd_mixed_pallas` (:265, `_mixed_add_full` :65-134)
//   g1_madd<nodouble, true>    -> K4 `padd_mixed_packed_pallas` (:309, `_packed_kernel` :292-305)
// The formulas and every edge-case select (P+inf, inf+Q, P+P through the
// doubling branch, P+(-P) to infinity) follow pallas_point.py:93-133 and
// :163-201 in the same order, so outputs are bit-identical to the JAX
// package's, Jacobian representation included. `nodouble` drops the
// doubling branch (7 products) and the h/r zero tests: a lane that breaks
// the caller's distinct-points contract then degrades to Z3 == 0 (h == 0
// makes Z3 = Z1*Z2*h vanish), never to a wrong finite point.
//
// One thread per lane. Bound: registers. A Jacobian point is 24 limbs and the
// full add keeps about a dozen 8-limb temporaries live around the Montgomery
// products (16 + 7 for K2, 11 + 7 for K3/K4), so blocks are small (128
// threads) to leave room; the arithmetic itself is compute-bound like K1.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using F = pht::Fq;
constexpr int kThreads = 128;
constexpr int L = pht::kLimbs;

// dbl-2009-l (a = 0) of (X1, Y1, Z1), as pallas_point.py:98-112.
__device__ __forceinline__ void dbl(uint32_t Xd[L], uint32_t Yd[L], uint32_t Zd[L],
                                    const uint32_t X1[L], const uint32_t Y1[L],
                                    const uint32_t Z1[L]) {
  uint32_t A[L], B[L], C[L], t[L], D[L], E[L], Fv[L], C8[L], YZ[L];
  pht::mul<F>(A, X1, X1);
  pht::mul<F>(B, Y1, Y1);
  pht::mul<F>(C, B, B);
  pht::add<F>(t, X1, B);
  pht::mul<F>(t, t, t);
  pht::sub<F>(D, t, A);
  pht::sub<F>(D, D, C);
  pht::add<F>(D, D, D);
  pht::add<F>(E, A, A);
  pht::add<F>(E, E, A);
  pht::mul<F>(Fv, E, E);
  pht::add<F>(t, D, D);
  pht::sub<F>(Xd, Fv, t);
  pht::add<F>(C8, C, C);
  pht::add<F>(C8, C8, C8);
  pht::add<F>(C8, C8, C8);
  pht::sub<F>(t, D, Xd);
  pht::mul<F>(t, E, t);
  pht::sub<F>(Yd, t, C8);
  pht::mul<F>(YZ, Y1, Z1);
  pht::add<F>(Zd, YZ, YZ);
}

// Jacobian + Jacobian, as `_jacobian_add_full`.
template <bool kNoDouble>
__device__ __forceinline__ void jadd(uint32_t X3[L], uint32_t Y3[L], uint32_t Z3[L],
                                     const uint32_t X1[L], const uint32_t Y1[L],
                                     const uint32_t Z1[L], const uint32_t X2[L],
                                     const uint32_t Y2[L], const uint32_t Z2[L]) {
  uint32_t z1z1[L], z2z2[L], u1[L], u2[L], s1[L], s2[L], h[L], r[L], t[L], hhh[L], v[L];
  pht::mul<F>(z1z1, Z1, Z1);
  pht::mul<F>(z2z2, Z2, Z2);
  pht::mul<F>(u1, X1, z2z2);
  pht::mul<F>(u2, X2, z1z1);
  pht::mul<F>(t, Z2, z2z2);
  pht::mul<F>(s1, Y1, t);
  pht::mul<F>(t, Z1, z1z1);
  pht::mul<F>(s2, Y2, t);
  pht::sub<F>(h, u2, u1);
  pht::sub<F>(r, s2, s1);

  pht::mul<F>(t, h, h);      // hh
  pht::mul<F>(hhh, h, t);    // hhh
  pht::mul<F>(v, u1, t);     // v = u1 * hh
  pht::mul<F>(t, r, r);      // rr
  pht::sub<F>(X3, t, hhh);
  pht::add<F>(t, v, v);
  pht::sub<F>(X3, X3, t);
  pht::sub<F>(t, v, X3);
  pht::mul<F>(t, r, t);
  pht::mul<F>(s1, s1, hhh);
  pht::sub<F>(Y3, t, s1);
  pht::mul<F>(t, Z1, Z2);
  pht::mul<F>(Z3, t, h);

  const bool p_inf = pht::is_zero(Z1);
  const bool q_inf = pht::is_zero(Z2);
  if (!kNoDouble) {
    uint32_t Xd[L], Yd[L], Zd[L];
    dbl(Xd, Yd, Zd, X1, Y1, Z1);
    const bool h_zero = pht::is_zero(h);
    const bool r_zero = pht::is_zero(r);
    const bool is_dbl = h_zero && r_zero;
    pht::select(X3, is_dbl, Xd, X3);
    pht::select(Y3, is_dbl, Yd, Y3);
    pht::select(Z3, is_dbl, Zd, Z3);
    const bool annihilate = h_zero && !r_zero && !p_inf && !q_inf;
    uint32_t one[L], zero[L];
    pht::set_one<F>(one);
    pht::set_zero(zero);
    pht::select(X3, annihilate, one, X3);
    pht::select(Y3, annihilate, one, Y3);
    pht::select(Z3, annihilate, zero, Z3);
  }
  pht::select(X3, q_inf, X1, X3);
  pht::select(Y3, q_inf, Y1, Y3);
  pht::select(Z3, q_inf, Z1, Z3);
  pht::select(X3, p_inf, X2, X3);
  pht::select(Y3, p_inf, Y2, Y3);
  pht::select(Z3, p_inf, Z2, Z3);
}

// Jacobian + affine with a q_inf flag, as `_mixed_add_full`.
template <bool kNoDouble>
__device__ __forceinline__ void madd(uint32_t X3[L], uint32_t Y3[L], uint32_t Z3[L],
                                     const uint32_t X1[L], const uint32_t Y1[L],
                                     const uint32_t Z1[L], const uint32_t X2[L],
                                     const uint32_t Y2[L], bool q_inf) {
  uint32_t z1z1[L], u2[L], s2[L], h[L], r[L], t[L], hhh[L], v[L];
  pht::mul<F>(z1z1, Z1, Z1);
  pht::mul<F>(u2, X2, z1z1);
  pht::mul<F>(t, Z1, z1z1);
  pht::mul<F>(s2, Y2, t);
  pht::sub<F>(h, u2, X1);
  pht::sub<F>(r, s2, Y1);

  pht::mul<F>(t, h, h);      // hh
  pht::mul<F>(hhh, h, t);    // hhh
  pht::mul<F>(v, X1, t);     // v = X1 * hh
  pht::mul<F>(t, r, r);      // rr
  pht::sub<F>(X3, t, hhh);
  pht::add<F>(t, v, v);
  pht::sub<F>(X3, X3, t);
  pht::sub<F>(t, v, X3);
  pht::mul<F>(t, r, t);
  pht::mul<F>(u2, Y1, hhh);  // u2 reused as Y1 * hhh
  pht::sub<F>(Y3, t, u2);
  pht::mul<F>(Z3, Z1, h);

  const bool p_inf = pht::is_zero(Z1);
  uint32_t one[L], zero[L];
  pht::set_one<F>(one);
  pht::set_zero(zero);
  if (!kNoDouble) {
    uint32_t Xd[L], Yd[L], Zd[L];
    dbl(Xd, Yd, Zd, X1, Y1, Z1);
    const bool h_zero = pht::is_zero(h);
    const bool r_zero = pht::is_zero(r);
    const bool is_dbl = h_zero && r_zero;
    pht::select(X3, is_dbl, Xd, X3);
    pht::select(Y3, is_dbl, Yd, Y3);
    pht::select(Z3, is_dbl, Zd, Z3);
    const bool annihilate = h_zero && !r_zero && !p_inf;
    pht::select(X3, annihilate, one, X3);
    pht::select(Y3, annihilate, one, Y3);
    pht::select(Z3, annihilate, zero, Z3);
  }
  // inf + Q -> Q as Jacobian with Z = 1 (or infinity when Q is too)
  pht::select(X3, p_inf, X2, X3);
  pht::select(Y3, p_inf, Y2, Y3);
  pht::select(t, q_inf, zero, one);
  pht::select(Z3, p_inf, t, Z3);
  // P + inf -> P
  pht::select(X3, q_inf, X1, X3);
  pht::select(Y3, q_inf, Y1, Y3);
  pht::select(Z3, q_inf, Z1, Z3);
}

template <bool kNoDouble>
__global__ void g1_jadd_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                               const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                               const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                               uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t X1[L], Y1[L], Z1[L], X2[L], Y2[L], Z2[L], X3[L], Y3[L], Z3[L];
  pht::load(X1, x1, n, i);
  pht::load(Y1, y1, n, i);
  pht::load(Z1, z1, n, i);
  pht::load(X2, x2, n, i);
  pht::load(Y2, y2, n, i);
  pht::load(Z2, z2, n, i);
  jadd<kNoDouble>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
  pht::store(ox, n, i, X3);
  pht::store(oy, n, i, Y3);
  pht::store(oz, n, i, Z3);
}

// kPacked: the affine operand arrives as (n, 16) rows, words 0-7 = X limbs,
// 8-15 = Y limbs (the MSM's gathered rows, pack_points_dense layout);
// otherwise as two (8, n) limb-first arrays.
template <bool kNoDouble, bool kPacked>
__global__ void g1_madd_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                               const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                               const uint32_t* __restrict__ y2,
                               const uint8_t* __restrict__ q_inf, uint32_t* __restrict__ ox,
                               uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t X1[L], Y1[L], Z1[L], X2[L], Y2[L], X3[L], Y3[L], Z3[L];
  pht::load(X1, x1, n, i);
  pht::load(Y1, y1, n, i);
  pht::load(Z1, z1, n, i);
  if (kPacked) {
    const uint32_t* row = x2 + i * 2 * L;
#pragma unroll
    for (int k = 0; k < L; k++) {
      X2[k] = row[k];
      Y2[k] = row[L + k];
    }
  } else {
    pht::load(X2, x2, n, i);
    pht::load(Y2, y2, n, i);
  }
  madd<kNoDouble>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, q_inf[i] != 0);
  pht::store(ox, n, i, X3);
  pht::store(oy, n, i, Y3);
  pht::store(oz, n, i, Z3);
}

inline dim3 grid_for(long long n) { return dim3((unsigned)((n + kThreads - 1) / kThreads)); }

}  // namespace

// All coordinates (8, n) uint32 limb-first, Montgomery form over Fq.
// Each entry returns cudaGetLastError() after its launch (0 on success).

extern "C" int pht_g1_jadd(const void* x1, const void* y1, const void* z1, const void* x2,
                           const void* y2, const void* z2, void* ox, void* oy, void* oz,
                           long long n, int nodouble, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    kernel<<<grid_for(n), kThreads, 0, s>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
        (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  };
  if (nodouble) {
    args(g1_jadd_kernel<true>);
  } else {
    args(g1_jadd_kernel<false>);
  }
  return (int)cudaGetLastError();
}

// packed == 0: x2, y2 are (8, n) arrays. packed == 1: x2 is (n, 16) rows and
// y2 is ignored. q_inf: (n,) bytes, nonzero marks the affine operand as
// infinity.
extern "C" int pht_g1_madd(const void* x1, const void* y1, const void* z1, const void* x2,
                           const void* y2, const void* q_inf, void* ox, void* oy, void* oz,
                           long long n, int nodouble, int packed, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    kernel<<<grid_for(n), kThreads, 0, s>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
        (const uint32_t*)y2, (const uint8_t*)q_inf, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz, n);
  };
  if (packed) {
    if (nodouble) {
      args(g1_madd_kernel<true, true>);
    } else {
      args(g1_madd_kernel<false, true>);
    }
  } else {
    if (nodouble) {
      args(g1_madd_kernel<true, false>);
    } else {
      args(g1_madd_kernel<false, false>);
    }
  }
  return (int)cudaGetLastError();
}
