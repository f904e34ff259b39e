// BN254 prime-field arithmetic for the Hopper kernels of the PyTorch port.
//
// A field element is 8 little-endian 32-bit limbs. Device arrays are stored
// limb-first, (8, N) uint32 row-major: limb k of lane i sits at [k * N + i],
// so one thread per lane reads its 8 limbs at stride N and a warp's loads of
// one limb are contiguous (coalesced).
//
// Montgomery form uses R = 2^256 for both Fr and Fq, as the JAX package does
// (paillier_halo2_tpu/ff/field_jax.py:39-77), so Montgomery values agree
// across packages. The multiply is word-by-word CIOS with 32-bit words and
// 64-bit accumulators; for inputs below R it computes (a*b + m*p) / R with
// m = -a*b*p^-1 mod R (the same value as whole-R REDC), then subtracts p once
// if the result is >= p. Canonical inputs in [0, p) give canonical outputs.
// tests/test_torch_field.py checks the constants below against the Python
// field specification.
#pragma once

#include <cstdint>

namespace pht {

constexpr int kLimbs = 8;

struct Fr {
  static constexpr uint32_t kInv = 0xefffffffu;  // -p^-1 mod 2^32
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[kLimbs] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                                    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __device__ __forceinline__ static uint32_t one(int i) {  // R mod p
    constexpr uint32_t v[kLimbs] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                                    0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

struct Fq {
  static constexpr uint32_t kInv = 0xe4866389u;  // -q^-1 mod 2^32
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[kLimbs] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                                    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __device__ __forceinline__ static uint32_t one(int i) {  // R mod q
    constexpr uint32_t v[kLimbs] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                                    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

__device__ __forceinline__ void load(uint32_t r[kLimbs], const uint32_t* base, int64_t n,
                                     int64_t i) {
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = base[k * n + i];
}

__device__ __forceinline__ void store(uint32_t* base, int64_t n, int64_t i,
                                      const uint32_t a[kLimbs]) {
#pragma unroll
  for (int k = 0; k < kLimbs; k++) base[k * n + i] = a[k];
}

__device__ __forceinline__ void copy(uint32_t r[kLimbs], const uint32_t a[kLimbs]) {
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = a[k];
}

// r = mask ? a : b
__device__ __forceinline__ void select(uint32_t r[kLimbs], bool mask, const uint32_t a[kLimbs],
                                       const uint32_t b[kLimbs]) {
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = mask ? a[k] : b[k];
}

__device__ __forceinline__ bool is_zero(const uint32_t a[kLimbs]) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) acc |= a[k];
  return acc == 0;
}

template <class F>
__device__ __forceinline__ void set_one(uint32_t r[kLimbs]) {
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = F::one(k);
}

__device__ __forceinline__ void set_zero(uint32_t r[kLimbs]) {
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = 0u;
}

// r = (a + b) mod p for a, b in [0, p). r may alias a or b.
template <class F>
__device__ __forceinline__ void add(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                    const uint32_t b[kLimbs]) {
  uint32_t s[kLimbs], d[kLimbs];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) {
    uint64_t t = (uint64_t)a[k] + b[k] + carry;
    s[k] = (uint32_t)t;
    carry = t >> 32;
  }
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) {
    uint64_t t = (uint64_t)s[k] - F::p(k) - borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  bool use_d = carry != 0 || borrow == 0;  // a + b >= p
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = use_d ? d[k] : s[k];
}

// r = (a - b) mod p for a, b in [0, p). r may alias a or b.
template <class F>
__device__ __forceinline__ void sub(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                    const uint32_t b[kLimbs]) {
  uint32_t d[kLimbs];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) {
    uint64_t t = (uint64_t)a[k] - b[k] - borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  uint32_t mask = 0u - borrow;  // add p back when a < b
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) {
    uint64_t t = (uint64_t)d[k] + (F::p(k) & mask) + carry;
    r[k] = (uint32_t)t;
    carry = t >> 32;
  }
}

// t[0..8] = (a*b + m*p) / R with m = -a*b*p^-1 mod R (CIOS), which is below
// R + p for a, b < R. 64 32x32->64 multiply pairs for a*b and 64 for m*p.
template <class F>
__device__ __forceinline__ void redc_product(uint32_t t[kLimbs + 2], const uint32_t a[kLimbs],
                                             const uint32_t b[kLimbs]) {
#pragma unroll
  for (int k = 0; k < kLimbs + 2; k++) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kLimbs; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[kLimbs] + c;
    t[kLimbs] = (uint32_t)s;
    t[kLimbs + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F::kInv;
    s = (uint64_t)m * F::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < kLimbs; j++) {
      s = (uint64_t)m * F::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[kLimbs] + c;
    t[kLimbs - 1] = (uint32_t)s;
    t[kLimbs] = t[kLimbs + 1] + (uint32_t)(s >> 32);
  }
}

// r = a * b * 2^-256 mod p (CIOS), canonical for a, b < R: the product
// above, then one conditional subtract. r may alias a or b.
template <class F>
__device__ __forceinline__ void mul(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                    const uint32_t b[kLimbs]) {
  uint32_t t[kLimbs + 2];
  redc_product<F>(t, a, b);
  uint32_t d[kLimbs];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) {
    uint64_t x = (uint64_t)t[k] - F::p(k) - borrow;
    d[k] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  bool ge = t[kLimbs] != 0 || borrow == 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = ge ? d[k] : t[k];
}

// ---------------------------------------------------------------------------
// The redundant form: a field element held as any integer in [0, 2p).
//
// Counterpart of the lazy signed digits of paillier_halo2_tpu/ff/lazy_mont.py
// (`lmul`, `lreduce`, `canonicalize`, :121-219). The TPU needed those because
// its vector unit has no carry chain; Hopper has one, so here a value keeps
// its 8 x 32-bit limbs and only gives up the final normalisation: no
// conditional subtraction after a product, one canonicalisation where a
// pipeline ends.
//
// Invariant: every operand and every result is an integer in [0, 2p).
// Proof, with p / R < 0.1891 for both Fr and Fq (top limb 0x30644e72), so
// 4p < R = 2^256:
//  - mul_lazy: for a, b < 2p the CIOS result is t = (a*b + m*p) / R with
//    m < R, so t < (4p^2 + R*p) / R = p * (1 + 4p/R) < 1.757 p < 2p. The
//    value is a*b*R^-1 mod p up to one multiple of p, and t < R means the
//    ninth word t[8] is 0.
//  - add_lazy: a + b < 4p < R never carries out of 256 bits; subtracting 2p
//    once when a + b >= 2p lands in [0, 2p).
//  - sub_lazy: a - b lies in (-2p, 2p); adding 2p when it borrows lands in
//    (0, 2p). This is a - b + 2p followed by one conditional subtraction of
//    2p, written as the branch that is taken.
// Exact zero stays exact zero: 0 * b gives t = 0 (every m is 0), 0 + 0 = 0
// and 0 - 0 = 0, so the point kernels' infinity test Z == 0 stays a plain
// limb test inside a pipeline. A value that is zero mod p but not 0 (p
// itself) is what a broken nodouble contract leaves in Z; the pipeline's exit
// (`canonicalize` in ff/lazy_mont.py, plain torch) maps it to 0.
// ---------------------------------------------------------------------------

// Limb i of 2p (p's limbs shifted left by one; the compiler folds it).
template <class F>
__device__ __forceinline__ uint32_t p2(int i) {
  return (F::p(i) << 1) | (i ? F::p(i - 1) >> 31 : 0u);
}

// r = a * b * 2^-256 + k*p, k in {0, 1}: in [0, 2p) for a, b in [0, 2p).
// r may alias a or b.
template <class F>
__device__ __forceinline__ void mul_lazy(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                         const uint32_t b[kLimbs]) {
  uint32_t t[kLimbs + 2];
  redc_product<F>(t, a, b);
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = t[k];
}

// r = a + b, minus 2p if that is >= 2p. r may alias a or b.
template <class F>
__device__ __forceinline__ void add_lazy(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                         const uint32_t b[kLimbs]) {
  uint32_t s[kLimbs], d[kLimbs];
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) {
    uint64_t t = (uint64_t)a[k] + b[k] + carry;
    s[k] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) {
    uint64_t t = (uint64_t)s[k] - p2<F>(k) - borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = borrow ? s[k] : d[k];
}

// r = a - b, plus 2p if that borrows. r may alias a or b.
template <class F>
__device__ __forceinline__ void sub_lazy(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                         const uint32_t b[kLimbs]) {
  uint32_t d[kLimbs];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) {
    uint64_t t = (uint64_t)a[k] - b[k] - borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  uint32_t mask = 0u - borrow;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) {
    uint64_t t = (uint64_t)d[k] + (p2<F>(k) & mask) + carry;
    r[k] = (uint32_t)t;
    carry = t >> 32;
  }
}

}  // namespace pht
