// BN254 prime-field arithmetic for the Hopper kernels of the PyTorch port.
//
// A field element is 8 little-endian 32-bit limbs. Device arrays are stored
// limb-first, (8, N) uint32 row-major: limb k of lane i sits at [k * N + i],
// so one thread per lane reads its 8 limbs at stride N and a warp's loads of
// one limb are contiguous (coalesced).
//
// Montgomery form uses R = 2^256 for both Fr and Fq, as the JAX package does
// (paillier_halo2_tpu/ff/field_jax.py:39-77), so Montgomery values agree
// across packages. There is one Montgomery product, `redc_product_cc`:
// word-by-word CIOS with 32-bit words on PTX carry chains (below). For
// inputs below R it computes (a*b + m*p) / R with m = -a*b*p^-1 mod R (the
// same value as whole-R REDC); `mul_cc` then subtracts p once if the result
// is >= p, so canonical inputs in [0, p) give canonical outputs, and
// `mul_lazy_cc` keeps the redundant form below. tests/test_torch_field.py
// checks the constants below against the Python field specification and
// runs the product's row schedule word by word.
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
//  - mul_lazy_cc: for a, b < 2p the product is t = (a*b + m*p) / R with
//    m < R, so t < (4p^2 + R*p) / R = p * (1 + 4p/R) < 1.757 p < 2p. The
//    value is a*b*R^-1 mod p up to one multiple of p, and t < R means the
//    ninth word t[8] is 0.
//  - add_lazy_cc: a + b < 4p < R never carries out of 256 bits; subtracting 2p
//    once when a + b >= 2p lands in [0, 2p).
//  - sub_lazy_cc: a - b lies in (-2p, 2p); adding 2p when it borrows lands in
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

// ---------------------------------------------------------------------------
// The product on PTX carry chains.
//
// A row a*b[i] is added to t as two carry chains in even/odd form: one over
// the products a[0], a[2], a[4], a[6], one over a[1], a[3], a[5], a[7], each
// product's low word (`mad.lo.cc`/`madc.lo.cc`) followed at once by its high
// word (`madc.hi.cc`) in the next word up. The even products' words do not
// overlap, nor the odd ones', so each chain is one pass, and ptxas fuses each
// low/high pair of one product into a wide multiply-add with carry. C++
// 64-bit CIOS (each limb step widened to 64 bits and its carry split back
// out) gives the same bits with separate IADD3s beside the IMADs, and a
// chain over all low words and then all high words costs a multiply and an
// add per word; both were measured and dropped (PERF.md).
// `probes/fq_product.cu` (run by `chip_smoke.py` phase 1) counts and times
// the product. A chain must stay inside one asm statement: the condition
// code does not survive between statements.
//
// Row i adds a*b[i], then m_i*p with m_i = t[0] * (-p^-1) mod 2^32, then
// drops the zero low word, so the result is CIOS's t = (a*b + m*p) / R.
// Bounds: between rows t < R + p < 2^257; inside a row
// t + a*b[i] + m*p < 2^290, so ten words hold it and the top carry never
// leaves t[9].
// ---------------------------------------------------------------------------

// t[0..9] += a[0..7] * b: the low word of a[j] * b at t[j], the high word at
// t[j + 1]; even j in the first chain, odd j in the second.
__device__ __forceinline__ void mac_row(uint32_t t[kLimbs + 2], const uint32_t a[kLimbs],
                                        uint32_t b) {
  asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
      "madc.hi.cc.u32 %1, %10, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32 %9, %9, 0;\n\t"
      "mad.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32 %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b));
}

// t[0..8] = (a*b + m*p) / R (t[8] <= 1 for a, b < R; 0 for a, b < 2p).
template <class F>
__device__ __forceinline__ void redc_product_cc(uint32_t t[kLimbs + 2], const uint32_t a[kLimbs],
                                                const uint32_t b[kLimbs]) {
  uint32_t p[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs; k++) p[k] = F::p(k);
#pragma unroll
  for (int k = 0; k < kLimbs + 2; k++) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; i++) {
    mac_row(t, a, b[i]);
    mac_row(t, p, t[0] * F::kInv);  // t[0] becomes 0
#pragma unroll
    for (int k = 0; k < kLimbs + 1; k++) t[k] = t[k + 1];
    t[kLimbs + 1] = 0u;
  }
}

// d = a - b over 8 limbs; returns the borrow out (0 or 1).
__device__ __forceinline__ uint32_t sub_cc8(uint32_t d[kLimbs], const uint32_t a[kLimbs],
                                            const uint32_t b[kLimbs]) {
  uint32_t bw;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "=r"(bw)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return bw & 1u;  // subc of 0 - 0 - borrow: all ones after a borrow
}

// s = a + b over 8 limbs; returns the carry out (0 or 1).
__device__ __forceinline__ uint32_t add_cc8(uint32_t s[kLimbs], const uint32_t a[kLimbs],
                                            const uint32_t b[kLimbs]) {
  uint32_t c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]), "=r"(s[6]),
        "=r"(s[7]), "=r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return c;
}

template <class F>
__device__ __forceinline__ void p_limbs(uint32_t p[kLimbs]) {
#pragma unroll
  for (int k = 0; k < kLimbs; k++) p[k] = F::p(k);
}

template <class F>
__device__ __forceinline__ void p2_limbs(uint32_t p[kLimbs]) {
#pragma unroll
  for (int k = 0; k < kLimbs; k++) p[k] = p2<F>(k);
}

// r = a * b * 2^-256 mod p, canonical for a, b < R. r may alias a or b.
template <class F>
__device__ __forceinline__ void mul_cc(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                       const uint32_t b[kLimbs]) {
  uint32_t t[kLimbs + 2], p[kLimbs], d[kLimbs];
  redc_product_cc<F>(t, a, b);
  p_limbs<F>(p);
  const uint32_t borrow = sub_cc8(d, t, p);
  const bool ge = t[kLimbs] != 0 || borrow == 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = ge ? d[k] : t[k];
}

// r = a * b * 2^-256 + k*p, k in {0, 1}: in [0, 2p) for a, b in [0, 2p).
// r may alias a or b.
template <class F>
__device__ __forceinline__ void mul_lazy_cc(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                            const uint32_t b[kLimbs]) {
  uint32_t t[kLimbs + 2];
  redc_product_cc<F>(t, a, b);
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = t[k];
}

// r = (a + b) mod p and r = (a - b) mod p for a, b in [0, p); r may alias
// a or b.
template <class F>
__device__ __forceinline__ void add_cc(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                       const uint32_t b[kLimbs]) {
  uint32_t s[kLimbs], d[kLimbs], p[kLimbs];
  const uint32_t carry = add_cc8(s, a, b);
  p_limbs<F>(p);
  const uint32_t borrow = sub_cc8(d, s, p);
  const bool use_d = carry != 0 || borrow == 0;
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = use_d ? d[k] : s[k];
}

template <class F>
__device__ __forceinline__ void sub_cc(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                       const uint32_t b[kLimbs]) {
  uint32_t d[kLimbs], p[kLimbs];
  const uint32_t mask = 0u - sub_cc8(d, a, b);  // add p back when a < b
  p_limbs<F>(p);
#pragma unroll
  for (int k = 0; k < kLimbs; k++) p[k] &= mask;
  add_cc8(r, d, p);
}

// r = a + b, minus 2p if that is >= 2p; r = a - b, plus 2p if that borrows:
// the redundant form's sum and difference. r may alias a or b.
template <class F>
__device__ __forceinline__ void add_lazy_cc(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                            const uint32_t b[kLimbs]) {
  uint32_t s[kLimbs], d[kLimbs], p[kLimbs];
  add_cc8(s, a, b);  // a + b < 4p < R: no carry out
  p2_limbs<F>(p);
  const uint32_t borrow = sub_cc8(d, s, p);
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = borrow ? s[k] : d[k];
}

template <class F>
__device__ __forceinline__ void sub_lazy_cc(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                            const uint32_t b[kLimbs]) {
  uint32_t d[kLimbs], p[kLimbs];
  const uint32_t mask = 0u - sub_cc8(d, a, b);
  p2_limbs<F>(p);
#pragma unroll
  for (int k = 0; k < kLimbs; k++) p[k] &= mask;
  add_cc8(r, d, p);
}

// [0, 2p) -> [0, p): the redundant form's exit, as `canonicalize` in
// ff/lazy_mont.py; a Z that is p becomes the exact 0 of infinity. r may
// alias a.
template <class F>
__device__ __forceinline__ void canonicalize(uint32_t r[kLimbs], const uint32_t a[kLimbs]) {
  uint32_t d[kLimbs], p[kLimbs];
  p_limbs<F>(p);
  const uint32_t borrow = sub_cc8(d, a, p);
#pragma unroll
  for (int k = 0; k < kLimbs; k++) r[k] = borrow ? a[k] : d[k];
}

}  // namespace pht
