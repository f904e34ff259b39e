// Native BN254 host engine — C++ replacement for the reference's native
// host-side bignum/curve layer (num-bigint + halo2curves host arithmetic,
// SURVEY.md section 2.2). The device kernels own the batched hot loops; this
// library owns the host-side scalar paths: G1 scalar-mul/add/MSM for
// oracles/final combines, and the ate pairing for KZG verification (the
// 2-pairing check, the reference's use-site: verify_proof).
//
// Everything is parameterized at init from Python (modulus, Montgomery R^2,
// -q^-1 mod 2^64, small constants), so the C++ holds no curve constants.
// Field elements cross the ABI as 32-byte little-endian standard form.
//
// The Fq12 tower mirrors ec/pairing.py exactly (polynomial basis
// Fq[w]/(w^12 - 18 w^6 + 82), twist u -> w^6 - 9) so the two implementations
// are cross-checkable element for element.

#include <cstdint>
#include <cstring>

using u64 = uint64_t;
using u128 = unsigned __int128;

struct U256 {
  u64 v[4];
};

static U256 Q;       // field modulus
static U256 R2;      // (2^256)^2 mod Q
static u64 NINV;     // -Q^{-1} mod 2^64
static U256 ONE_M;   // 1 in Montgomery form
static U256 SMALL_M[128];  // small constants 0..127 in Montgomery form

static inline bool geq(const U256 &a, const U256 &b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return true;
}

static inline void sub_nored(U256 &o, const U256 &a, const U256 &b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    o.v[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

static inline void fp_add(U256 &o, const U256 &a, const U256 &b) {
  u128 carry = 0;
  u64 t[4];
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    t[i] = (u64)s;
    carry = s >> 64;
  }
  U256 r;
  memcpy(r.v, t, sizeof(t));
  if (carry || geq(r, Q)) {
    U256 d;
    sub_nored(d, r, Q);
    o = d;
  } else {
    o = r;
  }
}

static inline void fp_sub(U256 &o, const U256 &a, const U256 &b) {
  if (geq(a, b)) {
    sub_nored(o, a, b);
  } else {
    U256 t;
    sub_nored(t, b, a);     // t = b - a
    sub_nored(o, Q, t);     // q - t
  }
}

static inline void fp_neg(U256 &o, const U256 &a) {
  bool zero = !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
  if (zero) { o = a; } else { sub_nored(o, Q, a); }
}

// Montgomery CIOS multiplication: o = a*b*R^{-1} mod Q.
static inline void fp_mul(U256 &o, const U256 &a, const U256 &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);

    u64 m = t[0] * NINV;
    carry = 0;
    u128 s0 = (u128)t[0] + (u128)m * Q.v[0];
    carry = s0 >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * Q.v[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    u128 s3 = (u128)t[4] + carry;
    t[3] = (u64)s3;
    t[4] = t[5] + (u64)(s3 >> 64);
    t[5] = 0;
  }
  U256 r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || geq(r, Q)) {
    U256 d;
    sub_nored(d, r, Q);
    o = d;
  } else {
    o = r;
  }
}

static inline void fp_sqr(U256 &o, const U256 &a) { fp_mul(o, a, a); }

static void fp_pow(U256 &o, const U256 &base, const u64 *e, int ewords) {
  U256 acc = ONE_M;
  U256 b = base;
  for (int w = 0; w < ewords; ++w) {
    u64 word = e[w];
    for (int bit = 0; bit < 64; ++bit) {
      if (word & 1) {
        U256 t;
        fp_mul(t, acc, b);
        acc = t;
      }
      U256 t2;
      fp_sqr(t2, b);
      b = t2;
      word >>= 1;
    }
  }
  o = acc;
}

// Fermat inverse: a^(q-2).
static void fp_inv(U256 &o, const U256 &a) {
  U256 qm2 = Q;
  // subtract 2 (Q is odd and > 2)
  if (qm2.v[0] >= 2) {
    qm2.v[0] -= 2;
  } else {
    qm2.v[0] = qm2.v[0] - 2;  // wraps; borrow
    int i = 1;
    while (qm2.v[i] == 0) { qm2.v[i] = ~0ull; ++i; }
    qm2.v[i] -= 1;
  }
  fp_pow(o, a, qm2.v, 4);
}

static inline bool fp_is_zero(const U256 &a) {
  return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}

static inline bool fp_eq(const U256 &a, const U256 &b) {
  return a.v[0] == b.v[0] && a.v[1] == b.v[1] && a.v[2] == b.v[2] && a.v[3] == b.v[3];
}

static void to_mont(U256 &o, const U256 &a) { fp_mul(o, a, R2); }
static void from_mont(U256 &o, const U256 &a) {
  U256 one = {{1, 0, 0, 0}};
  fp_mul(o, a, one);
}

// ---------------------------------------------------------------------------
// Fq12 = Fq[w] / (w^12 - 18 w^6 + 82), coefficients in Montgomery form.
// ---------------------------------------------------------------------------

struct FQ12 {
  U256 c[12];
};

static FQ12 fq12_zero() {
  FQ12 r;
  memset(&r, 0, sizeof(r));
  return r;
}

static FQ12 fq12_one() {
  FQ12 r = fq12_zero();
  r.c[0] = ONE_M;
  return r;
}

static bool fq12_is_zero(const FQ12 &a) {
  for (int i = 0; i < 12; ++i)
    if (!fp_is_zero(a.c[i])) return false;
  return true;
}

static bool fq12_eq(const FQ12 &a, const FQ12 &b) {
  for (int i = 0; i < 12; ++i)
    if (!fp_eq(a.c[i], b.c[i])) return false;
  return true;
}

static FQ12 fq12_add(const FQ12 &a, const FQ12 &b) {
  FQ12 r;
  for (int i = 0; i < 12; ++i) fp_add(r.c[i], a.c[i], b.c[i]);
  return r;
}

static FQ12 fq12_sub(const FQ12 &a, const FQ12 &b) {
  FQ12 r;
  for (int i = 0; i < 12; ++i) fp_sub(r.c[i], a.c[i], b.c[i]);
  return r;
}

static FQ12 fq12_neg(const FQ12 &a) {
  FQ12 r;
  for (int i = 0; i < 12; ++i) fp_neg(r.c[i], a.c[i]);
  return r;
}

static FQ12 fq12_smul(const FQ12 &a, int s) {  // small positive scalar
  FQ12 r;
  for (int i = 0; i < 12; ++i) fp_mul(r.c[i], a.c[i], SMALL_M[s]);
  return r;
}

static FQ12 fq12_mul(const FQ12 &a, const FQ12 &b) {
  U256 t[23];
  memset(t, 0, sizeof(t));
  for (int i = 0; i < 12; ++i) {
    if (fp_is_zero(a.c[i])) continue;
    for (int j = 0; j < 12; ++j) {
      U256 p;
      fp_mul(p, a.c[i], b.c[j]);
      U256 s;
      fp_add(s, t[i + j], p);
      t[i + j] = s;
    }
  }
  // reduce degrees 22..12 by w^12 = 18 w^6 - 82
  for (int d = 22; d >= 12; --d) {
    if (fp_is_zero(t[d])) continue;
    U256 v = t[d];
    memset(&t[d], 0, sizeof(U256));
    U256 a18, a82, s;
    fp_mul(a18, v, SMALL_M[18]);
    fp_add(s, t[d - 6], a18);
    t[d - 6] = s;
    fp_mul(a82, v, SMALL_M[82]);
    fp_sub(s, t[d - 12], a82);
    t[d - 12] = s;
  }
  FQ12 r;
  for (int i = 0; i < 12; ++i) r.c[i] = t[i];
  return r;
}

static FQ12 fq12_sqr(const FQ12 &a) { return fq12_mul(a, a); }

// Extended Euclid over Fq[w] against w^12 - 18w^6 + 82 (mirrors FQ12.inv in
// ec/pairing.py; degree-13 fixed-size polynomial arithmetic).
struct Poly13 {
  U256 c[13];
};

static int poly_deg(const Poly13 &p) {
  for (int i = 12; i >= 0; --i)
    if (!fp_is_zero(p.c[i])) return i;
  return 0;
}

static FQ12 fq12_inv(const FQ12 &a) {
  Poly13 lm, hm, low, high;
  memset(&lm, 0, sizeof(lm));
  memset(&hm, 0, sizeof(hm));
  memset(&low, 0, sizeof(low));
  memset(&high, 0, sizeof(high));
  lm.c[0] = ONE_M;
  for (int i = 0; i < 12; ++i) low.c[i] = a.c[i];
  // modulus poly: 82 - 18 w^6 + w^12 (Montgomery)
  high.c[0] = SMALL_M[82];
  fp_neg(high.c[6], SMALL_M[18]);
  high.c[12] = ONE_M;

  while (poly_deg(low)) {
    // r = high / low (rounded poly division)
    int dega = poly_deg(high), degb = poly_deg(low);
    Poly13 r;
    memset(&r, 0, sizeof(r));
    Poly13 temp = high;
    U256 binv;
    fp_inv(binv, low.c[degb]);
    for (int i = dega - degb; i >= 0; --i) {
      U256 o;
      fp_mul(o, temp.c[degb + i], binv);
      U256 s;
      fp_add(s, r.c[i], o);
      r.c[i] = s;
      for (int cI = 0; cI <= degb; ++cI) {
        U256 p2;
        fp_mul(p2, r.c[i], low.c[cI]);
        U256 d;
        fp_sub(d, temp.c[cI + i], p2);
        temp.c[cI + i] = d;
      }
    }
    // nm = hm - lm*r ; new = high - low*r
    Poly13 nm = hm, nw = high;
    for (int i = 0; i < 13; ++i) {
      if (fp_is_zero(lm.c[i]) && fp_is_zero(low.c[i])) continue;
      for (int j = 0; j + i < 13; ++j) {
        if (fp_is_zero(r.c[j])) continue;
        U256 p2, d;
        fp_mul(p2, lm.c[i], r.c[j]);
        fp_sub(d, nm.c[i + j], p2);
        nm.c[i + j] = d;
        fp_mul(p2, low.c[i], r.c[j]);
        fp_sub(d, nw.c[i + j], p2);
        nw.c[i + j] = d;
      }
    }
    high = low;
    low = nw;
    hm = lm;
    lm = nm;
  }
  U256 c0inv;
  fp_inv(c0inv, low.c[0]);
  FQ12 out;
  for (int i = 0; i < 12; ++i) fp_mul(out.c[i], lm.c[i], c0inv);
  return out;
}

static FQ12 fq12_pow_bytes(const FQ12 &base, const uint8_t *e, int elen) {
  FQ12 acc = fq12_one();
  FQ12 b = base;
  for (int byte = 0; byte < elen; ++byte) {
    uint8_t w = e[byte];
    for (int bit = 0; bit < 8; ++bit) {
      if (w & 1) acc = fq12_mul(acc, b);
      b = fq12_sqr(b);
      w >>= 1;
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// E(Fq12) affine points for the Miller loop (mirrors Pt12 in ec/pairing.py).
// ---------------------------------------------------------------------------

struct Pt12 {
  FQ12 x, y;
  bool inf;
};

static Pt12 pt12_double(const Pt12 &p) {
  if (p.inf) return p;
  if (fq12_is_zero(p.y)) {
    Pt12 r;
    r.inf = true;
    return r;
  }
  FQ12 xx = fq12_sqr(p.x);
  FQ12 num = fq12_smul(xx, 3);
  FQ12 den = fq12_smul(p.y, 2);
  FQ12 lam = fq12_mul(num, fq12_inv(den));
  FQ12 nx = fq12_sub(fq12_sqr(lam), fq12_smul(p.x, 2));
  FQ12 ny = fq12_sub(fq12_mul(lam, fq12_sub(p.x, nx)), p.y);
  Pt12 r;
  r.x = nx;
  r.y = ny;
  r.inf = false;
  return r;
}

static Pt12 pt12_add(const Pt12 &p, const Pt12 &q) {
  if (p.inf) return q;
  if (q.inf) return p;
  if (fq12_eq(p.x, q.x)) {
    if (fq12_is_zero(fq12_add(p.y, q.y))) {
      Pt12 r;
      r.inf = true;
      return r;
    }
    return pt12_double(p);
  }
  FQ12 lam = fq12_mul(fq12_sub(q.y, p.y), fq12_inv(fq12_sub(q.x, p.x)));
  FQ12 nx = fq12_sub(fq12_sub(fq12_sqr(lam), p.x), q.x);
  FQ12 ny = fq12_sub(fq12_mul(lam, fq12_sub(p.x, nx)), p.y);
  Pt12 r;
  r.x = nx;
  r.y = ny;
  r.inf = false;
  return r;
}

static FQ12 linefunc(const Pt12 &p1, const Pt12 &p2, const Pt12 &t) {
  if (!fq12_eq(p1.x, p2.x)) {
    FQ12 m = fq12_mul(fq12_sub(p2.y, p1.y), fq12_inv(fq12_sub(p2.x, p1.x)));
    return fq12_sub(fq12_mul(m, fq12_sub(t.x, p1.x)), fq12_sub(t.y, p1.y));
  }
  if (fq12_eq(p1.y, p2.y)) {
    FQ12 m = fq12_mul(fq12_smul(fq12_sqr(p1.x), 3), fq12_inv(fq12_smul(p1.y, 2)));
    return fq12_sub(fq12_mul(m, fq12_sub(t.x, p1.x)), fq12_sub(t.y, p1.y));
  }
  return fq12_sub(t.x, p1.x);
}

static u128 ATE_LOOP = 0;  // set at init (65 bits for BN254: 6t+2 > 2^64)
static U256 Q_STD;         // modulus in standard form words (for Frobenius pow)

static FQ12 fq12_pow_q(const FQ12 &a) {  // a^Q (Frobenius via plain pow)
  return [&]() {
    FQ12 acc = fq12_one();
    FQ12 b = a;
    for (int w = 0; w < 4; ++w) {
      u64 word = Q_STD.v[w];
      for (int bit = 0; bit < 64; ++bit) {
        if (word & 1) acc = fq12_mul(acc, b);
        b = fq12_sqr(b);
        word >>= 1;
      }
    }
    return acc;
  }();
}

static FQ12 miller_loop(const Pt12 &q12, const Pt12 &p12) {
  if (q12.inf || p12.inf) return fq12_one();
  Pt12 r = q12;
  FQ12 f = fq12_one();
  int top = 0;
  for (int i = 127; i >= 0; --i) {
    if ((ATE_LOOP >> i) & 1) { top = i; break; }
  }
  for (int i = top - 1; i >= 0; --i) {
    f = fq12_mul(fq12_sqr(f), linefunc(r, r, p12));
    r = pt12_double(r);
    if ((ATE_LOOP >> i) & 1) {
      f = fq12_mul(f, linefunc(r, q12, p12));
      r = pt12_add(r, q12);
    }
  }
  Pt12 q1, nq2;
  q1.x = fq12_pow_q(q12.x);
  q1.y = fq12_pow_q(q12.y);
  q1.inf = false;
  nq2.x = fq12_pow_q(q1.x);
  nq2.y = fq12_neg(fq12_pow_q(q1.y));
  nq2.inf = false;
  f = fq12_mul(f, linefunc(r, q1, p12));
  r = pt12_add(r, q1);
  f = fq12_mul(f, linefunc(r, nq2, p12));
  return f;
}

// ---------------------------------------------------------------------------
// G1 (Jacobian over Fq, Montgomery coords internally).
// ---------------------------------------------------------------------------

struct G1J {
  U256 X, Y, Z;  // Z == 0 <=> infinity
};

static G1J g1_infinity() {
  G1J r;
  r.X = ONE_M;
  r.Y = ONE_M;
  memset(&r.Z, 0, sizeof(U256));
  return r;
}

static G1J g1_double(const G1J &p) {
  if (fp_is_zero(p.Z)) return p;
  U256 A, B, C, t, D, E, F, X3, Y3, Z3, tmp, tmp2;
  fp_sqr(A, p.X);
  fp_sqr(B, p.Y);
  fp_sqr(C, B);
  fp_add(t, p.X, B);
  fp_sqr(t, t);
  fp_sub(t, t, A);
  fp_sub(t, t, C);
  fp_add(D, t, t);
  fp_add(E, A, A);
  fp_add(E, E, A);
  fp_sqr(F, E);
  fp_add(tmp, D, D);
  fp_sub(X3, F, tmp);
  fp_add(tmp, C, C);
  fp_add(tmp, tmp, tmp);
  fp_add(tmp, tmp, tmp);  // 8C
  fp_sub(tmp2, D, X3);
  fp_mul(Y3, E, tmp2);
  fp_sub(Y3, Y3, tmp);
  fp_mul(Z3, p.Y, p.Z);
  fp_add(Z3, Z3, Z3);
  G1J r;
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
  return r;
}

static G1J g1_add(const G1J &p, const G1J &q) {
  if (fp_is_zero(p.Z)) return q;
  if (fp_is_zero(q.Z)) return p;
  U256 z1z1, z2z2, u1, u2, s1, s2, h, r_, t;
  fp_sqr(z1z1, p.Z);
  fp_sqr(z2z2, q.Z);
  fp_mul(u1, p.X, z2z2);
  fp_mul(u2, q.X, z1z1);
  fp_mul(t, q.Z, z2z2);
  fp_mul(s1, p.Y, t);
  fp_mul(t, p.Z, z1z1);
  fp_mul(s2, q.Y, t);
  fp_sub(h, u2, u1);
  fp_sub(r_, s2, s1);
  if (fp_is_zero(h)) {
    if (fp_is_zero(r_)) return g1_double(p);
    return g1_infinity();
  }
  U256 hh, hhh, v, rr, X3, Y3, Z3;
  fp_sqr(hh, h);
  fp_mul(hhh, h, hh);
  fp_mul(v, u1, hh);
  fp_sqr(rr, r_);
  fp_sub(X3, rr, hhh);
  fp_add(t, v, v);
  fp_sub(X3, X3, t);
  fp_sub(t, v, X3);
  fp_mul(Y3, r_, t);
  fp_mul(t, s1, hhh);
  fp_sub(Y3, Y3, t);
  fp_mul(t, p.Z, q.Z);
  fp_mul(Z3, t, h);
  G1J r;
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
  return r;
}

static G1J g1_scalar_mul(const G1J &p, const uint8_t *k, int klen) {
  G1J acc = g1_infinity();
  // MSB-first double-and-add
  for (int byte = klen - 1; byte >= 0; --byte) {
    for (int bit = 7; bit >= 0; --bit) {
      acc = g1_double(acc);
      if ((k[byte] >> bit) & 1) acc = g1_add(acc, p);
    }
  }
  return acc;
}

// -- byte conversion helpers -------------------------------------------------

static void read_fp(U256 &o, const uint8_t *b) {  // 32 bytes LE, standard form
  U256 s;
  memcpy(s.v, b, 32);
  to_mont(o, s);
}

static void write_fp(uint8_t *b, const U256 &a) {
  U256 s;
  from_mont(s, a);
  memcpy(b, s.v, 32);
}

static G1J read_g1(const uint8_t *xy, int inf) {
  if (inf) return g1_infinity();
  G1J p;
  read_fp(p.X, xy);
  read_fp(p.Y, xy + 32);
  p.Z = ONE_M;
  return p;
}

static void write_g1(uint8_t *xy, int *inf, const G1J &p) {
  if (fp_is_zero(p.Z)) {
    memset(xy, 0, 64);
    *inf = 1;
    return;
  }
  U256 zi, zi2, zi3, x, y;
  fp_inv(zi, p.Z);
  fp_sqr(zi2, zi);
  fp_mul(zi3, zi2, zi);
  fp_mul(x, p.X, zi2);
  fp_mul(y, p.Y, zi3);
  write_fp(xy, x);
  write_fp(xy + 32, y);
  *inf = 0;
}

// FQ12 embeddings mirroring pairing.py: from_fq and from_fq2 (u -> w^6 - 9),
// then the twist multiplies by w^2 / w^3 — which in the polynomial basis is a
// coefficient shift (no reduction: source degree <= 6, shift <= 3 => < 12...
// except degree 6+3 = 9 < 12, safe).
static FQ12 fq12_from_fq_mont(const U256 &a) {
  FQ12 r = fq12_zero();
  r.c[0] = a;
  return r;
}

static FQ12 fq12_from_fq2_mont(const U256 &a, const U256 &b) {
  FQ12 r = fq12_zero();
  U256 nineb, t;
  fp_mul(nineb, b, SMALL_M[9]);
  fp_sub(t, a, nineb);
  r.c[0] = t;
  r.c[6] = b;
  return r;
}

static FQ12 fq12_shift(const FQ12 &a, int s) {  // multiply by w^s, s <= 3
  FQ12 r = fq12_zero();
  for (int i = 0; i + s < 12; ++i) r.c[i + s] = a.c[i];
  // degrees >= 12 would need reduction; callers guarantee deg(a)+s < 12
  return r;
}

// ---------------------------------------------------------------------------
// Fr (scalar field) context + radix-2 NTT — the CPU backend for the
// polynomial transforms (poly/ntt.py is the TPU path; on the CPU test
// platform XLA's unfused thunk dispatch makes the digit-vector butterflies
// ~1000x slower than this). Semantics mirror poly/ntt.py `ntt` exactly:
// in-order DIT with bit-reversal, natural-order output, optional 1/n scale.
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>
#include <vector>

static U256 FRQ;     // scalar-field modulus r
static U256 FRR2;    // (2^256)^2 mod r
static u64 FRNINV;   // -r^{-1} mod 2^64
static U256 FR_ONE_M;

static inline bool fr_geq(const U256 &a, const U256 &b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return true;
}

static inline void fr_add(U256 &o, const U256 &a, const U256 &b) {
  u128 carry = 0;
  u64 t[4];
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    t[i] = (u64)s;
    carry = s >> 64;
  }
  U256 r;
  memcpy(r.v, t, sizeof(t));
  if (carry || fr_geq(r, FRQ)) {
    U256 d;
    sub_nored(d, r, FRQ);
    o = d;
  } else {
    o = r;
  }
}

static inline void fr_sub(U256 &o, const U256 &a, const U256 &b) {
  if (fr_geq(a, b)) {
    sub_nored(o, a, b);
  } else {
    U256 t;
    sub_nored(t, b, a);
    sub_nored(o, FRQ, t);
  }
}

// Montgomery CIOS against the Fr modulus (same structure as fp_mul).
static inline void fr_mul(U256 &o, const U256 &a, const U256 &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);

    u64 m = t[0] * FRNINV;
    carry = 0;
    u128 s0 = (u128)t[0] + (u128)m * FRQ.v[0];
    carry = s0 >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * FRQ.v[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    u128 s3 = (u128)t[4] + carry;
    t[3] = (u64)s3;
    t[4] = t[5] + (u64)(s3 >> 64);
    t[5] = 0;
  }
  U256 r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || fr_geq(r, FRQ)) {
    U256 d;
    sub_nored(d, r, FRQ);
    o = d;
  } else {
    o = r;
  }
}

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void fr_ctx_init(const uint8_t q[32], const uint8_t r2[32], u64 ninv) {
  memcpy(FRQ.v, q, 32);
  memcpy(FRR2.v, r2, 32);
  FRNINV = ninv;
  U256 one = {{1, 0, 0, 0}};
  fr_mul(FR_ONE_M, one, FRR2);
}

// In-place NTT along n for `batch` contiguous rows of n 32-byte little-endian
// Montgomery-form Fr elements. root: standard-form primitive n-th root
// (caller passes w^{-1} for the inverse transform); scale: standard-form
// multiplier applied to every output when apply_scale != 0 (n^{-1} for the
// inverse transform). Rows are processed by a small thread pool.
void fr_ntt_c(uint8_t *data, u64 n, u64 batch, const uint8_t root[32],
              const uint8_t scale[32], int apply_scale) {
  int k = 0;
  while ((1ull << k) < n) ++k;

  // bit-reversal table
  std::vector<u64> rev(n);
  for (u64 i = 0; i < n; ++i) {
    u64 r = 0;
    for (int b = 0; b < k; ++b) r |= ((i >> b) & 1) << (k - 1 - b);
    rev[i] = r;
  }

  // stage twiddles: stage s (half = 2^s) uses base root^(n / 2^{s+1});
  // tws[s][j] = base^j in Montgomery form, laid out in one flat buffer.
  U256 root_m;
  memcpy(root_m.v, root, 32);
  fr_mul(root_m, root_m, FRR2);  // to Montgomery
  std::vector<U256> base(k);
  if (k > 0) {
    base[k - 1] = root_m;
    for (int s = k - 2; s >= 0; --s) fr_mul(base[s], base[s + 1], base[s + 1]);
  }
  std::vector<U256> tws(n > 1 ? n - 1 : 0);
  std::vector<u64> toff(k, 0);
  {
    u64 off = 0;
    for (int s = 0; s < k; ++s) {
      toff[s] = off;
      u64 half = 1ull << s;
      U256 acc = FR_ONE_M;
      for (u64 j = 0; j < half; ++j) {
        tws[off + j] = acc;
        U256 t;
        fr_mul(t, acc, base[s]);
        acc = t;
      }
      off += half;
    }
  }

  U256 scale_m;
  if (apply_scale) {
    memcpy(scale_m.v, scale, 32);
    fr_mul(scale_m, scale_m, FRR2);
  }

  std::atomic<u64> next{0};
  auto worker = [&]() {
    std::vector<U256> x(n);
    for (;;) {
      u64 row = next.fetch_add(1);
      if (row >= batch) break;
      uint8_t *d = data + row * n * 32;
      for (u64 i = 0; i < n; ++i) memcpy(x[i].v, d + rev[i] * 32, 32);
      for (int s = 0; s < k; ++s) {
        u64 half = 1ull << s;
        const U256 *tw = &tws[toff[s]];
        for (u64 start = 0; start < n; start += 2 * half) {
          for (u64 j = 0; j < half; ++j) {
            U256 v;
            fr_mul(v, x[start + half + j], tw[j]);
            U256 u = x[start + j];
            fr_add(x[start + j], u, v);
            fr_sub(x[start + half + j], u, v);
          }
        }
      }
      if (apply_scale) {
        for (u64 i = 0; i < n; ++i) {
          U256 t;
          fr_mul(t, x[i], scale_m);
          x[i] = t;
        }
      }
      for (u64 i = 0; i < n; ++i) memcpy(d + i * 32, x[i].v, 32);
    }
  };
  unsigned nt = std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > batch) nt = (unsigned)batch;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (unsigned i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto &t : threads) t.join();
  }
}

void fp_ctx_init(const uint8_t q[32], const uint8_t r2[32], u64 ninv,
                 u64 ate_lo, u64 ate_hi) {
  memcpy(Q.v, q, 32);
  Q_STD = Q;
  memcpy(R2.v, r2, 32);
  NINV = ninv;
  ATE_LOOP = ((u128)ate_hi << 64) | ate_lo;
  U256 one = {{1, 0, 0, 0}};
  fp_mul(ONE_M, one, R2);
  for (int i = 0; i < 128; ++i) {
    U256 s = {{(u64)i, 0, 0, 0}};
    fp_mul(SMALL_M[i], s, R2);
  }
}

void g1_add_c(const uint8_t *p, int pinf, const uint8_t *q, int qinf,
              uint8_t *out, int *oinf) {
  G1J a = read_g1(p, pinf), b = read_g1(q, qinf);
  G1J r = g1_add(a, b);
  write_g1(out, oinf, r);
}

void g1_mul_c(const uint8_t *p, int pinf, const uint8_t *k, int klen,
              uint8_t *out, int *oinf) {
  G1J a = read_g1(p, pinf);
  if (pinf) {
    write_g1(out, oinf, g1_infinity());
    return;
  }
  G1J r = g1_scalar_mul(a, k, klen);
  write_g1(out, oinf, r);
}

// MSM over n points: pts = n*64 bytes, infs = n bytes, scalars = n*32 bytes.
// Pippenger with 8-bit windows.
void g1_msm_c(const uint8_t *pts, const uint8_t *infs, const uint8_t *scalars,
              int n, uint8_t *out, int *oinf) {
  G1J total = g1_infinity();
  static const int WB = 8;
  static const int NBUCKETS = 1 << WB;
  G1J *buckets = new G1J[NBUCKETS];
  G1J *points = new G1J[n];
  for (int i = 0; i < n; ++i) points[i] = read_g1(pts + 64 * i, infs[i]);
  for (int w = 31; w >= 0; --w) {
    if (w != 31) {
      for (int d = 0; d < WB; ++d) total = g1_double(total);
    }
    for (int b = 0; b < NBUCKETS; ++b) buckets[b] = g1_infinity();
    for (int i = 0; i < n; ++i) {
      int key = scalars[32 * i + w];
      if (key && !infs[i]) buckets[key] = g1_add(buckets[key], points[i]);
    }
    G1J sum = g1_infinity(), run = g1_infinity();
    for (int b = NBUCKETS - 1; b >= 1; --b) {
      run = g1_add(run, buckets[b]);
      sum = g1_add(sum, run);
    }
    total = g1_add(total, sum);
  }
  delete[] buckets;
  delete[] points;
  write_g1(out, oinf, total);
}

// pairing product check: prod e(P_i, Q_i) == 1.
// g1s: n*64 bytes (+ infs n bytes); g2s: n*128 bytes (x.c0,x.c1,y.c0,y.c1),
// g2infs: n bytes; finexp: little-endian bytes of (q^12-1)/r.
int pairing_check_c(const uint8_t *g1s, const uint8_t *g1infs,
                    const uint8_t *g2s, const uint8_t *g2infs, int n,
                    const uint8_t *finexp, int flen) {
  FQ12 acc = fq12_one();
  for (int i = 0; i < n; ++i) {
    if (g1infs[i] || g2infs[i]) continue;
    U256 px, py;
    read_fp(px, g1s + 64 * i);
    read_fp(py, g1s + 64 * i + 32);
    Pt12 p12;
    p12.x = fq12_from_fq_mont(px);
    p12.y = fq12_from_fq_mont(py);
    p12.inf = false;
    U256 xc0, xc1, yc0, yc1;
    read_fp(xc0, g2s + 128 * i);
    read_fp(xc1, g2s + 128 * i + 32);
    read_fp(yc0, g2s + 128 * i + 64);
    read_fp(yc1, g2s + 128 * i + 96);
    Pt12 q12;
    q12.x = fq12_shift(fq12_from_fq2_mont(xc0, xc1), 2);
    q12.y = fq12_shift(fq12_from_fq2_mont(yc0, yc1), 3);
    q12.inf = false;
    acc = fq12_mul(acc, miller_loop(q12, p12));
  }
  FQ12 f = fq12_pow_bytes(acc, finexp, flen);
  return fq12_eq(f, fq12_one()) ? 1 : 0;
}

}  // extern "C"
