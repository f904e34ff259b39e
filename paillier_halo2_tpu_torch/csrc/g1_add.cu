// K2, K3, K4: batched BN254 G1 point additions over Fq, Jacobian coordinates
// in Montgomery form, infinity encoded as Z == 0 whatever X and Y hold; and
// the MSM's window sums built on K2's addition.
//
// Replaces the Pallas kernels of paillier_halo2_tpu/ec/pallas_point.py:
//   g1_jadd<nodouble>          -> K2 `padd_pallas` (:230, `_jacobian_add_full` :137-202)
//   g1_madd<nodouble, false>   -> K3 `padd_mixed_pallas` (:265, `_mixed_add_full` :65-134)
//   g1_madd<nodouble, true>    -> K4 `padd_mixed_packed_pallas` (:309, `_packed_kernel` :292-305)
//   g1_bucket                  -> K4 under the `lax.while_loop` of the unsigned bucket loop
//                                 (paillier_halo2_tpu/msm/pippenger.py:305-330, neg unset)
//   g1_window_sums             -> K2's use in `_window_sums`
//                                 (paillier_halo2_tpu/msm/pippenger.py:403-432)
//   g1_fixed_base_comb         -> K3's use in the SRS comb `_fixed_base_msm_kernel`
//                                 (paillier_halo2_tpu/plonk/srs.py:90-112)
// The formulas and every edge-case select (P+inf, inf+Q, P+P through the
// doubling branch, P+(-P) to infinity) follow pallas_point.py:93-133 and
// :163-201 in the same order, so outputs are bit-identical to the JAX
// package's, Jacobian representation included. `nodouble` drops the
// doubling branch (7 products) and the h/r zero tests: a lane that breaks
// the caller's distinct-points contract then degrades to Z3 == 0 (h == 0
// makes Z3 = Z1*Z2*h vanish), never to a wrong finite point.
//
// All of them run on field.cuh's carry-chain Fq product and take the
// doubling as a branch, on the lanes with h == r == 0 only, where the JAX
// formulas compute it on every lane and select: 16 products a lane instead
// of 23 for K2, 11 instead of 18 for K3 and K4. The branch writes what the
// select would keep, so the bits are the JAX package's.
//
// One thread per lane for the batched adds. Bound: registers. A Jacobian
// point is 24 limbs and the full add keeps about a dozen 8-limb temporaries
// live around the Montgomery products, so blocks are small (128 threads) to
// leave room; the arithmetic itself is compute-bound like K1.
//
// The window sums: T_w = sum_b b * B_{w,b} by a Hillis-Steele suffix scan,
// then a Hillis-Steele reduction, over the bucket axis of each row, with the
// masked pairs of `_window_sums` in the same order, so T_w equals the
// composition of 2 * ceil(log2 B) K2 launches bit for bit (the X and Y a
// masked operand keeps matter when both sides are infinity, so they are
// taken from the rolled lane as `torch.roll` takes them). The TPU version is
// that composition: each step reads and writes every (row, bucket) point
// through HBM, with a roll and a select around each add. Here one block owns
// one row: its B points (96 B each, coordinates limb-major with stride B, so
// a warp's reads of one limb hit 32 banks) stay in shared memory, double-
// buffered (192 B per bucket: 196,800 B at B = 1,025, above 48 KB through
// cudaFuncSetAttribute), each thread adding ceil(B / threads) lanes per step
// between two barriers; one launch per MSM call. The reduction computes only
// the lanes that reach lane 0 (see the kernel). Bound on this card: not the
// multiply-adds but occupancy. A row is one block of at most 384 threads, so
// 24 rows (the 2^20 MSM) fill 24 of 132 SMs with 11 warps each, and every
// warp issues one dependent carry chain after another.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using F = pht::Fq;
constexpr int kThreads = 128;
constexpr int L = pht::kLimbs;

// The canonical Fq operations (field.cuh): inputs and results in [0, p).
__device__ __forceinline__ void mul(uint32_t r[L], const uint32_t a[L], const uint32_t b[L]) {
  pht::mul_cc<F>(r, a, b);
}
__device__ __forceinline__ void add(uint32_t r[L], const uint32_t a[L], const uint32_t b[L]) {
  pht::add_cc<F>(r, a, b);
}
__device__ __forceinline__ void sub(uint32_t r[L], const uint32_t a[L], const uint32_t b[L]) {
  pht::sub_cc<F>(r, a, b);
}

// dbl-2009-l (a = 0) of (X1, Y1, Z1), as pallas_point.py:98-112.
__device__ __forceinline__ void dbl(uint32_t Xd[L], uint32_t Yd[L], uint32_t Zd[L],
                                    const uint32_t X1[L], const uint32_t Y1[L],
                                    const uint32_t Z1[L]) {
  uint32_t A[L], B[L], C[L], t[L], D[L], E[L], Fv[L], C8[L], YZ[L];
  mul(A, X1, X1);
  mul(B, Y1, Y1);
  mul(C, B, B);
  add(t, X1, B);
  mul(t, t, t);
  sub(D, t, A);
  sub(D, D, C);
  add(D, D, D);
  add(E, A, A);
  add(E, E, A);
  mul(Fv, E, E);
  add(t, D, D);
  sub(Xd, Fv, t);
  add(C8, C, C);
  add(C8, C8, C8);
  add(C8, C8, C8);
  sub(t, D, Xd);
  mul(t, E, t);
  sub(Yd, t, C8);
  mul(YZ, Y1, Z1);
  add(Zd, YZ, YZ);
}

// Jacobian + Jacobian, as `_jacobian_add_full`.
template <bool kNoDouble>
__device__ __forceinline__ void jadd(uint32_t X3[L], uint32_t Y3[L], uint32_t Z3[L],
                                     const uint32_t X1[L], const uint32_t Y1[L],
                                     const uint32_t Z1[L], const uint32_t X2[L],
                                     const uint32_t Y2[L], const uint32_t Z2[L]) {
  uint32_t z1z1[L], z2z2[L], u1[L], u2[L], s1[L], s2[L], h[L], r[L], t[L], hhh[L], v[L];
  mul(z1z1, Z1, Z1);
  mul(z2z2, Z2, Z2);
  mul(u1, X1, z2z2);
  mul(u2, X2, z1z1);
  mul(t, Z2, z2z2);
  mul(s1, Y1, t);
  mul(t, Z1, z1z1);
  mul(s2, Y2, t);
  sub(h, u2, u1);
  sub(r, s2, s1);

  mul(t, h, h);      // hh
  mul(hhh, h, t);    // hhh
  mul(v, u1, t);     // v = u1 * hh
  mul(t, r, r);      // rr
  sub(X3, t, hhh);
  add(t, v, v);
  sub(X3, X3, t);
  sub(t, v, X3);
  mul(t, r, t);
  mul(s1, s1, hhh);
  sub(Y3, t, s1);
  mul(t, Z1, Z2);
  mul(Z3, t, h);

  const bool p_inf = pht::is_zero(Z1);
  const bool q_inf = pht::is_zero(Z2);
  if (!kNoDouble) {
    const bool h_zero = pht::is_zero(h);
    const bool r_zero = pht::is_zero(r);
    if (h_zero && r_zero) {  // P == Q: the doubling runs on these lanes only
      dbl(X3, Y3, Z3, X1, Y1, Z1);
    }
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
  mul(z1z1, Z1, Z1);
  mul(u2, X2, z1z1);
  mul(t, Z1, z1z1);
  mul(s2, Y2, t);
  sub(h, u2, X1);
  sub(r, s2, Y1);

  mul(t, h, h);      // hh
  mul(hhh, h, t);    // hhh
  mul(v, X1, t);     // v = X1 * hh
  mul(t, r, r);      // rr
  sub(X3, t, hhh);
  add(t, v, v);
  sub(X3, X3, t);
  sub(t, v, X3);
  mul(t, r, t);
  mul(u2, Y1, hhh);  // u2 reused as Y1 * hhh
  sub(Y3, t, u2);
  mul(Z3, Z1, h);

  const bool p_inf = pht::is_zero(Z1);
  uint32_t one[L], zero[L];
  pht::set_one<F>(one);
  pht::set_zero(zero);
  if (!kNoDouble) {
    const bool h_zero = pht::is_zero(h);
    const bool r_zero = pht::is_zero(r);
    if (h_zero && r_zero) {  // P == Q: the doubling runs on these lanes only
      dbl(X3, Y3, Z3, X1, Y1, Z1);
    }
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

// The SRS comb: acc_i = sum_w table[w][digit_w(s_i)] over the 32 8-bit
// windows of scalar i, in window order 0 to 31, each step K3's full mixed
// add (q_inf for digit 0, the doubling branch, P + (-P) to infinity), from
// acc = (one, one, 0). The JAX package runs it as a `fori_loop` of 32 K3
// calls, each with its gathers of the window's table rows around it, every
// accumulator through HBM each step. Here one thread owns one scalar, keeps
// its accumulator in registers and loops over the windows: it reads the
// scalar limb of each window's digit and the window's table row (16 words:
// X, then Y) as four 16-byte loads. Neither is held across the add, which
// keeps the kernel at 128 registers, 4 blocks an SM: the loads wait a few
// hundred cycles against an add of thousands, and holding the scalar and
// the next row in registers (158 registers, 3 blocks an SM) measured slower
// (PERF.md). The table (32 x 256 rows, 512 KB, and 8 KB of infinity flags)
// is read by every thread and stays in L2; staging it in shared memory
// would move bytes, which are not the limit. Bound: the multiply-adds, 11 products a
// lane-window (doubling lanes need an SRS scalar at or above r and take 7
// more). At 2^14 scalars (the main path's SRS) one thread a scalar is 128
// blocks, under one wave of 132 SMs, so the kernel is bound there by
// occupancy and each thread's chain of 32 adds. Spreading a scalar's windows
// over several threads would add them in another order and change the
// Jacobian bits; that is not done.
constexpr int kCombWindows = 32;
constexpr int kCombEntries = 256;
constexpr int kCombMinBlocks = 4;  // 128 threads x 4 blocks: at most 128 registers

__global__ void __launch_bounds__(kThreads, kCombMinBlocks)
    g1_fixed_base_comb_kernel(const uint4* __restrict__ table,
                              const uint8_t* __restrict__ table_inf,
                              const uint32_t* __restrict__ scalars, uint32_t* __restrict__ ox,
                              uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t X[L], Y[L], Z[L];
  pht::set_one<F>(X);
  pht::set_one<F>(Y);
  pht::set_zero(Z);
#pragma unroll 1
  for (int w = 0; w < kCombWindows; w++) {
    const uint32_t limb = scalars[(w >> 2) * n + i];  // L1 holds it for four windows
    const int e = w * kCombEntries + ((limb >> (8 * (w & 3))) & 0xffu);
    const uint4* row = table + e * 4;
    const uint4 w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3];
    const uint32_t X2[L] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const uint32_t Y2[L] = {w2.x, w2.y, w2.z, w2.w, w3.x, w3.y, w3.z, w3.w};
    uint32_t X3[L], Y3[L], Z3[L];
    madd<false>(X3, Y3, Z3, X, Y, Z, X2, Y2, table_inf[e] != 0);
    pht::copy(X, X3);
    pht::copy(Y, Y3);
    pht::copy(Z, Z3);
  }
  pht::store(ox, n, i, X);
  pht::store(oy, n, i, Y);
  pht::store(oz, n, i, Z);
}

// The unsigned bucket loop: K4's nodouble step under the JAX package's
// `while_loop`, which on the TPU is one K4 call a round with every lane's
// accumulator through HBM and the row gathers around it as separate ops;
// on this card such rounds are host-bound (1,029 of them at 2^20 points,
// each about ten torch ops around one K4 launch). As g1_bucket_lazy_kernel
// (g1_add_lazy.cu) does for the signed route, the loop moves inside the
// thread: lane i (in need-sorted order) starts at infinity (one, one, 0),
// adds the points order[win*n + seg + j] for j = sub, sub + nsub, ... <
// count with madd<true> on canonical coordinates, prefetching the next row
// during the current add, and writes column lane[i] of the (8, n_lanes)
// outputs once. A round with j >= count is not taken: in the rounds, K4's
// q_inf select leaves that lane's accumulator as it was, so every output
// bit is the rounds'.
// Bound: the multiply-adds, 11 products a lane-round, against 68 B of reads
// a lane-round (row and order).
//
// One thread a lane, at most 128 registers a thread (4 blocks of 128 an SM),
// as the signed loop. A persistent grid drawing 32-lane chunks of the
// need-sorted table from one atomic counter gives the same bits but was
// 45-50 % slower on an H100 at 2^20 points (PERF.md §6).
constexpr int kLoopMinBlocks = 4;

__global__ void __launch_bounds__(kThreads, kLoopMinBlocks)
    g1_bucket_kernel(const uint4* __restrict__ rows, const int32_t* __restrict__ order,
                     const int32_t* __restrict__ seg, const int32_t* __restrict__ count,
                     const int32_t* __restrict__ sub, const int32_t* __restrict__ nsub,
                     const int32_t* __restrict__ win, const int32_t* __restrict__ lane,
                     uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                     uint32_t* __restrict__ oz, int64_t n_lanes, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const int64_t base = (int64_t)win[i] * n + seg[i];
  const int c = count[i], step = nsub[i];
  uint32_t X[L], Y[L], Z[L];
  pht::set_one<F>(X);
  pht::set_one<F>(Y);
  pht::set_zero(Z);
  uint4 w0, w1, w2, w3;
  int j = sub[i];
  if (j < c) {
    const uint4* row = rows + (int64_t)order[base + j] * 4;
    w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3];
  }
  for (; j < c; j += step) {
    const uint32_t X2[L] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const uint32_t Y2[L] = {w2.x, w2.y, w2.z, w2.w, w3.x, w3.y, w3.z, w3.w};
    if (j + step < c) {
      const uint4* row = rows + (int64_t)order[base + j + step] * 4;
      w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3];
    }
    uint32_t X3[L], Y3[L], Z3[L];
    madd<true>(X3, Y3, Z3, X, Y, Z, X2, Y2, false);
    pht::copy(X, X3);
    pht::copy(Y, Y3);
    pht::copy(Z, Z3);
  }
  const int64_t o = lane[i];
  pht::store(ox, n_lanes, o, X);
  pht::store(oy, n_lanes, o, Y);
  pht::store(oz, n_lanes, o, Z);
}

// Window sums, one block per row. Coordinates (8, rows, B) limb-first; the
// outputs (8, rows). Shared memory: two buffers of 24 * B words, word k of
// coordinate c of bucket b at [(c * 8 + k) * B + b].
constexpr int kWsMaxThreads = 384;  // at most 170 registers a thread
constexpr int kWsMaxBuckets = 1210;  // 2 * 96 * B bytes within a block's 232,448

__device__ __forceinline__ void smem_point(uint32_t X[L], uint32_t Y[L], uint32_t Z[L],
                                           const uint32_t* buf, int B, int b) {
#pragma unroll
  for (int k = 0; k < L; k++) {
    X[k] = buf[k * B + b];
    Y[k] = buf[(L + k) * B + b];
    Z[k] = buf[(2 * L + k) * B + b];
  }
}

__global__ void __launch_bounds__(kWsMaxThreads, 1)
    g1_window_sums_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                          const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                          uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int rows, int B,
                          int log_b) {
  extern __shared__ uint32_t smem[];
  uint32_t* cur = smem;
  uint32_t* nxt = smem + 3 * L * B;
  const int row = blockIdx.x;
  const int64_t limb_stride = (int64_t)rows * B;
  const uint32_t* in[3] = {x, y, z};
  for (int e = threadIdx.x; e < 3 * L * B; e += blockDim.x) {
    const int ck = e / B, b = e - ck * B;
    cur[e] = in[ck / L][(ck % L) * limb_stride + (int64_t)row * B + b];
  }
  __syncthreads();
  for (int phase = 0; phase < 2; phase++) {
    if (phase == 1) {  // t = masked(s, idx >= 1): drop S_0, keep its X and Y
      if (threadIdx.x < L) cur[(2 * L + threadIdx.x) * B] = 0u;
      __syncthreads();
    }
    for (int i = 0; i < log_b; i++) {
      const int step = 1 << i;
      // The scan needs every lane. The reduction's result is lane 0, which
      // after step i depends only on the lanes (m * 2^(i+1)) mod B,
      // m < 2^(log_b - i - 1): those are computed (each once: a wrapped lane
      // that is also a multiple is skipped), with the same pairs as the full
      // step, so lane 0 keeps its bits and the work drops from B log B adds
      // to about 2^log_b.
      const int stride = phase == 0 ? 1 : step << 1;
      const int count = phase == 0 ? B : 1 << (log_b - i - 1);
      for (int m = threadIdx.x; m < count; m += blockDim.x) {
        int b = m * stride;
        if (b >= B) {
          b -= B;
          if (b % stride == 0) continue;
        }
        const int q = b + step < B ? b + step : b + step - B;  // torch.roll(-step)
        uint32_t X1[L], Y1[L], Z1[L], X2[L], Y2[L], Z2[L], X3[L], Y3[L], Z3[L];
        smem_point(X1, Y1, Z1, cur, B, b);
        smem_point(X2, Y2, Z2, cur, B, q);
        if (b >= B - step) pht::set_zero(Z2);  // masked: past the last bucket
        jadd<false>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
#pragma unroll
        for (int k = 0; k < L; k++) {
          nxt[k * B + b] = X3[k];
          nxt[(L + k) * B + b] = Y3[k];
          nxt[(2 * L + k) * B + b] = Z3[k];
        }
      }
      __syncthreads();
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  if (threadIdx.x < 3 * L) {  // lane 0 of the reduction is T_w
    uint32_t* out[3] = {ox, oy, oz};
    out[threadIdx.x / L][(threadIdx.x % L) * rows + row] = cur[threadIdx.x * B];
  }
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

// Window sums: x, y, z (8, rows, n_buckets) canonical Jacobian buckets,
// ox, oy, oz (8, rows). Returns cudaErrorInvalidValue for n_buckets outside
// [1, 1210], whose two buffers would not fit a block's shared memory.
extern "C" int pht_g1_window_sums(const void* x, const void* y, const void* z, void* ox,
                                  void* oy, void* oz, long long rows, long long n_buckets,
                                  void* stream) {
  if (rows <= 0) return 0;
  if (n_buckets < 1 || n_buckets > kWsMaxBuckets) return (int)cudaErrorInvalidValue;
  const int B = (int)n_buckets;
  int log_b = 0;  // ceil(log2 B), the Hillis-Steele step count
  while ((1 << log_b) < B) log_b++;
  const int smem = 2 * 3 * L * B * (int)sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(g1_window_sums_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int passes = (B + kWsMaxThreads - 1) / kWsMaxThreads;  // lanes per thread per step
  const int threads = ((B + passes - 1) / passes + 31) / 32 * 32;
  g1_window_sums_kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, (int)rows, B, log_b);
  return (int)cudaGetLastError();
}

// The SRS comb: table (32 * 256, 16) uint32 rows, 16-byte aligned, row
// w * 256 + d = the affine point d * 2^(8w) * G (X limbs, then Y limbs,
// Montgomery); table_inf (32 * 256) bytes, nonzero marks a row as infinity;
// scalars (8, n) standard-form limbs; outputs (8, n) Jacobian.
extern "C" int pht_g1_fixed_base_comb(const void* table, const void* table_inf,
                                      const void* scalars, void* ox, void* oy, void* oz,
                                      long long n, void* stream) {
  if (n <= 0) return 0;
  g1_fixed_base_comb_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const uint8_t*)table_inf, (const uint32_t*)scalars, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

// The unsigned bucket loop: rows (n, 16) uint32, 16-byte aligned; order
// (W * n) int32 point indices by sorted position; seg, count, sub, nsub,
// win, lane (n_lanes) int32, best sorted by need, descending; outputs (8,
// n_lanes) canonical Jacobian.
extern "C" int pht_g1_bucket(const void* rows, const void* order, const void* seg,
                             const void* count, const void* sub, const void* nsub,
                             const void* win, const void* lane, void* ox, void* oy, void* oz,
                             long long n_lanes, long long n, void* stream) {
  if (n_lanes <= 0) return 0;
  g1_bucket_kernel<<<grid_for(n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)rows, (const int32_t*)order, (const int32_t*)seg, (const int32_t*)count,
      (const int32_t*)sub, (const int32_t*)nsub, (const int32_t*)win, (const int32_t*)lane,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n_lanes, n);
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
