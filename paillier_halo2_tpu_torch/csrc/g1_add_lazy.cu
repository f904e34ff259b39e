// K5, K6: the signed-window MSM's G1 additions over Fq on redundant-form
// accumulators (field.cuh: every coordinate in [0, 2p), Montgomery form,
// infinity encoded as Z == 0 exactly), and K5's bucket loop.
//
// Replaces the Pallas kernels of paillier_halo2_tpu/ec/lazy_point.py:
//   g1_madd_lazy   -> K5 `padd_mixed_packed_lazy` (:172, `_mixed_kernel` :150-168,
//                     formula `_mixed_add_lazy` :51-92): one bucket step, the
//                     accumulator plus an affine point from a packed (n, 16)
//                     row, negated (y -> p - y) where `neg` is set, passed
//                     through where `mask_off` is set;
//   g1_bucket_lazy -> the same step under the `lax.while_loop` of
//                     paillier_halo2_tpu/msm/pippenger.py:305-330: the whole
//                     signed bucket loop in one launch (below);
//   g1_jadd_lazy   -> K6 `padd_lazy` (:220, `_jadd_kernel` :205-216, formula
//                     `_jacobian_add_lazy` :95-129): one step of the
//                     sub-accumulator merge, either side possibly at infinity;
//   g1_merge_lazy  -> K6 under the `lax.fori_loop` of
//                     paillier_halo2_tpu/msm/pippenger.py:335-375: the whole
//                     merge tree of a bucket-loop call, its canonicalisation
//                     and the window-row layout, in one launch (below).
// The formulas are K3's and K2's (g1_add.cu) with every product, sum and
// difference taken in the redundant form, so no normalisation runs inside
// the hot formula; the MSM canonicalises once after the merge. Both are
// nodouble only: a lane with P == +-Q gets h == 0 mod p, so Z3 = Z1*h (K5)
// or Z1*Z2*h (K6) is zero mod p -- a soft infinity that canonicalises to
// Z == 0, never a wrong finite point (lazy_point.py:11-14). The selects keep
// the JAX package's order: in K6 the q_inf select is outermost (:124-126),
// so with both sides at infinity X3, Y3 come from P, unlike K2.
//
// Both formulas run on field.cuh's carry-chain product (`mul_lazy_cc`).
//
// The step kernels: one thread per lane, 128 threads a block, ragged edge
// masked in the kernel. Bound: integer multiply-adds, 11 (K5) or 16 (K6)
// Montgomery products of 264 each per lane, against 258 or 288 bytes of
// traffic; registers limit the blocks in flight.
//
// The bucket loop. On the TPU a grid runs in order, so the JAX package runs
// one bucket step per `while_loop` round, every lane's accumulator through
// HBM each round, with the gathers around it as separate XLA ops. Hopper's
// blocks run in parallel and nothing carries between them, so here the loop
// moves inside the thread: a thread owns one (window, bucket, sub-
// accumulator) lane, holds its accumulator in registers, walks its bucket's
// sorted run j = sub, sub + nsub, ... < count, loads each point's packed row
// as four 16-byte loads, and writes X, Y, Z once, at the lane's place in the
// unsorted lane order. The additions of a lane come in the rounds' order, so
// its accumulator is bit-identical to the round loop's. The lanes arrive
// sorted by the number of additions they need, so the threads of a warp
// finish together. Bound: the multiply-adds, 11 products per lane-round; the
// reads (64 B of row, 4 B of order, 1 B of neg per lane-round) are below it.
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
  pht::mul_lazy_cc<F>(z1z1, Z1, Z1);
  pht::mul_lazy_cc<F>(u2, X2, z1z1);
  pht::mul_lazy_cc<F>(t, Z1, z1z1);
  pht::mul_lazy_cc<F>(s2, Y2, t);
  pht::sub_lazy_cc<F>(h, u2, X1);
  pht::sub_lazy_cc<F>(r, s2, Y1);

  pht::mul_lazy_cc<F>(t, h, h);      // hh
  pht::mul_lazy_cc<F>(hhh, h, t);    // hhh
  pht::mul_lazy_cc<F>(v, X1, t);     // v = X1 * hh
  pht::mul_lazy_cc<F>(t, r, r);      // rr
  pht::sub_lazy_cc<F>(X3, t, hhh);
  pht::add_lazy_cc<F>(t, v, v);
  pht::sub_lazy_cc<F>(X3, X3, t);
  pht::sub_lazy_cc<F>(t, v, X3);
  pht::mul_lazy_cc<F>(t, r, t);
  pht::mul_lazy_cc<F>(u2, Y1, hhh);  // u2 reused as Y1 * hhh
  pht::sub_lazy_cc<F>(Y3, t, u2);
  pht::mul_lazy_cc<F>(Z3, Z1, h);

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
  pht::mul_lazy_cc<F>(z1z1, Z1, Z1);
  pht::mul_lazy_cc<F>(z2z2, Z2, Z2);
  pht::mul_lazy_cc<F>(u1, X1, z2z2);
  pht::mul_lazy_cc<F>(u2, X2, z1z1);
  pht::mul_lazy_cc<F>(t, Z2, z2z2);
  pht::mul_lazy_cc<F>(s1, Y1, t);
  pht::mul_lazy_cc<F>(t, Z1, z1z1);
  pht::mul_lazy_cc<F>(s2, Y2, t);
  pht::sub_lazy_cc<F>(h, u2, u1);
  pht::sub_lazy_cc<F>(r, s2, s1);

  pht::mul_lazy_cc<F>(t, h, h);      // hh
  pht::mul_lazy_cc<F>(hhh, h, t);    // hhh
  pht::mul_lazy_cc<F>(v, u1, t);     // v = u1 * hh
  pht::mul_lazy_cc<F>(t, r, r);      // rr
  pht::sub_lazy_cc<F>(X3, t, hhh);
  pht::add_lazy_cc<F>(t, v, v);
  pht::sub_lazy_cc<F>(X3, X3, t);
  pht::sub_lazy_cc<F>(t, v, X3);
  pht::mul_lazy_cc<F>(t, r, t);
  pht::mul_lazy_cc<F>(s1, s1, hhh);
  pht::sub_lazy_cc<F>(Y3, t, s1);
  pht::mul_lazy_cc<F>(t, Z1, Z2);
  pht::mul_lazy_cc<F>(Z3, t, h);

  const bool p_inf = pht::is_zero(Z1);
  const bool q_inf = pht::is_zero(Z2);
  pht::select(X3, p_inf, X2, X3);
  pht::select(Y3, p_inf, Y2, Y3);
  pht::select(Z3, p_inf, Z2, Z3);
  pht::select(X3, q_inf, X1, X3);
  pht::select(Y3, q_inf, Y1, Y3);
  pht::select(Z3, q_inf, Z1, Z3);
}

// -P = (x, p - y): y in [0, p) gives p - y in (0, p].
__device__ __forceinline__ void negate_y(uint32_t Y[L]) {
  uint32_t p[L];
  pht::p_limbs<F>(p);
  pht::sub_cc8(Y, p, Y);
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
  if (neg[i]) negate_y(Y2);
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

// The bucket loop. Lane i (in need-sorted order) adds the points
// order[win*n + seg + j] for j = sub, sub + nsub, ... < count, each negated
// where neg[win*n + seg + j] is set, to an accumulator that starts at
// infinity (one, one, 0), and writes it to column lane[i] of the (8, n_lanes)
// outputs. rows: (n, 16) words, 16-byte aligned.
constexpr int kLoopMinBlocks = 4;  // 128 threads x 4 blocks: at most 128 registers

__global__ void __launch_bounds__(kThreads, kLoopMinBlocks)
    g1_bucket_lazy_kernel(const uint4* __restrict__ rows, const int32_t* __restrict__ order,
                          const uint8_t* __restrict__ neg, const int32_t* __restrict__ seg,
                          const int32_t* __restrict__ count, const int32_t* __restrict__ sub,
                          const int32_t* __restrict__ nsub, const int32_t* __restrict__ win,
                          const int32_t* __restrict__ lane, uint32_t* __restrict__ ox,
                          uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                          int64_t n_lanes, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const int64_t base = (int64_t)win[i] * n + seg[i];
  const int c = count[i], step = nsub[i];
  uint32_t X[L], Y[L], Z[L];
  pht::set_one<F>(X);
  pht::set_one<F>(Y);
  pht::set_zero(Z);
  // The next point's row is loaded while the current one is added: its two
  // dependent reads (order, then the row) overlap the arithmetic.
  uint4 w0, w1, w2, w3;
  bool ng = false;
  int j = sub[i];
  if (j < c) {
    const uint4* row = rows + (int64_t)order[base + j] * 4;
    w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3];
    ng = neg[base + j] != 0;
  }
  for (; j < c; j += step) {
    uint32_t X2[L] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    uint32_t Y2[L] = {w2.x, w2.y, w2.z, w2.w, w3.x, w3.y, w3.z, w3.w};
    const bool negate = ng;
    if (j + step < c) {
      const int64_t at = base + j + step;
      const uint4* row = rows + (int64_t)order[at] * 4;
      w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3];
      ng = neg[at] != 0;
    }
    if (negate) negate_y(Y2);
    uint32_t X3[L], Y3[L], Z3[L];
    madd_lazy(X3, Y3, Z3, X, Y, Z, X2, Y2, false);
    pht::copy(X, X3);
    pht::copy(Y, Y3);
    pht::copy(Z, Z3);
  }
  const int64_t o = lane[i];
  pht::store(ox, n_lanes, o, X);
  pht::store(oy, n_lanes, o, Y);
  pht::store(oz, n_lanes, o, Z);
}

// The merge. On the TPU each level of every block's halving tree is one K6
// call over all of the block's (row, bucket) lanes, the tree a `fori_loop`
// with every partial sum through HBM, then a canonicalisation, a pad of the
// capped windows' dead buckets and a row reorder as separate XLA ops. Here
// one launch does all of it. A block of the bucket loop's output is
// (s, rows, bcap) accumulators, lane off + j * rows * bcap + r * bcap + b,
// so sub-accumulator j of neighbouring buckets are neighbouring lanes and a
// warp's threads, a bucket each, read them coalesced; bucket (r, b) reduces its s sub-accumulators t[j] by halving, T(j, m/2) =
// T(j, m) + T(j + m/2, m) from T(j, s) = t[j] down to T(0, 1), the first
// operand deciding which X, Y survive an infinity + infinity lane; the
// result is canonicalised and written at (window rows[r], bucket b); a dead
// bucket (b >= bcap) is written as (0, 0, 0).
//
// The nodes T(g, G), g < G, are independent subtrees over the leaves
// g + G * i. A thread owns one and adds its s/G leaves serially, depth
// first: leaf i enters at tree position bitrev(i), so each sum is the
// halving tree's own, and the at most log2(s/G) pending partial sums wait
// in shared memory, not in registers (no spills, 3 blocks an SM). Then the
// G nodes meet:
//  - s <= 256: G = s/8 threads of one warp a bucket (one thread at s <= 8:
//    the main path's s = 8 buckets are a thread each, 7 adds with every
//    lane busy); the levels over g run in registers, the partner fetched by
//    __shfl_down_sync (24 words), only lanes g < half adding.
//  - s >= 512 (the top windows of large MSMs: 4 buckets of s = 4,096 at
//    2^20 points): P = s/512 blocks a bucket, G = 128 P threads of 4 leaves
//    each; block c holds the nodes c + P t, t < 128, so its 7 levels over t
//    pair threads of the same block (through shared memory) and end at
//    T(c, P); the block that finishes a bucket last (a counter per bucket,
//    after __threadfence) adds the P results level by level. The depth is
//    3 + 7 + log2 P adds where K6's launches took log2 s.
// Bound: the multiply-adds, 16 products per tree add, s - 1 adds a live
// bucket, against 96 B per accumulator read and per bucket written. Folding
// the merge into the bucket loop's exit does not fit: the loop's lanes run
// sorted by the additions they need, so a bucket's sub-accumulators sit in
// different warps and blocks there.
constexpr int kMergeThreads = 128;
constexpr int kMergeMinBlocks = 3;  // 128 threads x 3 blocks: at most 170 registers
constexpr int kMergeFields = 9;     // lane_off, s, bcap, rows, row_first, cta_first,
                                    // slot_off, G, P (0: G threads of a warp a bucket)
constexpr int kPointWords = 3 * L;

__device__ __forceinline__ void load_point(uint32_t X[L], uint32_t Y[L], uint32_t Z[L],
                                           const uint32_t* x, const uint32_t* y,
                                           const uint32_t* z, int64_t n, int64_t i) {
  pht::load(X, x, n, i);
  pht::load(Y, y, n, i);
  pht::load(Z, z, n, i);
}

__device__ __forceinline__ void store_point(uint32_t* x, uint32_t* y, uint32_t* z, int64_t n,
                                            int64_t i, const uint32_t X[L], const uint32_t Y[L],
                                            const uint32_t Z[L]) {
  pht::store(x, n, i, X);
  pht::store(y, n, i, Y);
  pht::store(z, n, i, Z);
}

// Shared memory: point k of thread t, word w at [(k * 24 + w) * kMergeThreads + t].
__device__ __forceinline__ void smem_load(uint32_t X[L], uint32_t Y[L], uint32_t Z[L],
                                          const uint32_t* sm, int k, int t) {
#pragma unroll
  for (int w = 0; w < L; w++) {
    X[w] = sm[(k * kPointWords + w) * kMergeThreads + t];
    Y[w] = sm[(k * kPointWords + L + w) * kMergeThreads + t];
    Z[w] = sm[(k * kPointWords + 2 * L + w) * kMergeThreads + t];
  }
}

__device__ __forceinline__ void smem_store(uint32_t* sm, int k, int t, const uint32_t X[L],
                                           const uint32_t Y[L], const uint32_t Z[L]) {
#pragma unroll
  for (int w = 0; w < L; w++) {
    sm[(k * kPointWords + w) * kMergeThreads + t] = X[w];
    sm[(k * kPointWords + L + w) * kMergeThreads + t] = Y[w];
    sm[(k * kPointWords + 2 * L + w) * kMergeThreads + t] = Z[w];
  }
}

// (X, Y, Z) = (X1, Y1, Z1) + (X, Y, Z)
__device__ __forceinline__ void add_left(uint32_t X[L], uint32_t Y[L], uint32_t Z[L],
                                         const uint32_t X1[L], const uint32_t Y1[L],
                                         const uint32_t Z1[L]) {
  uint32_t X3[L], Y3[L], Z3[L];
  jadd_lazy(X3, Y3, Z3, X1, Y1, Z1, X, Y, Z);
  pht::copy(X, X3);
  pht::copy(Y, Y3);
  pht::copy(Z, Z3);
}

// (X, Y, Z) = (X, Y, Z) + (X2, Y2, Z2)
__device__ __forceinline__ void add_right(uint32_t X[L], uint32_t Y[L], uint32_t Z[L],
                                          const uint32_t X2[L], const uint32_t Y2[L],
                                          const uint32_t Z2[L]) {
  uint32_t X3[L], Y3[L], Z3[L];
  jadd_lazy(X3, Y3, Z3, X, Y, Z, X2, Y2, Z2);
  pht::copy(X, X3);
  pht::copy(Y, Y3);
  pht::copy(Z, Z3);
}

// T(g, G) over the 2^d leaves g + G * i at lanes first + stride * i, depth
// first; the pending sums in shared memory slots 0 .. d-1 of this thread.
__device__ __forceinline__ void subtree(uint32_t X[L], uint32_t Y[L], uint32_t Z[L],
                                        const uint32_t* x, const uint32_t* y,
                                        const uint32_t* z, int64_t n_lanes, int64_t first,
                                        int64_t stride, int d, uint32_t* sm) {
  uint32_t X1[L], Y1[L], Z1[L];
  const int t = threadIdx.x;
  for (int p = 0; p < (1 << d); p++) {
    const int i = d ? (int)(__brev((unsigned)p) >> (32 - d)) : 0;
    load_point(X, Y, Z, x, y, z, n_lanes, first + stride * i);
    int q = p, lvl = 0;
    for (; q & 1; q >>= 1, lvl++) {
      smem_load(X1, Y1, Z1, sm, lvl, t);
      add_left(X, Y, Z, X1, Y1, Z1);
    }
    if (p + 1 < (1 << d)) smem_store(sm, lvl, t, X, Y, Z);
  }
}

// The halving levels over the n values of threads 0 .. n-1 of the block
// (n a power of two up to the block), through shared memory slot 0; the
// result ends in thread 0's registers. Every thread of the block calls it.
__device__ __forceinline__ void block_tree(uint32_t X[L], uint32_t Y[L], uint32_t Z[L], int n,
                                           uint32_t* sm) {
  uint32_t X2[L], Y2[L], Z2[L];
  const int t = threadIdx.x;
  for (int half = n >> 1; half > 0; half >>= 1) {
    __syncthreads();  // slot 0 is free: the previous level has read it
    if (t >= half && t < 2 * half) smem_store(sm, 0, t - half, X, Y, Z);
    __syncthreads();
    if (t < half) {
      smem_load(X2, Y2, Z2, sm, 0, t);
      add_right(X, Y, Z, X2, Y2, Z2);
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads, kMergeMinBlocks)
    g1_merge_lazy_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                         const uint32_t* __restrict__ z, const int32_t* __restrict__ meta,
                         int n_blocks, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                         uint32_t* __restrict__ oz, uint32_t* sx, uint32_t* sy, uint32_t* sz,
                         int32_t* counters, int64_t n_lanes, int64_t n_scratch, int64_t n_out,
                         int nb) {
  extern __shared__ uint32_t sm[];
  __shared__ int last;
  int k = 0;  // this CTA's merge block: the last whose first CTA is at or before it
  while (k + 1 < n_blocks && meta[(k + 1) * kMergeFields + 5] <= (int)blockIdx.x) k++;
  const int32_t* e = meta + k * kMergeFields;
  const int64_t lane_off = e[0];
  const int s = e[1], bcap = e[2], rows = e[3], row_first = e[4], cta_first = e[5];
  const int64_t slot_off = e[6];
  const int G = e[7], P = e[8];
  const int32_t* row_list = meta + n_blocks * kMergeFields;
  const int t = threadIdx.x;
  int d = 0;  // log2(s / G)
  while ((G << d) < s) d++;
  uint32_t X[L], Y[L], Z[L];
  const int64_t rb = (int64_t)rows * bcap;  // lanes between sub-accumulators j and j + 1
  if (P == 0) {  // G threads of one warp a bucket: the live buckets, then the dead
    const int64_t gi = (int64_t)(blockIdx.x - cta_first) * (kMergeThreads / G) + t / G;
    const int g = t % G;
    const bool active = gi < (int64_t)rows * nb, live = gi < rb;
    int r = 0, b = 0;
    if (live) {
      r = (int)(gi / bcap), b = (int)(gi % bcap);
    } else if (active) {
      r = (int)((gi - rb) / (nb - bcap)), b = bcap + (int)((gi - rb) % (nb - bcap));
    }
    pht::set_zero(X);
    pht::set_zero(Y);
    pht::set_zero(Z);
    if (live) subtree(X, Y, Z, x, y, z, n_lanes, lane_off + g * rb + gi, G * rb, d, sm);
    uint32_t X2[L], Y2[L], Z2[L];
    for (int half = G >> 1; half > 0; half >>= 1) {  // G is uniform over the CTA
#pragma unroll
      for (int w = 0; w < L; w++) {
        X2[w] = __shfl_down_sync(0xffffffffu, X[w], half);
        Y2[w] = __shfl_down_sync(0xffffffffu, Y[w], half);
        Z2[w] = __shfl_down_sync(0xffffffffu, Z[w], half);
      }
      if (live && g < half) add_right(X, Y, Z, X2, Y2, Z2);
    }
    if (active && g == 0) {
      pht::canonicalize<F>(X, X);  // a dead bucket's zeros stay zeros
      pht::canonicalize<F>(Y, Y);
      pht::canonicalize<F>(Z, Z);
      store_point(ox, oy, oz, n_out, (int64_t)row_list[row_first + r] * nb + b, X, Y, Z);
    }
    return;
  }
  // P blocks a live bucket, then one block for each dead bucket
  const int64_t ci = blockIdx.x - cta_first, live_ctas = rb * P;
  if (ci >= live_ctas) {
    const int64_t dead = ci - live_ctas;
    const int r = (int)(dead / (nb - bcap)), b = bcap + (int)(dead % (nb - bcap));
    if (t < 3 * L) {
      uint32_t* out[3] = {ox, oy, oz};
      out[t / L][(t % L) * n_out + (int64_t)row_list[row_first + r] * nb + b] = 0u;
    }
    return;
  }
  const int64_t bucket = ci / P;  // r * bcap + b
  const int c = (int)(ci % P);
  const int r = (int)(bucket / bcap), b = (int)(bucket % bcap);
  subtree(X, Y, Z, x, y, z, n_lanes, lane_off + (c + (int64_t)P * t) * rb + bucket, G * rb, d,
          sm);
  block_tree(X, Y, Z, kMergeThreads, sm);  // thread 0: T(c, P)
  if (P > 1) {
    const int64_t slot = slot_off + bucket;
    if (t == 0) {
      store_point(sx, sy, sz, n_scratch, slot * P + c, X, Y, Z);
      __threadfence();
      last = atomicAdd(counters + slot, 1) == P - 1;
    }
    __syncthreads();
    if (!last) return;  // uniform over the CTA
    __threadfence();
    if (t < P) {  // the other blocks' results, from L2
#pragma unroll
      for (int w = 0; w < L; w++) {
        X[w] = __ldcg(sx + w * n_scratch + slot * P + t);
        Y[w] = __ldcg(sy + w * n_scratch + slot * P + t);
        Z[w] = __ldcg(sz + w * n_scratch + slot * P + t);
      }
    }
    block_tree(X, Y, Z, P, sm);
  }
  if (t == 0) {
    pht::canonicalize<F>(X, X);
    pht::canonicalize<F>(Y, Y);
    pht::canonicalize<F>(Z, Z);
    store_point(ox, oy, oz, n_out, (int64_t)row_list[row_first + r] * nb + b, X, Y, Z);
  }
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

// The bucket loop: rows (n, 16) uint32, 16-byte aligned; order (W * n)
// int32 point indices by sorted position; neg (W * n) bytes by sorted
// position; seg, count, sub, nsub, win, lane (n_lanes,) int32 in need-sorted
// order; outputs (8, n_lanes) uint32 in [0, 2p).
extern "C" int pht_g1_bucket_lazy(const void* rows, const void* order, const void* neg,
                                  const void* seg, const void* count, const void* sub,
                                  const void* nsub, const void* win, const void* lane, void* ox,
                                  void* oy, void* oz, long long n_lanes, long long n,
                                  void* stream) {
  if (n_lanes <= 0) return 0;
  g1_bucket_lazy_kernel<<<grid_for(n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)rows, (const int32_t*)order, (const uint8_t*)neg, (const int32_t*)seg,
      (const int32_t*)count, (const int32_t*)sub, (const int32_t*)nsub, (const int32_t*)win,
      (const int32_t*)lane, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n_lanes, n);
  return (int)cudaGetLastError();
}

// The merge: x, y, z (8, n_lanes) accumulators in [0, 2p) in the bucket
// loop's lane order; meta int32, n_blocks entries of kMergeFields words and
// then the window row of every block row; outputs (8, n_rows * nb)
// canonical Jacobian buckets; for blocks with P > 1 the scratch (8,
// n_scratch) each and the counters (zero on entry, one a live bucket),
// else null. n_ctas: the last block's cta_first plus its count; smem_slots:
// the largest log2(s / G), at least 1.
extern "C" int pht_g1_merge_lazy(const void* x, const void* y, const void* z, const void* meta,
                                 long long n_blocks, void* ox, void* oy, void* oz, void* sx,
                                 void* sy, void* sz, void* counters, long long n_lanes,
                                 long long n_scratch, long long n_out, long long nb,
                                 long long n_ctas, long long smem_slots, void* stream) {
  if (n_ctas <= 0) return 0;
  const size_t smem = (size_t)smem_slots * kPointWords * kMergeThreads * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(g1_merge_lazy_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  g1_merge_lazy_kernel<<<(unsigned)n_ctas, kMergeThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (const int32_t*)meta,
      (int)n_blocks, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint32_t*)sx,
      (uint32_t*)sy, (uint32_t*)sz, (int32_t*)counters, n_lanes, n_scratch, n_out, (int)nb);
  return (int)cudaGetLastError();
}
