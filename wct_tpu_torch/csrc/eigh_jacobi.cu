// Batched symmetric eigendecomposition by two-sided block Jacobi, fp32, for
// sm_90a: what torch.linalg.eigh returns (eigenvalues ascending, signed;
// eigenvectors orthonormal, column i for eigenvalue i), in one launch for the
// whole batch.
//
// Replaces no TPU kernel: the JAX package takes XLA's stock eigh. It was added
// because PyTorch's eigh of a float32 batch with 32 <= C <= 512 runs cuSOLVER's
// syevj one matrix at a time and then checks `info` on the host: on the WCT's
// default route that took 31.5 ms of the card's time per 512-px frame, and the
// host waited at every level while the card sat idle (PERF.md).
//
// Algorithm (ops/eigh.py has its plain twin, the same steps in PyTorch).
//   The matrix is copied (from its lower triangle, as eigh reads it) into a
//   workspace A padded to np = C rounded up to 32, zero outside C x C; the
//   padded indices never couple (a rotation needs a nonzero off-diagonal
//   entry) and are dropped at the end. Indices fall in blocks of 16, and a
//   round-robin tournament pairs the np / 16 blocks: a sweep is np / 16 - 1
//   rounds; pair k of round r is (seat(k), seat(np / 16 - 1 - k)).
//   Each round:
//   1. Every pair's 32 x 32 diagonal sub-matrix S gets one Jacobi sweep in
//      shared memory, in steps of 16 disjoint rotations, each taken only where
//      |s_pq| > tol sqrt|s_pp| sqrt|s_qq| (threshold Jacobi keeps the small
//      eigenvalues' relative accuracy), in Rutishauser's form. In a sweep's
//      first round the steps are a round-robin over all 32 indices (31 steps,
//      every index against the rest of its own block too); in the other
//      rounds the 16 steps that meet each index of one block with each of the
//      other's, so each pair of indices turns once a sweep and the chain of
//      dependent steps is 31 + 16 (np / 16 - 2) long. The product Q of its
//      rotations is re-orthogonalised once, Q <- Q - Q (Q^T Q - I) / 2.
//   2. Every tile moves: A[P_l, P_k] <- Q_l^T A[P_l, P_k] Q_k, for l < k
//      written to (l, k) and transposed to (k, l), on the diagonal averaged
//      with its transpose, so A stays exactly symmetric. (Writing the rotated
//      S there instead, with Q re-orthogonalised after it was formed, left
//      the relu1_1 covariances' A^-1/2 three times farther from float64.)
//      The eigenvectors, kept as the rows of Vt, move as Vt[P_k, :] <- Q_k^T
//      Vt[P_k, :].
//   After the last round of a sweep a matrix stops if no off-diagonal entry
//   is above tol sqrt|d_i| sqrt|d_j|, d the diagonals of the rotated S's (the
//   next sweep would rotate next to nothing), or after max_sweeps sweeps,
//   when it adds 1 to `capped`. Then Vt is re-orthogonalised once, Vt <- Vt -
//   (Vt Vt^T - I) Vt / 2, the diagonal is ranked (stable; a total order on the
//   float bits, NaN last) and eigenvalues and vectors are written in that
//   order.
//
// Mapping. One cluster of np / 32 blocks of 256 threads per matrix, one
// block per pair, up to 16: a cluster size above 8 is non-portable, and the
// attribute that allows it is set on every call, as it belongs to the
// current device; where a card cannot place such a cluster the launch is
// refused and the caller raises. The block that owns pair k in a round runs its inner
// sweep: S and Q ping-pong between two buffers so that a step needs one
// barrier, and in every warp lane l forms rotation l mod 16 and hands it
// round by shuffles. A cluster barrier; then each block stages the round's
// Q's in shared memory, and its warps take the units of work one at a time,
// each to the least loaded warp: the tiles (dealt round the blocks; lane b
// holds column b of the tile, then row b of Q_l^T X, the Q's read as
// broadcasts) and, 32 columns at a time, its pairs' rows of Vt. A cluster
// barrier. A, Vt, the Q's and the rotated S's diagonals live in the
// workspace (L2: 4 x 3 MB at C = 512, batch 4), read with ld.global.cg so
// that no block sees a stale L1 line of another's writes. Each matrix's
// cluster stops on its own. Nothing is copied to the host and nothing is
// allocated: the caller passes outputs, workspace and the counter. All
// arithmetic is f32 on the FFMA units (tensor cores in 3xTF32 were 6 %
// faster at C = 512 and far less accurate on ill-conditioned matrices).
//
// Bound on an H100. The function needs about 9 C^3 FLOP a matrix, whatever
// computes it (a dense eigendecomposition: tridiagonal reduction, its
// eigenvectors, the back-transform), and far fewer bytes (A in, U and s
// out). At 512 px, batch 4, the five levels (C = 512, 512, 256, 128, 64)
// need about 10.4 GFLOP, 0.15 ms at 67 TFLOP/s (FFMA, the H100 SXM's
// data-sheet rate): that is the bound. Jacobi does about 8 times that work:
// a round costs about 128 np^2 FLOP (the tiles' two products, 64 np^2; Vt's,
// 64 np^2) and a sweep np / 16 - 1 rounds, about 8 np^3 a sweep, and the
// trained covariances take 8 (C = 64) to 11 (C = 512) sweeps: about 83
// GFLOP, 1.24 ms at the same rate. Neither is what holds a call back: a
// cluster works on one matrix, so a batch of 4 at C = 512 fills 64 of the
// 132 SMs, and each of the 341 rounds of a C = 512 call is a chain: the
// inner sweep's 16 (31) dependent steps, a barrier, the tiles, a barrier.
// Measured per round at C = 512 with clock stamps (a build not kept, PERF.md): inner sweep 17 k cycles,
// tiles and vectors 34 k, barriers and staging 7 k. By an instruction count
// the tile products issue in about a third of their cycles: two warps to a
// scheduler are too few to hide the latency of their loads and broadcasts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 16;    // indices per block
constexpr int kMaxPairs = 16;  // np / 32 at C = 512
constexpr int kLd = 33;       // padded row of a 32 x 32 tile in shared memory
constexpr int kTile = 32 * kLd;
constexpr int kFlagWords = 64;  // one flag per sweep; max_sweeps < kFlagWords

// A matrix's region of the workspace, in floats.
struct Layout {
  int n, np, nb, pairs;
  size_t a, vt, w, q, s, diag, flags, per_matrix;
};

__host__ __device__ inline Layout layout(int n) {
  Layout L;
  L.n = n;
  L.np = 32 * ((n + 31) / 32);
  L.nb = L.np / kBlock;
  L.pairs = L.np / 32;
  const size_t sq = static_cast<size_t>(L.np) * L.np;
  L.a = 0;
  L.vt = sq;
  L.w = 2 * sq;
  L.q = 3 * sq;
  L.s = L.q + static_cast<size_t>(L.pairs) * 1024;
  L.diag = L.s + static_cast<size_t>(L.pairs) * 32;
  L.flags = L.diag + L.np;
  L.per_matrix = L.flags + kFlagWords;  // a multiple of 32 floats
  return L;
}

// Dynamic shared memory, in floats: every Q of a round (dense 32 x 32, read
// as broadcasts), one scratch tile per warp, the inner sweep's S and Q twice
// over (ping-pong), each pair's sqrt|diag S| after its inner sweep, the
// diagonal and the ranks for the sort.
struct Smem {
  float* qall;
  float* warp;
  float* s;
  float* q;
  float* x;
  float* y;
  float* root;
  float* diag;
  int* rank;
};

__host__ __device__ inline size_t smem_floats(int pairs) {
  return static_cast<size_t>(pairs) * 1024 + kWarps * kTile + 4 * kTile + pairs * 32 + 512 + 512;
}

__device__ inline Smem carve(float* base, int pairs) {
  Smem m;
  m.qall = base;
  m.warp = m.qall + pairs * 1024;
  m.s = m.warp + kWarps * kTile;
  m.q = m.s + kTile;
  m.x = m.q + kTile;
  m.y = m.x + kTile;
  m.root = m.y + kTile;
  m.diag = m.root + pairs * 32;
  m.rank = reinterpret_cast<int*>(m.diag + 512);
  return m;
}

// Every write of the cluster before every read after: the writes go to L2
// (global memory) and are read back with ld.global.cg.
__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  cg::this_cluster().sync();
}

// Seat of player i in round r of the circle method on `players` players.
__device__ __forceinline__ int seat(int i, int r, int players) {
  return i == 0 ? 0 : (i - 1 + r) % (players - 1) + 1;
}

// Index in the padded matrix of entry a (0..31) of the pair of blocks (bi, bj).
__device__ __forceinline__ int pair_index(int bi, int bj, int a) {
  return a < kBlock ? kBlock * bi + a : kBlock * bj + (a - kBlock);
}

// Row-major unsigned key that orders floats as numbers (-0 as +0), NaN last.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The u-th pair (m0 < m1) of n indices, in the order (0, 1), (0, 2), ...
__device__ __forceinline__ void upper_pair(int u, int n, int* m0, int* m1) {
  int m = 0, rem = u;
  while (rem >= n - 1 - m) {
    rem -= n - 1 - m;
    ++m;
  }
  *m0 = m;
  *m1 = m + 1 + rem;
}

// sqrt by the card's approximate unit (relative error about 2^-23).
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The round-robin pairs of a sweep's first round, in shared memory: for
// each of its 31 steps, the 16 pairs (p, q) of indices of S.
struct Steps {
  unsigned char full[31][16][2];
};

__device__ void fill_steps(Steps* st) {
  for (int e = threadIdx.x; e < 31 * 16; e += kThreads) {
    const int step = e / 16, m = e % 16;
    st->full[step][m][0] = static_cast<unsigned char>(seat(m, step, 32));
    st->full[step][m][1] = static_cast<unsigned char>(seat(31 - m, step, 32));
  }
}

struct Rotation {
  float c, s, pp, qq;
  bool rot;
};

// The Jacobi rotation of S's indices p, q (Rutishauser's), where |s_pq| > tol
// sqrt|s_pp| sqrt|s_qq|, else the identity; with the card's approximate square
// root and reciprocal. Every thread that needs it forms it from the same
// entries by the same instructions, so all agree to the bit.
__device__ __forceinline__ Rotation rotation(const float* S, int p, int q, float tol) {
  const float app = S[p * kLd + p], aqq = S[q * kLd + q], apq = S[p * kLd + q];
  Rotation r;
  r.rot = fabsf(apq) > tol * sqrt_approx(fabsf(app)) * sqrt_approx(fabsf(aqq));
  float t = 0.f;
  if (r.rot) {
    const float theta = __fdividef(aqq - app, 2.f * apq);
    if (fabsf(theta) > 1e15f) {
      t = __fdividef(0.5f, theta);
    } else if (theta == 0.f) {
      t = 1.f;
    } else {
      t = __fdividef(copysignf(1.f, theta), fabsf(theta) + sqrt_approx(theta * theta + 1.f));
    }
  }
  r.c = rsqrtf(t * t + 1.f);
  r.s = t * r.c;
  r.pp = app - t * apq;
  r.qq = aqq + t * apq;
  return r;
}

// Pair m of step e: the first round's round-robin, or (kCross) index m of the
// first block against 16 + (m + e) mod 16 of the second.
template <bool kCross>
__device__ __forceinline__ void step_pair(const Steps* st, int e, int m, int* p, int* q) {
  if (kCross) {
    *p = m;
    *q = kBlock + ((m + e) & (kBlock - 1));
  } else {
    *p = st->full[e][m][0];
    *q = st->full[e][m][1];
  }
}

// One Jacobi sweep of S over `steps` steps of 16 disjoint rotations, S and Q
// ([32 x kLd], Q = I on entry) ping-ponging between s0, s1 and q0, q1
// so that a step needs one barrier: it reads one buffer and writes every
// entry of the other. In every warp lane l forms rotation l mod 16 and hands
// it round by shuffles. Thread tid < 120 moves the 2 x 2 block between
// rotations m < m2 (rows of m, columns of m2, and its mirror), threads
// 120..135 rotation tid - 120's own block, and every thread two rows of Q's
// columns p, q of rotation tid / 16. The result is in s1, q1 after an odd
// number of steps, else in s0, q0.
template <bool kCross>
__device__ __forceinline__ void inner_sweep(float* s0, float* s1, float* q0, float* q1, float tol,
                                            int steps, const Steps* st) {
  constexpr unsigned kAll = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31;
  int m = 0, m2 = 0;
  if (tid < 120) upper_pair(tid, 16, &m, &m2);
  const int md = tid >= 120 && tid < 136 ? tid - 120 : 0;
  const int mq = tid >> 4, r0 = tid & 15;
  for (int e = 0; e < steps; ++e) {
    const float* cur = (e & 1) ? s1 : s0;  // selects, not an array: the pointers stay shared
    float* next = (e & 1) ? s0 : s1;
    int p, q;
    step_pair<kCross>(st, e, lane & 15, &p, &q);
    const Rotation own = rotation(cur, p, q, tol);
    const float c1 = __shfl_sync(kAll, own.c, m), s1 = __shfl_sync(kAll, own.s, m);
    const float c2 = __shfl_sync(kAll, own.c, m2), s2 = __shfl_sync(kAll, own.s, m2);
    const float cq = __shfl_sync(kAll, own.c, mq), sq = __shfl_sync(kAll, own.s, mq);
    const int rot = __shfl_sync(kAll, static_cast<int>(own.rot), md);
    const float pp = __shfl_sync(kAll, own.pp, md), qq = __shfl_sync(kAll, own.qq, md);
    if (tid < 120) {
      int p1, q1, p2, q2;
      step_pair<kCross>(st, e, m, &p1, &q1);
      step_pair<kCross>(st, e, m2, &p2, &q2);
      const float x00 = cur[p1 * kLd + p2], x01 = cur[p1 * kLd + q2];
      const float x10 = cur[q1 * kLd + p2], x11 = cur[q1 * kLd + q2];
      const float y00 = c1 * x00 - s1 * x10, y01 = c1 * x01 - s1 * x11;
      const float y10 = s1 * x00 + c1 * x10, y11 = s1 * x01 + c1 * x11;
      const float z00 = c2 * y00 - s2 * y01, z01 = s2 * y00 + c2 * y01;
      const float z10 = c2 * y10 - s2 * y11, z11 = s2 * y10 + c2 * y11;
      next[p1 * kLd + p2] = z00;
      next[p1 * kLd + q2] = z01;
      next[q1 * kLd + p2] = z10;
      next[q1 * kLd + q2] = z11;
      next[p2 * kLd + p1] = z00;
      next[q2 * kLd + p1] = z01;
      next[p2 * kLd + q1] = z10;
      next[q2 * kLd + q1] = z11;
    } else if (tid < 136) {
      int pd, qd;
      step_pair<kCross>(st, e, md, &pd, &qd);
      const float apq = rot ? 0.f : cur[pd * kLd + qd];
      next[pd * kLd + pd] = rot ? pp : cur[pd * kLd + pd];
      next[qd * kLd + qd] = rot ? qq : cur[qd * kLd + qd];
      next[pd * kLd + qd] = apq;
      next[qd * kLd + pd] = apq;
    }
    {
      int pq_, qq_;
      step_pair<kCross>(st, e, mq, &pq_, &qq_);
      const float* qc = (e & 1) ? q1 : q0;
      float* qn = (e & 1) ? q0 : q1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * h;
        const float a = qc[row * kLd + pq_], b = qc[row * kLd + qq_];
        qn[row * kLd + pq_] = cq * a - sq * b;
        qn[row * kLd + qq_] = sq * a + cq * b;
      }
    }
    __syncthreads();
  }
}

// acc[i] += sum_c opA(a0 + i, c) opB(c, b) over 32 x kLd tiles in shared
// memory; thread: b = lane, a0 = 4 warp. opA(a, c) = A[c][a] if kTA else
// A[a][c]; opB(c, b) = B[b][c] if kTB else B[c][b].
template <bool kTA, bool kTB>
__device__ __forceinline__ void product32(float acc[4], const float* A, const float* B) {
  const int b = threadIdx.x & 31, a0 = 4 * (threadIdx.x >> 5);
#pragma unroll 8
  for (int c = 0; c < 32; ++c) {
    const float y = kTB ? B[b * kLd + c] : B[c * kLd + b];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = kTA ? A[c * kLd + a0 + i] : A[(a0 + i) * kLd + c];
      acc[i] = fmaf(x, y, acc[i]);
    }
  }
}

// Q <- Q - Q (Q^T Q - I) / 2 on Q [32 x kLd], with X as scratch.
__device__ __forceinline__ void reorthogonalise(float* Q, float* X) {
  const int b = threadIdx.x & 31, a0 = 4 * (threadIdx.x >> 5);
  float e[4] = {0.f, 0.f, 0.f, 0.f};
  product32<true, false>(e, Q, Q);
#pragma unroll
  for (int i = 0; i < 4; ++i) X[(a0 + i) * kLd + b] = e[i] - (a0 + i == b ? 1.f : 0.f);
  __syncthreads();
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  product32<false, false>(t, Q, X);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* q = Q + (a0 + i) * kLd + b;
    *q = __fsub_rn(*q, __fmul_rn(0.5f, t[i]));
  }
  __syncthreads();
}

// Rows (16-blocks r0, r1) x columns (c0, c1) of a matrix with leading
// dimension ld -> a 32 x kLd tile.
__device__ __forceinline__ void load_tile(const float* src, int ld, int r0, int r1, int c0, int c1, float* T) {
  const int a = threadIdx.x >> 3, b = 4 * (threadIdx.x & 7);
  const float4 v = __ldcg(reinterpret_cast<const float4*>(
      src + static_cast<size_t>(pair_index(r0, r1, a)) * ld + pair_index(c0, c1, b)));
  T[a * kLd + b] = v.x;
  T[a * kLd + b + 1] = v.y;
  T[a * kLd + b + 2] = v.z;
  T[a * kLd + b + 3] = v.w;
}

// A 32 x kLd tile -> a dense 32 x 32 matrix in the workspace.
__device__ __forceinline__ void store_dense(float* dst, const float* T) {
  for (int e = threadIdx.x; e < 1024; e += kThreads) __stcg(dst + e, T[(e >> 5) * kLd + (e & 31)]);
}

// Block-pair indices of pair k in round r.
__device__ __forceinline__ void round_pair(int r, int k, int nb, int* bi, int* bj) {
  *bi = seat(k, r, nb);
  *bj = seat(nb - 1 - k, r, nb);
}


// Warp-wide: tile (l, k), l <= k, of the round, Y = Q_l^T X Q_k with X =
// A[P_l, P_k], the Q's dense in shared memory and read as broadcasts. Lane b
// loads column b of X (all 32 loads in flight), forms column b of T = Q_l^T X
// in `scratch`, then takes row b of T and forms row b of Y = T Q_k. Off the
// diagonal (l < k) it writes Y to (l, k) and Y^T to (k, l); on it (l = k) it
// writes (Y + Y^T) / 2, so A stays exactly symmetric. Returns whether an
// off-diagonal entry is above tol sqrt|d_i| sqrt|d_j|, d the rotated S's
// diagonal (when `scan`).
__device__ __forceinline__ bool move_tile(float* A, int np, int bli, int blj, int bki, int bkj,
                                          const float* Ql, const float* Qk, const float* rl,
                                          const float* rk, float* scratch, bool diag, bool scan,
                                          float tol) {
  const int lane = threadIdx.x & 31;
  const int col = pair_index(bki, bkj, lane);
  float x[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) x[c] = __ldcg(A + static_cast<size_t>(pair_index(bli, blj, c)) * np + col);
  float t[32];
#pragma unroll
  for (int a = 0; a < 32; ++a) t[a] = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float4* q4 = reinterpret_cast<const float4*>(Ql + 32 * c);
#pragma unroll
    for (int a4 = 0; a4 < 8; ++a4) {
      const float4 q = q4[a4];
      t[4 * a4] = fmaf(q.x, x[c], t[4 * a4]);
      t[4 * a4 + 1] = fmaf(q.y, x[c], t[4 * a4 + 1]);
      t[4 * a4 + 2] = fmaf(q.z, x[c], t[4 * a4 + 2]);
      t[4 * a4 + 3] = fmaf(q.w, x[c], t[4 * a4 + 3]);
    }
  }
#pragma unroll
  for (int a = 0; a < 32; ++a) scratch[a * kLd + lane] = t[a];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 32; ++c) x[c] = scratch[lane * kLd + c];  // row `lane` of T
  __syncwarp();
  float y[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) y[b] = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float4* q4 = reinterpret_cast<const float4*>(Qk + 32 * c);
#pragma unroll
    for (int b4 = 0; b4 < 8; ++b4) {
      const float4 q = q4[b4];
      y[4 * b4] = fmaf(x[c], q.x, y[4 * b4]);
      y[4 * b4 + 1] = fmaf(x[c], q.y, y[4 * b4 + 1]);
      y[4 * b4 + 2] = fmaf(x[c], q.z, y[4 * b4 + 2]);
      y[4 * b4 + 3] = fmaf(x[c], q.w, y[4 * b4 + 3]);
    }
  }
  if (diag) {  // (Y + Y^T) / 2: lane a takes column a of Y from the others' rows
#pragma unroll
    for (int b = 0; b < 32; ++b) scratch[lane * kLd + b] = y[b];
    __syncwarp();
#pragma unroll
    for (int b = 0; b < 32; ++b) y[b] = 0.5f * (y[b] + scratch[b * kLd + lane]);
    __syncwarp();
  }
  const int row = pair_index(bli, blj, lane);
  float* dst = A + static_cast<size_t>(row) * np;
#pragma unroll
  for (int b4 = 0; b4 < 8; ++b4) {
    __stcg(reinterpret_cast<float4*>(dst + pair_index(bki, bkj, 4 * b4)),
           make_float4(y[4 * b4], y[4 * b4 + 1], y[4 * b4 + 2], y[4 * b4 + 3]));
  }
  if (!diag) {
#pragma unroll
    for (int b = 0; b < 32; ++b) __stcg(A + static_cast<size_t>(pair_index(bki, bkj, b)) * np + row, y[b]);
  }
  bool over = false;
  if (scan) {
    const float ra = rl[lane];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const float v = fabsf(y[b]);
      if (diag) {
        over |= b != lane && v > __fmul_rn(__fmul_rn(tol, ra), rk[b]);
      } else {
        over |= v > __fmul_rn(__fmul_rn(tol, ra), rk[b]) || v > __fmul_rn(__fmul_rn(tol, rk[b]), ra);
      }
    }
  }
  return over;
}

// Warp-wide: Vt[P_k, 32 ch .. 32 ch + 31] <- Q^T Vt[P_k, 32 ch ..]; lane b
// holds column 32 ch + b.
__device__ __forceinline__ void move_vectors(float* Vt, int np, int bi, int bj, int ch,
                                             const float* Q) {
  const int col = 32 * ch + (threadIdx.x & 31);
  float v[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) v[c] = __ldcg(Vt + static_cast<size_t>(pair_index(bi, bj, c)) * np + col);
  float w[32];
#pragma unroll
  for (int a = 0; a < 32; ++a) w[a] = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float4* q4 = reinterpret_cast<const float4*>(Q + 32 * c);
#pragma unroll
    for (int a4 = 0; a4 < 8; ++a4) {
      const float4 q = q4[a4];
      w[4 * a4] = fmaf(q.x, v[c], w[4 * a4]);
      w[4 * a4 + 1] = fmaf(q.y, v[c], w[4 * a4 + 1]);
      w[4 * a4 + 2] = fmaf(q.z, v[c], w[4 * a4 + 2]);
      w[4 * a4 + 3] = fmaf(q.w, v[c], w[4 * a4 + 3]);
    }
  }
#pragma unroll
  for (int a = 0; a < 32; ++a) __stcg(Vt + static_cast<size_t>(pair_index(bi, bj, a)) * np + col, w[a]);
}

// The first warp with the least work so far (an unrolled scan: the loads stay
// in registers).
__device__ __forceinline__ int least_loaded(const int (&load)[kWarps]) {
  int w = 0, best = load[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    w = load[i] < best ? i : w;
    best = load[i] < best ? load[i] : best;
  }
  return w;
}

__global__ void __launch_bounds__(kThreads)
eigh_jacobi(const float* __restrict__ in, float* __restrict__ s_out, float* __restrict__ u_out,
            float* __restrict__ work, int* __restrict__ capped, int n, int max_sweeps, float tol) {
  extern __shared__ float4 smem4[];
  const Layout L = layout(n);
  const Smem sm = carve(reinterpret_cast<float*>(smem4), L.pairs);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / L.pairs;  // the cluster's matrix; block `rank` owns pair `rank`
  const int tid = threadIdx.x, warp = tid >> 5;
  const int np = L.np, nb = L.nb, pairs = L.pairs;
  float* A = work + static_cast<size_t>(b) * L.per_matrix;
  float* Vt = A + L.vt;
  float* W = A + L.w;
  float* Qg = A + L.q;
  float* Sg = A + L.s;
  float* Dg = A + L.diag;
  unsigned* flags = reinterpret_cast<unsigned*>(A + L.flags);
  const float* a_in = in + static_cast<size_t>(b) * n * n;
  __shared__ Steps steps_smem;
  Steps* steps = &steps_smem;
  fill_steps(steps);

  // A from the lower triangle of the input, zero-padded; Vt = I.
  for (int r = rank; r < np; r += pairs) {
    for (int c = tid; c < np; c += kThreads) {
      float v = 0.f;
      if (r < n && c < n) v = r >= c ? a_in[static_cast<size_t>(r) * n + c] : a_in[static_cast<size_t>(c) * n + r];
      __stcg(A + static_cast<size_t>(r) * np + c, v);
      __stcg(Vt + static_cast<size_t>(r) * np + c, r == c ? 1.f : 0.f);
    }
  }
  if (rank == 0 && tid < kFlagWords) __stcg(flags + tid, 0u);
  cluster_barrier();

  bool converged = false;
  for (int sweep = 0; sweep < max_sweeps && !converged; ++sweep) {
    for (int r = 0; r < nb - 1; ++r) {
      const bool last = r == nb - 2;
      // 1. This block's pair: one inner sweep of its S.
      {
        const int k = rank;
        int bi, bj;
        round_pair(r, k, nb, &bi, &bj);
        load_tile(A, np, bi, bj, bi, bj, sm.s);
        for (int e = tid; e < 1024; e += kThreads) sm.q[(e >> 5) * kLd + (e & 31)] = (e >> 5) == (e & 31) ? 1.f : 0.f;
        __syncthreads();
        // 31 steps (odd) leave the result in sm.x, sm.y; 16 in sm.s, sm.q.
        if (r == 0) {
          inner_sweep<false>(sm.s, sm.x, sm.q, sm.y, tol, 31, steps);
        } else {
          inner_sweep<true>(sm.s, sm.x, sm.q, sm.y, tol, kBlock, steps);
        }
        float* q_out = r == 0 ? sm.y : sm.q;
        const float* s_out_blk = r == 0 ? sm.x : sm.s;
        reorthogonalise(q_out, sm.warp);
        store_dense(Qg + 1024 * k, q_out);
        if (tid < 32) __stcg(Sg + 32 * k + tid, s_out_blk[tid * (kLd + 1)]);
        __syncthreads();
      }
      cluster_barrier();

      // 2. Every Q of the round (and, on a sweep's last round, sqrt|diag S|),
      // then the tiles and this block's rows of Vt, one warp to each: the
      // tiles dealt round the cluster's blocks, each block's units (a tile:
      // two products; 32 columns of Vt: one) given in turn to its least
      // loaded warp.
      for (int e = tid; e < pairs * 256; e += kThreads) {
        reinterpret_cast<float4*>(sm.qall)[e] = __ldcg(reinterpret_cast<const float4*>(Qg) + e);
      }
      if (last) {
        for (int e = tid; e < pairs * 32; e += kThreads) sm.root[e] = __fsqrt_rn(fabsf(__ldcg(Sg + e)));
      }
      __syncthreads();
      bool over = false;
      int load[kWarps] = {};
      for (int t = rank; t < pairs * (pairs + 1) / 2; t += pairs) {
        const int w = least_loaded(load);
#pragma unroll
        for (int i = 0; i < kWarps; ++i) load[i] += i == w ? 2 : 0;
        if (w != warp) continue;
        int l = t, k = t, bli, blj, bki, bkj;
        if (t >= pairs) upper_pair(t - pairs, pairs, &l, &k);
        round_pair(r, l, nb, &bli, &blj);
        round_pair(r, k, nb, &bki, &bkj);
        over |= move_tile(A, np, bli, blj, bki, bkj, sm.qall + 1024 * l, sm.qall + 1024 * k,
                          sm.root + 32 * l, sm.root + 32 * k, sm.warp + warp * kTile, l == k,
                          last, tol);
      }
      {
        int bi, bj;
        round_pair(r, rank, nb, &bi, &bj);
        for (int ch = 0; ch < pairs; ++ch) {
          const int w = least_loaded(load);
#pragma unroll
          for (int i = 0; i < kWarps; ++i) load[i] += i == w ? 1 : 0;
          if (w == warp) move_vectors(Vt, np, bi, bj, ch, sm.qall + 1024 * rank);
        }
      }
      if (__syncthreads_or(over) && tid == 0) atomicOr(flags + sweep, 1u);
      cluster_barrier();
    }
    converged = __ldcg(flags + sweep) == 0u;
  }
  if (!converged && rank == 0 && tid == 0) atomicAdd(capped, 1);

  // Vt <- Vt - (Vt Vt^T - I) Vt / 2. W = Vt Vt^T - I, tile by tile; the
  // diagonal of A is kept in Dg; then the new Vt is written over A.
  const int b0 = tid & 31, a0 = 4 * warp;
  {
    const int it = rank;
    for (int jt = 0; jt < pairs; ++jt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ch = 0; ch < pairs; ++ch) {
        load_tile(Vt, np, 2 * it, 2 * it + 1, 2 * ch, 2 * ch + 1, sm.x);
        load_tile(Vt, np, 2 * jt, 2 * jt + 1, 2 * ch, 2 * ch + 1, sm.y);
        __syncthreads();
        product32<false, true>(acc, sm.x, sm.y);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 32 * it + a0 + i, col = 32 * jt + b0;
        __stcg(W + static_cast<size_t>(row) * np + col, acc[i] - (row == col ? 1.f : 0.f));
      }
    }
    if (tid < 32) __stcg(Dg + 32 * it + tid, __ldcg(A + static_cast<size_t>(32 * it + tid) * (np + 1)));
  }
  cluster_barrier();
  {
    const int it = rank;
    for (int ct = 0; ct < pairs; ++ct) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ch = 0; ch < pairs; ++ch) {
        load_tile(W, np, 2 * it, 2 * it + 1, 2 * ch, 2 * ch + 1, sm.x);
        load_tile(Vt, np, 2 * ch, 2 * ch + 1, 2 * ct, 2 * ct + 1, sm.y);
        __syncthreads();
        product32<false, false>(acc, sm.x, sm.y);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t o = static_cast<size_t>(32 * it + a0 + i) * np + 32 * ct + b0;
        __stcg(A + o, __fsub_rn(__ldcg(Vt + o), __fmul_rn(0.5f, acc[i])));
      }
    }
  }
  cluster_barrier();

  // Rank the diagonal (stable) and write this block's eigenpairs.
  for (int i = tid; i < n; i += kThreads) sm.diag[i] = __ldcg(Dg + i);
  __syncthreads();
  const int mine_count = (n - rank + pairs - 1) / pairs;
  for (int li = tid; li < mine_count; li += kThreads) {
    const int i = rank + pairs * li;
    const unsigned key = order_key(sm.diag[i]);
    int pos = 0;
    for (int j = 0; j < n; ++j) {
      const unsigned kj = order_key(sm.diag[j]);
      pos += kj < key || (kj == key && j < i);
    }
    sm.rank[li] = pos;
    s_out[static_cast<size_t>(b) * n + pos] = sm.diag[i];
  }
  __syncthreads();
  for (int e = tid; e < mine_count * n; e += kThreads) {
    const int li = e / n, r = e % n, i = rank + pairs * li;
    u_out[static_cast<size_t>(b) * n * n + static_cast<size_t>(r) * n + sm.rank[li]] =
        __ldcg(A + static_cast<size_t>(i) * np + r);
  }
}

}  // namespace

// Floats of device workspace for `batch` matrices of edge n (1..512); -1
// outside that.
extern "C" long long eigh_jacobi_workspace_floats(int batch, int n) {
  if (batch <= 0 || n <= 0 || n > 32 * kMaxPairs) return -1;
  return static_cast<long long>(batch) * static_cast<long long>(layout(n).per_matrix);
}

// Plain C entry point (loaded with ctypes). a [batch, n, n] f32 contiguous
// (its lower triangle is read) -> s [batch, n] ascending, u [batch, n, n];
// work holds eigh_jacobi_workspace_floats(batch, n) floats; capped is one int
// on the card. Launches on `stream` and does not synchronise. Returns the
// first CUDA error code, 0 on success.
extern "C" int eigh_jacobi_f32(const float* a, float* s, float* u, float* work, int* capped,
                               int batch, int n, int max_sweeps, float tol, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || n > 32 * kMaxPairs || max_sweeps <= 0 ||
      max_sweeps >= kFlagWords || work == nullptr || capped == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = layout(n);
  const size_t smem = smem_floats(L.pairs) * sizeof(float);
  // A function's attributes belong to the current device: set them on every call.
  cudaError_t err =
      cudaFuncSetAttribute(eigh_jacobi, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L.pairs > 8) {
    err = cudaFuncSetAttribute(eigh_jacobi, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * L.pairs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.pairs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, eigh_jacobi, a, s, u, work, capped, n, max_sweeps, tol);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
