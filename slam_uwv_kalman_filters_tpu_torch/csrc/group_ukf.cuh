// The group-of-lanes core of the small-filter kernels K6 (VelocityUKF step)
// and K7 (BottomUKF step), on small banks, K9 (IndirectPoseUKF predict) and
// K10 (IndirectPoseUKF marker update).
//
// Shares out over G lanes per instance what a one-thread design does on one
// thread: the Crout factor and the Kalman tail of
// small_ukf.cuh (the TPU helpers models/velocity_fused.py::_draw_deltas and
// ::_kalman_tail), the S² Karcher mean of s2.cuh (models/bottom_fused.py::
// _s2_karcher_mean) and the SO(3) one of so3.cuh (models/indirect_fused.py::
// _so3_karcher_mean). A 3- to 12-DOF filter has too little work to keep a
// warp's 32 lanes busy, so a warp holds 32/G instances, G a power of two (at
// most 32): the lanes of a group share out an instance's sigma points, its
// factor's rows, its sums and its gain rows. A wide group shortens one
// instance's dependent path; a narrow one repeats the O(1) work (pivots, the
// mean's ⊞, the 2x2 tail) on fewer lanes. The kernels pick their design from
// the bank.
//
// The results are those of the one-thread designs, bit for bit, at every G:
// every value is made by one lane with the one-thread body's expressions
// (small_ukf.cuh's and s2.cuh's helpers are called, not copied), every sum
// over the sigma points or over k runs in ascending order on one lane, and a
// value that every lane needs and that is cheap is made by every lane on
// identical values rather than broadcast. Where the one-thread build fused a
// product into the sum that reads it, and the group moves that product to
// another lane, the factors move and the sum's lane writes the FMA out
// (group_so3_mean).
//
// Shared memory: the kernels stage each block's bank-last loads and stores
// (stage_in / stage_out: consecutive threads take consecutive instances, so
// each row moves in runs of one block's instances), and K10 keeps each
// instance's factor, covariance, bearings and sums in a tile of its own;
// __syncwarp(mask) orders a group's lanes, __syncthreads the block's stages.
#pragma once

#include "s2.cuh"
#include "small_ukf.cuh"
#include "so3.cuh"

namespace slam {

constexpr int kGroupThreads = 128;  // threads per block of the group kernels

// A group of G lanes of one warp: the lane's place g in it, the group's place
// in the block, and the mask of its lanes.
template <int G>
struct Group {
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "a group is a power of two of 2 to 32 lanes");
  int g, index;
  unsigned mask;
  __device__ __forceinline__ explicit Group(unsigned tid = threadIdx.x) {
    const int lane = tid % 32;
    g = lane & (G - 1);
    index = tid / G;
    mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  template <typename T>
  __device__ __forceinline__ T shfl(T v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
};

// threadIdx.x and blockIdx.x read afresh at each call (asm volatile, which
// the compiler neither hoists nor merges): a loop that makes its lane's
// place from them in each pass keeps nothing derived from it live across the
// pass's math-library calls, where ptxas would spill it
__device__ __forceinline__ unsigned fresh_tid() {
#ifdef __CUDA_ARCH__
  unsigned v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
#else
  return threadIdx.x;
#endif
}
__device__ __forceinline__ unsigned fresh_ctaid() {
#ifdef __CUDA_ARCH__
  unsigned v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
#else
  return blockIdx.x;
#endif
}

// ---- the block's staged loads and stores ------------------------------------

// Row r of the block's I instances of a bank-last array (row(r) of instance
// b at src[row(r)·nb + b]) into dst(r, i); an instance past the bank reads
// the last one (the spare groups of a ragged block compute on a copy and
// store nothing). Consecutive threads take consecutive instances.
template <typename T, typename Row, typename Dst>
__device__ __forceinline__ void stage_in(const T* __restrict__ src, int rows, Row row, long long b0, int I,
                                         long long nb, Dst dst) {
  for (int e = threadIdx.x; e < rows * I; e += blockDim.x) {
    const int r = e / I, i = e - r * I;
    const long long b = b0 + i < nb ? b0 + i : nb - 1;
    dst(r, i) = src[static_cast<long long>(row(r)) * nb + b];
  }
}

// src(r, i) into row row(r) of instance b0 + i, for the instances in the bank
template <typename T, typename Row, typename Src>
__device__ __forceinline__ void stage_out(T* __restrict__ dst, int rows, Row row, long long b0, int I,
                                          long long nb, Src src) {
  for (int e = threadIdx.x; e < rows * I; e += blockDim.x) {
    const int r = e / I, i = e - r * I;
    if (b0 + i < nb) dst[static_cast<long long>(row(r)) * nb + b0 + i] = src(r, i);
  }
}

// The warps a block of `kernel` has at `threads` threads and `bytes` of
// dynamic shared memory, or a negated cudaError_t; `resident` receives the
// warps an SM keeps (the occupancy calculator's answer).
template <typename Kernel>
inline int group_warps(Kernel kernel, int threads, size_t bytes, int* resident) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (resident != nullptr) *resident = blocks * threads / 32;
  return (threads + 31) / 32;
}

// ---- packed lower-triangular tiles -------------------------------------------

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// the (row, col) of packed entry e, col <= row: a walk down the rows (row i
// holds i + 1 entries), integers only
__device__ __forceinline__ void tri_entry(int e, int& i, int& j) {
  i = 0;
  j = e;
  while (j > i) j -= ++i;
}

// ---- the group Crout factor --------------------------------------------------

// L = the Crout factor of the N x N packed lower tile A, into the packed tile
// L: column by column, every lane makes the pivot L[j][j] = sqrt(A[j][j] −
// Σ_{k<j} L[j][k]²) and its reciprocal, lane i mod G the entries L[i][j] =
// (A[i][j] − Σ_{k<j} L[i][k]·L[j][k])·(1/L[j][j]) of its rows i > j, k rising
// (small_ukf.cuh::crout's operations and order), then the group syncs.
template <typename T, int N, int G>
__device__ __forceinline__ void group_crout(const Group<G>& grp, const T* A, T* L) {
#pragma unroll 1
  for (int j = 0; j < N; ++j) {
    T s = A[tri(j, j)];
    for (int k = 0; k < j; ++k) s -= L[tri(j, k)] * L[tri(j, k)];
    const T ljj = d_sqrt(s);
    const T inv = T(1) / ljj;
    if (grp.g == 0) L[tri(j, j)] = ljj;
    for (int i = j + 1 + ((grp.g - j - 1) & (G - 1)); i < N; i += G) {
      T t = A[tri(i, j)];
      for (int k = 0; k < j; ++k) t -= L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = t * inv;
    }
    grp.sync();
  }
}

// v[p] with p a lane's runtime index, by selects (no local array)
template <typename T, int K>
__device__ __forceinline__ T pick(const T (&v)[K], int p) {
  T out = v[0];
#pragma unroll
  for (int q = 1; q < K; ++q) out = p == q ? v[q] : out;
  return out;
}

// ---- the group S² Karcher mean -----------------------------------------------

// all[p] = the value that lane p mod G holds as mine[p / G], p < K (lane g
// holds the points g, g + G, g + 2G, ...)
template <typename T, int K, int Q, int G>
__device__ __forceinline__ void group_gather(const Group<G>& grp, const T (&mine)[Q], T (&all)[K]) {
  static_assert(Q * G >= K, "every point has a lane");
#pragma unroll
  for (int p = 0; p < K; ++p) all[p] = grp.shfl(mine[p / G], p % G);
}

// The equal-weight mean of K points, seeded from point 0, a fixed ITERS
// iterations of m ← m ⊞ mean_p(y_p ⊟ m) (s2.cuh::s2_karcher_mean): lane g
// holds points g, g + G, ... in y[0], y[1], ... (past K, any point), makes
// their ⊟ terms, and every lane gathers the terms by shuffle, sums them, p
// rising, and makes the ⊞ on identical values.
template <typename T, int K, int ITERS, int G, int Q>
__device__ __forceinline__ void group_s2_mean(const Group<G>& grp, const T (&y)[Q][3], T (&m)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) m[a] = grp.shfl(y[0][a], 0);
  const T inv_k = T(1) / T(K);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const S2Basis<T> B = s2_basis(m);
    T d0[Q], d1[Q], a0[K], a1[K];
#pragma unroll
    for (int q = 0; q < Q; ++q) s2_boxminus(y[q], m, B, d0[q], d1[q]);
    group_gather(grp, d0, a0);
    group_gather(grp, d1, a1);
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int p = 0; p < K; ++p) {
      s0 += a0[p];
      s1 += a1[p];
    }
    T next[3];
    s2_boxplus(m, s0 * inv_k, s1 * inv_k, B, next);
#pragma unroll
    for (int a = 0; a < 3; ++a) m[a] = next[a];
  }
}

// The same mean of K points held in the group's tile (pts[3p + a]), any K:
// lane p mod G makes the ⊟ terms of its points into terms[2p], terms[2p + 1],
// the group syncs, and lanes 0 and 1 sum them, p rising.
template <typename T, int K, int ITERS, int G>
__device__ __forceinline__ void group_s2_mean_tile(const Group<G>& grp, const T* pts, T* terms, T (&m)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) m[a] = pts[a];
  const T inv_k = T(1) / T(K);
#pragma unroll 1
  for (int it = 0; it < ITERS; ++it) {
    const S2Basis<T> B = s2_basis(m);
    for (int p = grp.g; p < K; p += G) {
      const T y[3] = {pts[3 * p], pts[3 * p + 1], pts[3 * p + 2]};
      s2_boxminus(y, m, B, terms[2 * p], terms[2 * p + 1]);
    }
    grp.sync();
    // lane 0 sums the first components, lane 1 the second (each lane its
    // parity's), and every lane takes both from them
    T sum = T(0);
    for (int p = 0; p < K; ++p) sum += terms[2 * p + (grp.g & 1)];
    const T s0 = grp.shfl(sum, 0), s1 = grp.shfl(sum, 1);
    T next[3];
    s2_boxplus(m, s0 * inv_k, s1 * inv_k, B, next);
#pragma unroll
    for (int a = 0; a < 3; ++a) m[a] = next[a];
    grp.sync();  // every lane has read the terms before the next iteration rewrites them
  }
}

// ---- the group SO(3) Karcher mean -------------------------------------------

// qconj(y)·y as the one-thread build rounds it where it knows both factors
// are one quaternion (its SASS: each product that appears twice made once)
template <typename T>
__device__ __forceinline__ Quat<T> qmul_conj_self(const Quat<T>& y) {
  const T wx = mul_rn(y.w, y.x), wy = mul_rn(y.w, y.y), wz = mul_rn(y.w, y.z);
  return {fma_rn(y.z, y.z, fma_rn(y.y, y.y, fma_rn(y.w, y.w, mul_rn(y.x, y.x)))),
          fma_rn(y.y, y.z, fma_rn(-y.y, y.z, add_rn(wx, -wx))),
          fma_rn(-y.x, y.z, add_rn(fma_rn(y.x, y.z, wy), -wy)),
          add_rn(fma_rn(y.x, y.y, fma_rn(-y.x, y.y, wz)), -wz)};
}

// The equal-weight mean of K unit quaternions, seeded from point 0, a fixed
// ITERS iterations of m ← m ⊞ mean_p(y_p ⊟ m) (so3.cuh::so3_karcher_mean):
// lane g holds points g, g + G, ... in y[0], y[1], ... (past K, any point).
// Each lane makes the log maps of its points as qlog_parts' scale and
// vector (point 0's first one, y_0 ⊟ y_0, as qmul_conj_self), every lane
// gathers them by shuffle and sums the terms p rising as fma(scale_p, v_p,
// sum), the one-thread build's contraction of sum += scale·v, then makes
// the ⊞ on identical values.
template <typename T, int K, int ITERS, int G, int Q>
__device__ __forceinline__ Quat<T> group_so3_mean(const Group<G>& grp, const Quat<T> (&y)[Q]) {
  Quat<T> m{grp.shfl(y[0].w, 0), grp.shfl(y[0].x, 0), grp.shfl(y[0].y, 0), grp.shfl(y[0].z, 0)};
  const T inv_k = T(1) / T(K);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    T sc[Q], vx[Q], vy[Q], vz[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      Quat<T> r = qmul(qconj(m), y[q]);
      if (it == 0 && q == 0) r = grp.g == 0 ? qmul_conj_self(y[0]) : r;
      qlog_parts(r, sc[q], vx[q], vy[q], vz[q]);
    }
    T a[K], ax[K], ay[K], az[K];
    group_gather(grp, sc, a);
    group_gather(grp, vx, ax);
    group_gather(grp, vy, ay);
    group_gather(grp, vz, az);
    T sx = T(0), sy = T(0), sz = T(0);
#pragma unroll
    for (int p = 0; p < K; ++p) {
      sx = fma_rn(a[p], ax[p], sx);
      sy = fma_rn(a[p], ay[p], sy);
      sz = fma_rn(a[p], az[p], sz);
    }
    m = so3_boxplus(m, sx * inv_k, sy * inv_k, sz * inv_k, T(1));
  }
  return m;
}

// ---- the group Kalman tail of a 2-dimensional measurement ---------------------

// small_ukf.cuh::kalman_tail<T, D, 2> shared out over a group, on the tile: P
// the packed lower D x D covariance, cw the cross-covariance's raw sums
// Σ_p δ_p[i]·dZ_p[a] at cw[2i + a] (C = ½ of them, made where they are read,
// as the one-thread body scaled them), corr (D) for the correction. S (lower
// half), ν and the threshold are on every lane. Every lane makes S's factor
// L_S, the NIS m2 and the gate; lane i mod G the gain row K_i = S⁻¹C_i, the
// correction corr_i = K_i·ν and W_i = K_i·L_S, written over C_i; then, where
// the gate accepts (a threshold < 0 accepts any; a NaN S rejects), the
// entries (i, j <= i) of P − W·Wᵀ, spread over the lanes, each summed over a
// rising. Returns whether the gate accepts (on every lane).
template <typename T, int D, int G>
__device__ __forceinline__ bool group_kalman_tail2(const Group<G>& grp, T* P, T* cw, T* corr, const T (&S)[2][2],
                                                  const T (&nu)[2], T thr, T& m2) {
  constexpr int M = 2;
  T Ls[M][M], inv_d[M], q[M];
  crout<T, M>(S, Ls);
#pragma unroll
  for (int a = 0; a < M; ++a) inv_d[a] = T(1) / Ls[a][a];
  solve_chol<T, M>(Ls, inv_d, nu, q);
  m2 = T(0);
#pragma unroll
  for (int a = 0; a < M; ++a) m2 += nu[a] * q[a];
  const bool accept = (thr < T(0)) || (m2 <= thr);
  for (int i = grp.g; i < D; i += G) {
    const T c[M] = {T(0.5) * cw[2 * i], T(0.5) * cw[2 * i + 1]};
    T K[M];
    solve_chol<T, M>(Ls, inv_d, c, K);
    T t = T(0);
#pragma unroll
    for (int a = 0; a < M; ++a) t += K[a] * nu[a];
    corr[i] = t;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T w = T(0);
#pragma unroll
      for (int cc = a; cc < M; ++cc) w += K[cc] * Ls[cc][a];
      cw[2 * i + a] = w;
    }
  }
  grp.sync();
  if (accept) {
    int i, j;  // the (row, col) of entry e, stepped by G entries
    tri_entry(grp.g, i, j);
    for (int e = grp.g; e < tri(D, 0); e += G) {
      T t = T(0);
#pragma unroll
      for (int a = 0; a < M; ++a) t += cw[2 * i + a] * cw[2 * j + a];
      P[e] = P[e] - t;
      for (j += G; j > i;) j -= ++i;
    }
  }
  grp.sync();
  return accept;
}

}  // namespace slam
