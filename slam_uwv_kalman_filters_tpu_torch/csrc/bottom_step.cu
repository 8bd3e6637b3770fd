// K7 · the whole BottomUKF step in one launch: (optional) predict + a chain
// of DVL ray/plane range updates and S²-valued normal observations.
//
// Replaces the TPU kernel models/bottom_fused.py::_make_step_kernel
// (launched by _bottom_step_lanes). Per instance (3 DOF: distance ℝ¹ and the
// bottom normal on S²):
//   1. predict (DO_PREDICT): the 3x3 Crout factor of P, the 7 ukfom sigma
//      points (point 0 the mean, 2j+1 / 2j+2 the ±j-th factor column; the
//      normal of each is n ⊞ (δ1, δ2) in the basis at n), the distance
//      process model d − v_z·dt (src/BottomUKF.cpp:5-16), the distance mean
//      and deviations about the zero sigma point (d_0 + Σ(d_i − d_0)/7), the
//      normal's Karcher mean (MEAN_ITERS = 4 fixed iterations seeded from
//      point 0), the deviations ⊟ at it, and P = ½ΣDDᵀ + (v_x² + v_y²)·dt²·Q
//      (src/BottomUKF.cpp:48-54), Q's nine scalars passed by value;
//   2. each update redraws its 7 sigma points from the current P:
//      range (src/BottomUKF.cpp:18-30): h = ((0, 0, −d) − o)·n / (dir·n),
//      selected to 0 where dir·n == 0 (never divided first); its mean about
//      the zero point; normal (src/BottomUKF.cpp:32-37, 63-67): the Karcher
//      mean of the sigma normals, dZ and the innovation z ⊟ z_mean in the
//      basis at z_mean (the 2-vector the info returns); then S = ½ΣdZdZᵀ + R,
//      C = ½ΣδdZᵀ and small_ukf.cuh's Kalman tail (shared with K6). The gate
//      is a select: a threshold < 0 accepts any, a NaN S keeps the prior (the
//      TPU kernel multiplies by the mask, so a NaN there reaches the state);
//      an accepted correction moves d by corr_0 and n by ⊞ (corr_1, corr_2).
//
// Bound on Hopper: latency. Each instance reads 16 values and writes 13 (~120
// bytes in float32 at 3.35 TB/s) against ~3k dependent operations, most of
// them in the sphere maps (sin, cos and two sqrt in each ⊞, atan2, two sqrt
// and a divide in each ⊟ of 4 Karcher iterations over 7 points). One thread
// per instance takes 0.032 ms for one instance and 0.035 ms for 65 536
// (float32, NVIDIA H100 80GB HBM3, 700 W): one instance's chain, not the
// warps in flight, bounds it. Two designs, picked by the bank
// (bottom_grouped):
//   - small banks: a group of kBotGroup = 8 lanes an instance
//     (group_ukf.cuh) shortens the chain: lane p < 7 makes sigma point p
//     (its normal, range and ⊟ terms), the Karcher sums and the deviations
//     come from the owning lanes by shuffle, and the O(1) work (the 3x3
//     factor and deltas, the distance mean, every sum over the 7 points, the
//     tail at D = 3, M <= 2, the ⊞ of the normal) runs on every lane of the
//     group on identical values with small_ukf.cuh's and s2.cuh's code.
//     0.012 ms for one instance. Each block of 128 threads stages its loads
//     and stores in shared memory, so every bank-last row moves in runs of
//     the block's 16 instances;
//   - large banks: one thread an instance, everything in registers. The
//     group repeats the O(1) work on 8 lanes, and once the card is full the
//     repeats cost more issue slots than the shorter chain saves (0.071 ms
//     at 65 536); no narrower group beat one thread there (G = 1 of the
//     group code, with its staging and shuffles, 0.0415).
// Both give the same bits: every value is made by one lane with the
// one-thread expressions, every sum over the points ascending.
//
// Operands (bank-last): cov (3, 3, nb) (col, row), lower half read; mu (4,
// nb) [distance, normal xyz]; vel (3, nb); dt and Q (row-major, symmetric)
// by value; per update k: z_k (1 or 3, nb), R_k (m_k, m_k, nb), lower half
// read, for a range dir_k and origin_k (3, nb), the threshold by value.
// Outputs: cov_out (3, 3, nb) both halves, mu_out (4, nb); per update m2_k
// (nb), acc_k (nb) as 1/0, nu_k (m_k, nb). The chain is a by-value BotChain
// of at most kBotMaxSteps. No scratch.

#include "group_ukf.cuh"

namespace slam {

constexpr int kBotDof = 3;
constexpr int kBotSig = 2 * kBotDof + 1;  // 7
constexpr int kBotMeanIters = 4;
constexpr int kBotMaxSteps = 8;
constexpr int kBotGroup = 8;  // lanes an instance of the small banks' design
constexpr int kBotRows = 13;  // rows of a stage: the widest load or store

enum BotModel : int { kBotRange = 0, kBotNormal = 1 };

template <typename T>
struct BotChain {
  int n;
  int model[kBotMaxSteps];
  T thr[kBotMaxSteps];
  const T* z[kBotMaxSteps];
  const T* r[kBotMaxSteps];
  const T* dir[kBotMaxSteps];
  const T* org[kBotMaxSteps];
  T* m2[kBotMaxSteps];
  T* acc[kBotMaxSteps];
  T* nu[kBotMaxSteps];
};

template <typename T>
struct BotScal {
  T dt;
  T q[9];
};

// the tangent deltas dl[row][point] of the 7 sigma points of P
template <typename T>
__device__ __forceinline__ void bottom_deltas(const T (&P)[kBotDof][kBotDof], T (&dl)[kBotDof][kBotSig]) {
  T L[kBotDof][kBotDof];
  crout<T, kBotDof>(P, L);
#pragma unroll
  for (int i = 0; i < kBotDof; ++i) {
    dl[i][0] = T(0);
#pragma unroll
    for (int j = 0; j < kBotDof; ++j) {
      const T v = j <= i ? L[i][j] : T(0);
      dl[i][2 * j + 1] = v;
      dl[i][2 * j + 2] = -v;
    }
  }
}

// the 7 sigma points of (dist, n, P) on one thread: tangent deltas
// dl[row][point] and the normals pts[point]
template <typename T>
__device__ __forceinline__ void bottom_sigma(const T (&P)[kBotDof][kBotDof], const T (&n)[3],
                                             T (&dl)[kBotDof][kBotSig], T (&pts)[kBotSig][3]) {
  bottom_deltas(P, dl);
  const S2Basis<T> B = s2_basis(n);
#pragma unroll
  for (int p = 0; p < kBotSig; ++p) s2_boxplus(n, dl[1][p], dl[2][p], B, pts[p]);
}

// the lane's q-th sigma point, g + q·G (past the last point, point 0 again)
template <int G>
__device__ __forceinline__ int bottom_point(const Group<G>& grp, int q) {
  return q * G + grp.g < kBotSig ? q * G + grp.g : 0;
}

// the normals n ⊞ (δ1, δ2) (basis at n) of the lane's sigma points into pt[q]
template <typename T, int G, int Q>
__device__ __forceinline__ void bottom_points(const Group<G>& grp, const T (&dl)[kBotDof][kBotSig], const T (&n)[3],
                                              T (&pt)[Q][3]) {
  const S2Basis<T> B = s2_basis(n);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = bottom_point(grp, q);
    s2_boxplus(n, pick(dl[1], p), pick(dl[2], p), B, pt[q]);
  }
}

// mean of 7 values about the first, and their deviations from it in place
template <typename T>
__device__ __forceinline__ T mean_about_first(T (&v)[kBotSig]) {
  const T v0 = v[0];
  T acc = T(0);
#pragma unroll
  for (int p = 1; p < kBotSig; ++p) acc += v[p] - v0;
  const T dbar = acc * (T(1) / T(kBotSig));
#pragma unroll
  for (int p = 0; p < kBotSig; ++p) v[p] = (v[p] - v0) - dbar;
  return v0 + dbar;
}

// ---- large banks: one thread an instance ------------------------------------

// one update of model MODEL (M = 1 range, M = 2 normal) on one thread: z (1
// or 3, nb), R (M, M, nb), lower half read, for a range the beam's dir and
// origin (3, nb); writes the update's m2, acc and nu
template <typename T, int MODEL>
__device__ __forceinline__ void bottom_update_thread(T (&P)[kBotDof][kBotDof], T& dist, T (&n)[3], const T* z,
                                                     const T* r, const T* dir, const T* org, T thr, T* m2_out,
                                                     T* acc_out, T* nu_out, long long b, long long nb) {
  constexpr int M = MODEL == kBotRange ? 1 : 2;
  T dl[kBotDof][kBotSig], pts[kBotSig][3];
  bottom_sigma(P, n, dl, pts);
  T dz[M][kBotSig], nu[M];
  if constexpr (MODEL == kBotRange) {
    const T d0 = dir[b], d1 = dir[b + nb], d2 = dir[b + 2 * nb];
    const T o0 = org[b], o1 = org[b + nb], o2 = org[b + 2 * nb];
#pragma unroll
    for (int p = 0; p < kBotSig; ++p) {
      const T vdn = d0 * pts[p][0] + d1 * pts[p][1] + d2 * pts[p][2];
      const T num = (-o0) * pts[p][0] + (-o1) * pts[p][1] + (-(dist + dl[0][p]) - o2) * pts[p][2];
      dz[0][p] = vdn == T(0) ? T(0) : num / vdn;
    }
    const T z_mean = mean_about_first(dz[0]);
    nu[0] = z[b] - z_mean;
  } else {
    T zm[3];
    s2_karcher_mean<T, kBotSig, kBotMeanIters>(pts, zm);
    const S2Basis<T> B = s2_basis(zm);
#pragma unroll
    for (int p = 0; p < kBotSig; ++p) s2_boxminus(pts[p], zm, B, dz[0][p], dz[1][p]);
    const T zv[3] = {z[b], z[b + nb], z[b + 2 * nb]};
    s2_boxminus(zv, zm, B, nu[0], nu[1]);
  }
  T S[M][M], C[kBotDof][M], corr[kBotDof], m2;
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      T acc = T(0);
#pragma unroll
      for (int p = 0; p < kBotSig; ++p) acc += dz[a][p] * dz[c][p];
      S[a][c] = T(0.5) * acc + r[b + static_cast<long long>(a >= c ? a * M + c : c * M + a) * nb];
    }
#pragma unroll
    for (int i = 0; i < kBotDof; ++i) {
      T acc = T(0);
#pragma unroll
      for (int p = 0; p < kBotSig; ++p) acc += dl[i][p] * dz[a][p];
      C[i][a] = T(0.5) * acc;
    }
    nu_out[b + a * nb] = nu[a];
  }
  const bool accept = kalman_tail<T, kBotDof, M>(P, S, C, nu, thr, corr, m2);
  m2_out[b] = m2;
  acc_out[b] = accept ? T(1) : T(0);
  if (accept) {
    dist += corr[0];
    T moved[3];
    s2_boxplus(n, corr[1], corr[2], s2_basis(n), moved);
#pragma unroll
    for (int i = 0; i < 3; ++i) n[i] = moved[i];
  }
}

template <typename T, bool DO_PREDICT>
__global__ void __launch_bounds__(kThreads)
bottom_step_thread_kernel(const T* __restrict__ cov, const T* __restrict__ mu_in, const T* __restrict__ vel,
                          const BotScal<T> sc, const BotChain<T> chain, T* __restrict__ cov_out,
                          T* __restrict__ mu_out, long long nb) {
  constexpr int D = kBotDof, K = kBotSig;
  const long long b = instance_index();
  if (b >= nb) return;

  T P[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) P[i][j] = P[j][i] = cov[b + (static_cast<long long>(j) * D + i) * nb];
  }
  T dist = mu_in[b];
  T n[3] = {mu_in[b + nb], mu_in[b + 2 * nb], mu_in[b + 3 * nb]};

  if constexpr (DO_PREDICT) {
    T dl[D][K], pts[K][3];
    bottom_sigma(P, n, dl, pts);
    const T dt = sc.dt;
    const T vx = vel[b], vy = vel[b + nb], vz = vel[b + 2 * nb];
    T dd[K];
#pragma unroll
    for (int p = 0; p < K; ++p) dd[p] = (dist + dl[0][p]) - dt * vz;
    dist = mean_about_first(dd);
    T mean_n[3];
    s2_karcher_mean<T, K, kBotMeanIters>(pts, mean_n);
    const S2Basis<T> B = s2_basis(mean_n);
    T Dv[D][K];
#pragma unroll
    for (int p = 0; p < K; ++p) {
      Dv[0][p] = dd[p];
      s2_boxminus(pts[p], mean_n, B, Dv[1][p], Dv[2][p]);
    }
    const T qs = (vx * vx + vy * vy) * dt * dt;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T acc = T(0);
#pragma unroll
        for (int p = 0; p < K; ++p) acc += Dv[i][p] * Dv[j][p];
        P[i][j] = P[j][i] = T(0.5) * acc + qs * sc.q[3 * i + j];
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) n[i] = mean_n[i];
  }

  for (int k = 0; k < chain.n; ++k) {
    if (chain.model[k] == kBotRange)
      bottom_update_thread<T, kBotRange>(P, dist, n, chain.z[k], chain.r[k], chain.dir[k], chain.org[k],
                                         chain.thr[k], chain.m2[k], chain.acc[k], chain.nu[k], b, nb);
    else
      bottom_update_thread<T, kBotNormal>(P, dist, n, chain.z[k], chain.r[k], nullptr, nullptr, chain.thr[k],
                                          chain.m2[k], chain.acc[k], chain.nu[k], b, nb);
  }

  mu_out[b] = dist;
#pragma unroll
  for (int i = 0; i < 3; ++i) mu_out[b + (i + 1) * nb] = n[i];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) cov_out[b + (static_cast<long long>(j) * D + i) * nb] = P[i][j];
  }
}

// ---- small banks: a group of kBotGroup lanes an instance ---------------------

// one update of model MODEL (M = 1 range, M = 2 normal) on a group of G
// lanes; in holds the instance's staged z (1 or 3), R's lower half (1 or 3:
// (0, 0), (1, 0), (1, 1)) and, for a range, the beam's dir and origin, at
// in[r·I]; lane 0 writes m2, acc and nu to out[r·I]
template <typename T, int MODEL, int G, int I>
__device__ __forceinline__ void bottom_update(const Group<G>& grp, T (&P)[kBotDof][kBotDof], T& dist, T (&n)[3],
                                              const T* in, T thr, T* out) {
  constexpr int M = MODEL == kBotRange ? 1 : 2;
  constexpr int K = kBotSig, Q = (K + G - 1) / G;
  T dl[kBotDof][K], pt[Q][3];
  bottom_deltas(P, dl);
  bottom_points(grp, dl, n, pt);
  T dz[M][K], nu[M], S[M][M];
  if constexpr (MODEL == kBotRange) {
    const T z = in[0], r00 = in[I];
    const T d0 = in[2 * I], d1 = in[3 * I], d2 = in[4 * I];
    const T o0 = in[5 * I], o1 = in[6 * I], o2 = in[7 * I];
    T h[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int p = bottom_point(grp, q);
      const T vdn = d0 * pt[q][0] + d1 * pt[q][1] + d2 * pt[q][2];
      const T num = (-o0) * pt[q][0] + (-o1) * pt[q][1] + (-(dist + pick(dl[0], p)) - o2) * pt[q][2];
      h[q] = vdn == T(0) ? T(0) : num / vdn;
    }
    group_gather(grp, h, dz[0]);
    const T z_mean = mean_about_first(dz[0]);
    nu[0] = z - z_mean;
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < K; ++q) acc += dz[0][q] * dz[0][q];
    S[0][0] = T(0.5) * acc + r00;
  } else {
    T zm[3];
    group_s2_mean<T, K, kBotMeanIters>(grp, pt, zm);
    const S2Basis<T> B = s2_basis(zm);
    T e0[Q], e1[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) s2_boxminus(pt[q], zm, B, e0[q], e1[q]);
    group_gather(grp, e0, dz[0]);
    group_gather(grp, e1, dz[1]);
    const T zv[3] = {in[0], in[I], in[2 * I]};
    s2_boxminus(zv, zm, B, nu[0], nu[1]);
    const T r[3] = {in[3 * I], in[4 * I], in[5 * I]};  // (0, 0), (1, 0), (1, 1)
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int c = 0; c <= a; ++c) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < K; ++q) acc += dz[a][q] * dz[c][q];
        S[a][c] = S[c][a] = T(0.5) * acc + r[a + c];
      }
    }
  }
  T C[kBotDof][M], corr[kBotDof], m2;
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int i = 0; i < kBotDof; ++i) {
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < K; ++q) acc += dl[i][q] * dz[a][q];
      C[i][a] = T(0.5) * acc;
    }
  }
  const bool accept = kalman_tail<T, kBotDof, M>(P, S, C, nu, thr, corr, m2);
  if (grp.g == 0) {
    out[0] = m2;
    out[I] = accept ? T(1) : T(0);
#pragma unroll
    for (int a = 0; a < M; ++a) out[(2 + a) * I] = nu[a];
  }
  if (accept) {
    dist += corr[0];
    T moved[3];
    s2_boxplus(n, corr[1], corr[2], s2_basis(n), moved);
#pragma unroll
    for (int i = 0; i < 3; ++i) n[i] = moved[i];
  }
}

template <typename T, bool DO_PREDICT>
__global__ void __launch_bounds__(kGroupThreads)
bottom_step_group_kernel(const T* __restrict__ cov, const T* __restrict__ mu_in, const T* __restrict__ vel,
                         const BotScal<T> sc, const BotChain<T> chain, T* __restrict__ cov_out,
                         T* __restrict__ mu_out, long long nb) {
  constexpr int G = kBotGroup, D = kBotDof, K = kBotSig, I = kGroupThreads / G, Q = (K + G - 1) / G;
  __shared__ T in_stage[kBotRows * I], out_stage[kBotRows * I];
  const Group<G> grp;
  const long long b0 = static_cast<long long>(blockIdx.x) * I;
  const T* in = in_stage + grp.index;
  T* out = out_stage + grp.index;

  const auto rows = [](int r) { return r; };
  const auto at = [](T* stage) { return [stage](int r, int i) -> T& { return stage[r * I + i]; }; };
  // the lower half in the one-thread load order: (0, 0), (1, 0), (1, 1),
  // (2, 0), (2, 1), (2, 2) at (col, row) rows 0, 1, 4, 2, 5, 8; the mean; the
  // velocity
  const auto cov_rows = [](int r) { return r == 0 ? 0 : r == 1 ? 1 : r == 2 ? 4 : r == 3 ? 2 : r == 4 ? 5 : 8; };
  stage_in(cov, 6, cov_rows, b0, I, nb, at(in_stage));
  stage_in(mu_in, 4, rows, b0, I, nb, at(in_stage + 6 * I));
  if (DO_PREDICT) stage_in(vel, 3, rows, b0, I, nb, at(in_stage + 10 * I));
  __syncthreads();
  T P[D][D];
  {
    int r = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j, ++r) P[i][j] = P[j][i] = in[r * I];
    }
  }
  T dist = in[6 * I];
  T n[3] = {in[7 * I], in[8 * I], in[9 * I]};

  if constexpr (DO_PREDICT) {
    T dl[D][K], pt[Q][3];
    bottom_deltas(P, dl);
    bottom_points(grp, dl, n, pt);
    const T dt = sc.dt;
    const T vx = in[10 * I], vy = in[11 * I], vz = in[12 * I];
    T dd[K];
#pragma unroll
    for (int q = 0; q < K; ++q) dd[q] = (dist + dl[0][q]) - dt * vz;
    dist = mean_about_first(dd);
    T mean_n[3];
    group_s2_mean<T, K, kBotMeanIters>(grp, pt, mean_n);
    const S2Basis<T> B = s2_basis(mean_n);
    T e1[Q], e2[Q], Dv[D][K];
#pragma unroll
    for (int q = 0; q < Q; ++q) s2_boxminus(pt[q], mean_n, B, e1[q], e2[q]);
#pragma unroll
    for (int q = 0; q < K; ++q) Dv[0][q] = dd[q];
    group_gather(grp, e1, Dv[1]);
    group_gather(grp, e2, Dv[2]);
    const T qs = (vx * vx + vy * vy) * dt * dt;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < K; ++q) acc += Dv[i][q] * Dv[j][q];
        P[i][j] = P[j][i] = T(0.5) * acc + qs * sc.q[3 * i + j];
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) n[i] = mean_n[i];
  }
  __syncthreads();  // the stage is read before the first update reloads it

  for (int k = 0; k < chain.n; ++k) {
    const bool range = chain.model[k] == kBotRange;
    if (range) {
      stage_in(chain.z[k], 1, rows, b0, I, nb, at(in_stage));
      stage_in(chain.r[k], 1, rows, b0, I, nb, at(in_stage + I));
      stage_in(chain.dir[k], 3, rows, b0, I, nb, at(in_stage + 2 * I));
      stage_in(chain.org[k], 3, rows, b0, I, nb, at(in_stage + 5 * I));
    } else {
      stage_in(chain.z[k], 3, rows, b0, I, nb, at(in_stage));
      stage_in(chain.r[k], 3, [](int r) { return r == 0 ? 0 : r + 1; }, b0, I, nb, at(in_stage + 3 * I));  // R's lower half
    }
    __syncthreads();
    if (range)
      bottom_update<T, kBotRange, G, I>(grp, P, dist, n, in, chain.thr[k], out);
    else
      bottom_update<T, kBotNormal, G, I>(grp, P, dist, n, in, chain.thr[k], out);
    __syncthreads();
    stage_out(chain.m2[k], 1, rows, b0, I, nb, at(out_stage));
    stage_out(chain.acc[k], 1, rows, b0, I, nb, at(out_stage + I));
    stage_out(chain.nu[k], range ? 1 : 2, rows, b0, I, nb, at(out_stage + 2 * I));
  }

  __syncthreads();  // the last update's outputs are stored before the stage is rewritten
  if (grp.g == 0) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) out[(j * D + i) * I] = P[i][j];
    }
    out[9 * I] = dist;
#pragma unroll
    for (int i = 0; i < 3; ++i) out[(10 + i) * I] = n[i];
  }
  __syncthreads();
  stage_out(cov_out, 9, rows, b0, I, nb, at(out_stage));
  stage_out(mu_out, 4, rows, b0, I, nb, at(out_stage + 9 * I));
}

// The largest bank launched on the group design; past it, one thread an
// instance. tools/small_kernel_times.py (predict + one range, float32,
// NVIDIA H100 80GB HBM3 at 700 W) timed the group at 0.0253 ms against
// 0.0335 at 16 384 instances and 0.0391 against 0.0344 at 32 768; it builds
// this file with SLAM_BOTTOM_GROUP_BANKS at 0 and at its largest to time
// either design at any bank.
#ifndef SLAM_BOTTOM_GROUP_BANKS
#define SLAM_BOTTOM_GROUP_BANKS 16384
#endif
inline bool bottom_grouped(long long nb) { return nb <= SLAM_BOTTOM_GROUP_BANKS; }

template <typename T, bool DO_PREDICT>
int launch_bottom_step_as(const BotScal<T>& sc, const BotChain<T>& chain, const void* cov, const void* mu,
                          const void* vel, void* cov_out, void* mu_out, long long nb, cudaStream_t st) {
  const auto launch = [&](auto kernel, unsigned blocks, int threads) {
    kernel<<<blocks, threads, 0, st>>>(static_cast<const T*>(cov), static_cast<const T*>(mu),
                                       static_cast<const T*>(vel), sc, chain, static_cast<T*>(cov_out),
                                       static_cast<T*>(mu_out), nb);
  };
  if (bottom_grouped(nb)) {
    constexpr int I = kGroupThreads / kBotGroup;
    launch(bottom_step_group_kernel<T, DO_PREDICT>, static_cast<unsigned>((nb + I - 1) / I), kGroupThreads);
  } else {
    launch(bottom_step_thread_kernel<T, DO_PREDICT>, blocks_for(nb), kThreads);
  }
  return static_cast<int>(cudaGetLastError());
}

// the warps a block (and, in resident, an SM) of the predicting launch at
// bank nb
template <typename T>
int bottom_step_warps(long long nb, int* resident) {
  if (nb < 1) return -static_cast<int>(cudaErrorInvalidValue);
  return bottom_grouped(nb) ? group_warps(bottom_step_group_kernel<T, true>, kGroupThreads, 0, resident)
                            : group_warps(bottom_step_thread_kernel<T, true>, kThreads, 0, resident);
}

template <typename T>
int launch_bottom_step(int do_predict, const void* cov, const void* mu, const void* vel, double dt,
                       const double* q, int n_upd, const int* models, const void* const* z,
                       const void* const* r, const void* const* dir, const void* const* org,
                       const double* thr, void* const* m2, void* const* acc, void* const* nu,
                       void* cov_out, void* mu_out, long long nb, void* stream) {
  if (nb < 1 || n_upd < 0 || n_upd > kBotMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  if (do_predict && q == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  BotScal<T> sc{};
  sc.dt = static_cast<T>(dt);
  for (int i = 0; i < 9 && do_predict; ++i) sc.q[i] = static_cast<T>(q[i]);
  BotChain<T> chain{};
  chain.n = n_upd;
  for (int k = 0; k < n_upd; ++k) {
    if (models[k] != kBotRange && models[k] != kBotNormal) return static_cast<int>(cudaErrorInvalidValue);
    if (models[k] == kBotRange && (dir[k] == nullptr || org[k] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    chain.model[k] = models[k];
    chain.thr[k] = static_cast<T>(thr[k]);
    chain.z[k] = static_cast<const T*>(z[k]);
    chain.r[k] = static_cast<const T*>(r[k]);
    chain.dir[k] = static_cast<const T*>(dir[k]);
    chain.org[k] = static_cast<const T*>(org[k]);
    chain.m2[k] = static_cast<T*>(m2[k]);
    chain.acc[k] = static_cast<T*>(acc[k]);
    chain.nu[k] = static_cast<T*>(nu[k]);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return do_predict ? launch_bottom_step_as<T, true>(sc, chain, cov, mu, vel, cov_out, mu_out, nb, st)
                    : launch_bottom_step_as<T, false>(sc, chain, cov, mu, vel, cov_out, mu_out, nb, st);
}

}  // namespace slam

#define SLAM_BOTTOM_STEP_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(int do_predict, const void* cov, const void* mu, const void* vel, double dt, \
                      const double* q, int n_upd, const int* models, const void* const* z,         \
                      const void* const* r, const void* const* dir, const void* const* org,        \
                      const double* thr, void* const* m2, void* const* acc, void* const* nu,       \
                      void* cov_out, void* mu_out, long long nb, void* stream) {                   \
    return slam::launch_bottom_step<T>(do_predict, cov, mu, vel, dt, q, n_upd, models, z, r, dir,  \
                                       org, thr, m2, acc, nu, cov_out, mu_out, nb, stream);        \
  }                                                                                                \
  extern "C" int NAME##_warps(long long nb) { return slam::bottom_step_warps<T>(nb, nullptr); }     \
  extern "C" int NAME##_resident(long long nb) {                                                   \
    int resident = 0;                                                                              \
    const int warps = slam::bottom_step_warps<T>(nb, &resident);                                   \
    return warps < 0 ? warps : resident;                                                           \
  }

SLAM_BOTTOM_STEP_ENTRY(slam_bottom_step_f32, float)
SLAM_BOTTOM_STEP_ENTRY(slam_bottom_step_f64, double)
