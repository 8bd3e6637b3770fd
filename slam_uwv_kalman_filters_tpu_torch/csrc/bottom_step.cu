// K7 · the whole BottomUKF step in one launch: (optional) predict + a chain
// of DVL ray/plane range updates and S²-valued normal observations.
//
// Replaces the TPU kernel models/bottom_fused.py::_make_step_kernel
// (launched by _bottom_step_lanes). Per instance, one thread, everything in
// registers (3 DOF: distance ℝ¹ and the bottom normal on S²):
//   1. predict (DO_PREDICT): the 3x3 Crout factor of P, the 7 ukfom sigma
//      points (point 0 the mean, 2j+1 / 2j+2 the ±j-th factor column; the
//      normal of each is n ⊞ (δ1, δ2) in the basis at n), the distance
//      process model d − v_z·dt (src/BottomUKF.cpp:5-16), the distance mean
//      and deviations about the zero sigma point (d_0 + Σ(d_i − d_0)/7), the
//      normal's Karcher mean (s2.cuh, MEAN_ITERS = 4 fixed iterations seeded
//      from point 0), the deviations ⊟ at it, and P = ½ΣDDᵀ + (v_x² + v_y²)·
//      dt²·Q (src/BottomUKF.cpp:48-54), Q's nine scalars passed by value;
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
// bytes in float32 at 3.35 TB/s) against ~3k dependent operations in one
// thread (sin, cos, atan2, sqrt in each of 4 Karcher iterations over 7
// points); a launch at bank 65 536 is 512 blocks on 132 SMs. This first
// version keeps one thread per instance.
//
// Operands (bank-last): cov (3, 3, nb) (col, row), lower half read; mu (4,
// nb) [distance, normal xyz]; vel (3, nb); dt and Q (row-major, symmetric)
// by value; per update k: z_k (1 or 3, nb), R_k (m_k, m_k, nb), for a range
// dir_k and origin_k (3, nb), the threshold by value. Outputs: cov_out (3, 3,
// nb) both halves, mu_out (4, nb); per update m2_k (nb), acc_k (nb) as 1/0,
// nu_k (m_k, nb). The chain is a by-value BotChain of at most kBotMaxSteps.

#include "s2.cuh"
#include "small_ukf.cuh"

namespace slam {

constexpr int kBotDof = 3;
constexpr int kBotSig = 2 * kBotDof + 1;  // 7
constexpr int kBotMeanIters = 4;
constexpr int kBotMaxSteps = 8;

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

// the 7 sigma points of (dist, n, P): tangent deltas dl[row][point] and the
// normals pts[point]
template <typename T>
__device__ __forceinline__ void bottom_sigma(const T (&P)[kBotDof][kBotDof], const T (&n)[3],
                                             T (&dl)[kBotDof][kBotSig], T (&pts)[kBotSig][3]) {
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
  const S2Basis<T> B = s2_basis(n);
#pragma unroll
  for (int p = 0; p < kBotSig; ++p) s2_boxplus(n, dl[1][p], dl[2][p], B, pts[p]);
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

// one update of model MODEL (M = 1 range, M = 2 normal): z (1 or 3, nb), R
// (M, M, nb), for a range the beam's dir and origin (3, nb); writes the
// update's m2, acc and nu
template <typename T, int MODEL>
__device__ __forceinline__ void bottom_update(T (&P)[kBotDof][kBotDof], T& dist, T (&n)[3], const T* z,
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
      S[a][c] = T(0.5) * acc + r[b + (static_cast<long long>(a) * M + c) * nb];
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
bottom_step_kernel(const T* __restrict__ cov, const T* __restrict__ mu_in,
                   const T* __restrict__ vel, const BotScal<T> sc, const BotChain<T> chain,
                   T* __restrict__ cov_out, T* __restrict__ mu_out, long long nb) {
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
      bottom_update<T, kBotRange>(P, dist, n, chain.z[k], chain.r[k], chain.dir[k], chain.org[k], chain.thr[k],
                                  chain.m2[k], chain.acc[k], chain.nu[k], b, nb);
    else
      bottom_update<T, kBotNormal>(P, dist, n, chain.z[k], chain.r[k], nullptr, nullptr, chain.thr[k],
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

template <typename T>
int launch_bottom_step(int do_predict, const void* cov, const void* mu, const void* vel, double dt,
                       const double* q, int n_upd, const int* models, const void* const* z,
                       const void* const* r, const void* const* dir, const void* const* org,
                       const double* thr, void* const* m2, void* const* acc, void* const* nu,
                       void* cov_out, void* mu_out, long long nb, void* stream) {
  if (n_upd < 0 || n_upd > kBotMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
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
  if (do_predict)
    bottom_step_kernel<T, true><<<blocks_for(nb), kThreads, 0, st>>>(
        static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(vel), sc, chain,
        static_cast<T*>(cov_out), static_cast<T*>(mu_out), nb);
  else
    bottom_step_kernel<T, false><<<blocks_for(nb), kThreads, 0, st>>>(
        static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(vel), sc, chain,
        static_cast<T*>(cov_out), static_cast<T*>(mu_out), nb);
  return static_cast<int>(cudaGetLastError());
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
  }

SLAM_BOTTOM_STEP_ENTRY(slam_bottom_step_f32, float)
SLAM_BOTTOM_STEP_ENTRY(slam_bottom_step_f64, double)
