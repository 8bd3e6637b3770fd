// K9 · the IndirectPoseUKF prediction in one launch.
//
// Replaces the TPU kernel models/indirect_fused.py::_predict_kernel
// (launched by _indirect_predict_lanes). Per instance (6 DOF: the position
// error ℝ³ and the orientation error SO(3)):
//   1. the 6x6 Crout factor L of P (small_ukf.cuh) and the 13 ukfom sigma
//      deltas: point 0 zero, 2j+1 / 2j+2 the ±j-th column of L (unscaled);
//   2. the process model (src/IndirectPoseUKF.cpp:6-20): the position error
//      a random walk; the orientation error q ⊞ δ, then decayed toward the
//      identity by ⊞ (−Log(q)/τ)·dt;
//   3. the SO(3) Karcher mean of the 13 orientations (so3.cuh, MEAN_ITERS = 4
//      fixed iterations seeded from point 0), their deviations ⊟ it, and the
//      position mean pos + Σδ/13;
//   4. P = ½ΣDDᵀ + Q with Q as src/IndirectPoseUKF.cpp:80-92 builds it per
//      instance: dt²·Q on the position and cross blocks, and on the
//      orientation block (2/(τ·dt))·dt²·R·Q₃₃·Rᵀ, R the rotation of the prior
//      orientation error; both halves written.
//
// Bound on Hopper: latency. Each instance reads 28 values and writes 43
// (~280 bytes in float32 at 3.35 TB/s) against ~6.5k dependent operations,
// ~80% of them per sigma point (13 exp/log pairs; 4 Karcher iterations of 13
// log maps with atan2). One thread an instance, the 13 sigma points unrolled
// in registers, takes 0.057 ms for one instance and 0.061 for 65 536
// (float32, NVIDIA H100 80GB HBM3, 700 W): one instance's chain bounds it,
// with 16 warps an SM resident. Two designs, picked by the bank
// (indirect_predict_grouped):
//   - small and mid banks: a group of G = 8 lanes an instance
//     (group_ukf.cuh), lane g the sigma points g and g + 8. Every lane makes
//     the 6x6 factor, the position mean, the position block of ½ΣDDᵀ + Q, R
//     and R·Q₃₃, and the first ⊞ of all 13 points, with the one-thread
//     body's rounding (below); lane 0 writes them to the instance's tile and
//     stage. Each lane then takes its points through Log and the decay ⊞,
//     makes their terms of each Karcher iteration (gathered by shuffle,
//     summed p rising by every lane, which makes the ⊞: group_so3_mean) and
//     their deviations, which go to the tile (13 x 6, then R and R·Q₃₃); the
//     15 other entries of ½ΣDDᵀ + Q are spread over the lanes, each summed p
//     rising by one lane. Loads and stores are staged (stage_in /
//     stage_out), so each bank-last row moves in runs of a block's
//     instances;
//   - large banks: one thread an instance. The group repeats the O(1) work
//     on its lanes, and past 16 384 instances the repeats cost more instruction
//     slots than the shorter chain saves.
// Both give the same bits (group_ukf.cuh says how; the helpers below write
// out the one-thread build's rounding of the products of L's entries).
//
// Operands (bank-last): cov (6, 6, nb) (col, row), lower half read; mu (7,
// nb) [position error xyz, quaternion wxyz]; scal (38) on the device: dt, τ,
// then Q (symmetric) row-major, read alike by every thread. Outputs: cov_out
// (6, 6, nb) both halves, mu_out (7, nb). No scratch.

#include "group_ukf.cuh"

namespace slam {

constexpr int kIndDof = 6;
constexpr int kIndSig = 2 * kIndDof + 1;  // 13
constexpr int kIndMeanIters = 4;

// ---- large banks: one thread an instance ------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
indirect_predict_thread_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ scal,
                        T* __restrict__ cov_out, T* __restrict__ mu_out, long long nb) {
  constexpr int D = kIndDof, K = kIndSig;
  const long long b = instance_index();
  if (b >= nb) return;
  const T dt = scal[0], tau = scal[1];
  const T* q = scal + 2;

  T P[D][D], L[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) P[i][j] = P[j][i] = cov[b + (static_cast<long long>(j) * D + i) * nb];
  }
  const Quat<T> qm{mu[b + 3 * nb], mu[b + 4 * nb], mu[b + 5 * nb], mu[b + 6 * nb]};
  crout<T, D>(P, L);
  T dl[D][K];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    dl[i][0] = T(0);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const T v = j <= i ? L[i][j] : T(0);
      dl[i][2 * j + 1] = v;
      dl[i][2 * j + 2] = -v;
    }
  }

  // the orientation of each sigma point through the τ-decay
  const T ntau = T(-1) / tau;
  Quat<T> y[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const Quat<T> qs = so3_boxplus(qm, dl[3][p], dl[4][p], dl[5][p], T(1));
    T lx, ly, lz;
    qlog(qs, lx, ly, lz);
    y[p] = so3_boxplus(qs, ntau * lx, ntau * ly, ntau * lz, dt);
  }
  const Quat<T> mq = so3_karcher_mean<T, K, kIndMeanIters>(y);
  T dq[3][K];
#pragma unroll
  for (int p = 0; p < K; ++p) so3_boxminus(y[p], mq, dq[0][p], dq[1][p], dq[2][p]);

  // Q: the orientation block rotated by R(prior error) and Markov-scaled
  T R[3][3], Rq[3][3], Qo[3][3];
  rot_matrix(qm, R);
  const T mscale = T(2) / (tau * dt) * dt * dt;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rq[i][j] = R[i][0] * q[6 * 3 + 3 + j] + R[i][1] * q[6 * 4 + 3 + j] + R[i][2] * q[6 * 5 + 3 + j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Qo[i][j] = mscale * (Rq[i][0] * R[j][0] + Rq[i][1] * R[j][1] + Rq[i][2] * R[j][2]);
  }
  const T dt2 = dt * dt;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T acc = T(0);
#pragma unroll
      for (int p = 0; p < K; ++p) {
        const T di = i < 3 ? dl[i][p] : dq[i - 3][p];
        const T dj = j < 3 ? dl[j][p] : dq[j - 3][p];
        acc += di * dj;
      }
      const T qij = j >= 3 ? Qo[i - 3][j - 3] : dt2 * q[6 * i + j];
      const T v = T(0.5) * acc + qij;
      cov_out[b + (static_cast<long long>(j) * D + i) * nb] = v;
      cov_out[b + (static_cast<long long>(i) * D + j) * nb] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T acc = T(0);
#pragma unroll
    for (int p = 0; p < K; ++p) acc += dl[i][p];
    mu_out[b + i * nb] = mu[b + i * nb] + acc * (T(1) / T(K));
  }
  mu_out[b + 3 * nb] = mq.w;
  mu_out[b + 4 * nb] = mq.x;
  mu_out[b + 5 * nb] = mq.y;
  mu_out[b + 6 * nb] = mq.z;
}

// ---- small and mid banks: a group of G lanes an instance ---------------------

// the stage: the covariance at its (col, row) rows (the lower half read
// there, both halves written there), then the mean (rows 36..42)
constexpr int kIndPredRows = kIndDof * kIndDof + 7;
// the instance's tile: the deviations D[row][p] at row·13 + p, then R and
// R·Q₃₃ row-major
constexpr int kIndPredR = kIndDof * kIndSig, kIndPredRq = kIndPredR + 9, kIndPredTile = kIndPredRq + 9;
// The one-thread build's rounding of the products of L's entries, written
// out: that build shares each such product between the factor, the first ⊞
// of the sigma points (|δ|² of column j) and the position block of ½ΣDDᵀ,
// and ptxas fuses a product into the sum that reads it only where it is not
// shared (its SASS: the pivots of rows 1 and 2 fused, of rows 3 to 5 not;
// the column products of |δ|² and of the position block not, the diagonal
// entries' own squares fused). A group's lanes share other values, so they
// make these sums with the helpers below.

// the Crout factor of the 6x6 P
template <typename T>
__device__ __forceinline__ void indirect_crout(const T (&A)[kIndDof][kIndDof], T (&L)[kIndDof][kIndDof]) {
#pragma unroll
  for (int j = 0; j < kIndDof; ++j) {
    T s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = j < 3 ? fma_rn(-L[j][k], L[j][k], s) : add_rn(s, -mul_rn(L[j][k], L[j][k]));
    L[j][j] = d_sqrt(s);
    const T inv = T(1) / L[j][j];
#pragma unroll
    for (int i = j + 1; i < kIndDof; ++i) {
      T t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = fma_rn(-L[i][k], L[j][k], t);
      L[i][j] = mul_rn(t, inv);
    }
  }
}

// q ⊞ δ_p of sigma point p (compile-time), δ_p the ±column (p − 1)/2 of L's
// orientation rows, with |δ_p|² rounded as the one-thread build rounds it
template <typename T>
__device__ __forceinline__ Quat<T> indirect_sigma_boxplus(const Quat<T>& q, const T (&L)[kIndDof][kIndDof], int p) {
  if (p == 0) return so3_boxplus(q, T(0), T(0), T(0), T(1));
  const int j = (p - 1) / 2;
  const T vx = j <= 3 ? L[3][j] : T(0), vy = j <= 4 ? L[4][j] : T(0), vz = L[5][j];
  T theta2;
  if (j < 3)
    theta2 = add_rn(add_rn(mul_rn(vx, vx), mul_rn(vy, vy)), mul_rn(vz, vz));
  else if (j == 3)
    theta2 = add_rn(fma_rn(vx, vx, mul_rn(vy, vy)), mul_rn(vz, vz));
  else if (j == 4)
    theta2 = add_rn(fma_rn(vy, vy, T(0)), mul_rn(vz, vz));
  else
    theta2 = fma_rn(vz, vz, T(0));
  const T s = (p & 1) ? T(1) : T(-1);
  return so3_times(q, qexp_sq(theta2, s * vx, s * vy, s * vz));
}

// entry (i, j <= i < 3) of ΣDDᵀ, the sum over the sigma points of the
// products of L's entries (column k = j fused, the shared k < j not)
template <typename T>
__device__ __forceinline__ T indirect_position_sum(const T (&L)[kIndDof][kIndDof], int i, int j) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k <= j; ++k) {
#pragma unroll
    for (int sign = 0; sign < 2; ++sign) acc = k < j ? add_rn(acc, mul_rn(L[i][k], L[j][k])) : fma_rn(L[i][j], L[j][j], acc);
  }
  return acc;
}

// instances a block: at most 32, so that a block's stage and tiles stay
// under 48 KB in float64 (a group of G lanes: blocks of 32·G threads below 4)
__host__ __device__ constexpr int ind_pred_instances(int G) { return G < 4 ? 32 : kGroupThreads / G; }

template <typename T, int G>
__global__ void __launch_bounds__(kGroupThreads)
indirect_predict_group_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ scal,
                              T* __restrict__ cov_out, T* __restrict__ mu_out, long long nb) {
  constexpr int D = kIndDof, K = kIndSig, I = ind_pred_instances(G), Q = (K + G - 1) / G;
  __shared__ T stage[kIndPredRows * I], tile[kIndPredTile * I];
  const Group<G> grp;
  const long long b0 = static_cast<long long>(blockIdx.x) * I;
  T* const st = stage + grp.index;  // entry r of the instance at st[r·I]
  T* const tl = tile + grp.index;   // likewise

  const auto lower = [](int e) { int i, j; tri_entry(e, i, j); return j * D + i; };
  const auto at = [](T* base) { return [base](int r, int i) -> T& { return base[r * I + i]; }; };
  stage_in(cov, tri(D, 0), lower, b0, I, nb, [&](int e, int i) -> T& { return stage[lower(e) * I + i]; });
  stage_in(mu, 7, [](int r) { return r; }, b0, I, nb, at(stage + D * D * I));
  __syncthreads();

  T P[D][D], L[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) P[i][j] = P[j][i] = st[(j * D + i) * I];
  }
  const Quat<T> qm{st[39 * I], st[40 * I], st[41 * I], st[42 * I]};
  indirect_crout(P, L);
  const T* q = scal + 2;

  // every lane: the position mean, the position block of ½ΣDDᵀ + Q (on L's
  // entries), R and R·Q₃₃; lane 0 writes them, and the deltas' position
  // rows, once every lane has read the prior, before the math library's
  // calls below (what they leave live there, ptxas spills)
  {
    const T dt = scal[0];
    const T dt2 = dt * dt;
    T pmean[3], pblock[tri(3, 0)], R[3][3], Rq[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        acc += L[i][j];
        acc += -L[i][j];
      }
      pmean[i] = fma_rn(acc, T(1) / T(K), st[(36 + i) * I]);  // the one-thread build's fusion
#pragma unroll
      for (int j = 0; j <= i; ++j)
        pblock[tri(i, j)] = fma_rn(T(0.5), indirect_position_sum(L, i, j), dt2 * q[6 * i + j]);
    }
    rot_matrix(qm, R);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Rq[i][j] = R[i][0] * q[6 * 3 + 3 + j] + R[i][1] * q[6 * 4 + 3 + j] + R[i][2] * q[6 * 5 + 3 + j];
    }
    grp.sync();
    if (grp.g == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        tl[(kIndPredR + i) * I] = R[i / 3][i % 3];
        tl[(kIndPredRq + i) * I] = Rq[i / 3][i % 3];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        st[(36 + i) * I] = pmean[i];
#pragma unroll
        for (int j = 0; j <= i; ++j) st[(j * D + i) * I] = st[(i * D + j) * I] = pblock[tri(i, j)];
#pragma unroll
        for (int p = 0; p < K; ++p) {
          const int c = (p - 1) / 2;
          const T v = p > 0 && c <= i ? L[i][c] : T(0);
          tl[(i * K + p) * I] = p == 0 || (p & 1) ? v : -v;
        }
      }
    }
  }

  // the first ⊞ of all 13 points on every lane (the one-thread body makes
  // the ± pairs' exponentials once); each lane then takes its own through
  // the τ-decay (past the 13th, point 0 again)
  Quat<T> y[Q];
  {
    Quat<T> qs[K];
#pragma unroll
    for (int p = 0; p < K; ++p) qs[p] = indirect_sigma_boxplus(qm, L, p);
    const T dt = scal[0], ntau = T(-1) / scal[1];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const Quat<T> qp = pick(qs, k * G + grp.g < K ? k * G + grp.g : 0);
      T lx, ly, lz;
      qlog(qp, lx, ly, lz);
      y[k] = so3_boxplus(qp, ntau * lx, ntau * ly, ntau * lz, dt);
    }
  }
  const Quat<T> mq = group_so3_mean<T, K, kIndMeanIters>(Group<G>(fresh_tid()), y);

  // the lane's place made afresh (fresh_tid), so that nothing derived from
  // it stays live across the math library's calls above; the deviations,
  // then the other entries (i >= 3, j <= i) of ½ΣDDᵀ + Q, spread over the
  // lanes, each summed p rising; Q's orientation block
  // (2/(τ·dt))·dt²·(R·Q₃₃)·Rᵀ
  const Group<G> lane(fresh_tid());
  T* const sl = stage + lane.index;
  T* const tk = tile + lane.index;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int p = k * G + lane.g;
    if (p < K) so3_boxminus(y[k], mq, tk[(3 * K + p) * I], tk[(4 * K + p) * I], tk[(5 * K + p) * I]);
  }
  if (lane.g == 0) {
    sl[39 * I] = mq.w;
    sl[40 * I] = mq.x;
    sl[41 * I] = mq.y;
    sl[42 * I] = mq.z;
  }
  lane.sync();
  const volatile T* fresh = scal;  // read afresh, not kept across the calls above
  const T dt = fresh[0], tau = fresh[1];
  const T dt2 = dt * dt;
  const T mscale = T(2) / (tau * dt) * dt * dt;
  for (int e = tri(3, 0) + lane.g; e < tri(D, 0); e += G) {
    int i, j;
    tri_entry(e, i, j);
    T acc = T(0);
#pragma unroll
    for (int p = 0; p < K; ++p) acc += tk[(i * K + p) * I] * tk[(j * K + p) * I];
    T qij;
    if (j >= 3) {
      const T* rq = tk + (kIndPredRq + 3 * (i - 3)) * I;
      const T* r = tk + (kIndPredR + 3 * (j - 3)) * I;
      qij = mscale * (rq[0] * r[0] + rq[I] * r[I] + rq[2 * I] * r[2 * I]);
    } else {
      qij = dt2 * scal[2 + 6 * i + j];
    }
    const T v = fma_rn(T(0.5), acc, qij);  // the one-thread build's fusion
    sl[(j * D + i) * I] = v;
    sl[(i * D + j) * I] = v;
  }
  __syncthreads();
  const long long bo = static_cast<long long>(fresh_ctaid()) * I;
  stage_out(cov_out, D * D, [](int r) { return r; }, bo, I, nb, at(stage));
  stage_out(mu_out, 7, [](int r) { return r; }, bo, I, nb, at(stage + D * D * I));
}

// The group size of a launch at bank nb, 0 for one thread an instance:
// SLAM_INDIRECT_PREDICT_GROUP lanes up to SLAM_INDIRECT_PREDICT_GROUP_BANKS
// instances, one thread past them. tools/small_kernel_times.py (float32,
// NVIDIA H100 80GB HBM3 at 700 W) timed 8 lanes at 0.0179 ms for one
// instance, 0.0209 for 8192 and 0.0406 for 16 384, against 0.0569, 0.0586
// and 0.0589 for one thread and 0.0607 against 0.0679 at 32 768; 16 lanes
// (0.0139 for one instance) spill in float32 around the math library's
// calls. It builds this file with both macros set to time any design at
// any bank.
#ifndef SLAM_INDIRECT_PREDICT_GROUP
#define SLAM_INDIRECT_PREDICT_GROUP 8
#endif
#ifndef SLAM_INDIRECT_PREDICT_GROUP_BANKS
#define SLAM_INDIRECT_PREDICT_GROUP_BANKS 16384
#endif
constexpr int kIndPredGroup = SLAM_INDIRECT_PREDICT_GROUP;
inline bool indirect_predict_grouped(long long nb) { return nb <= SLAM_INDIRECT_PREDICT_GROUP_BANKS; }

template <typename T>
int launch_indirect_predict(const void* cov, const void* mu, const void* scal, void* cov_out, void* mu_out,
                            long long nb, void* stream) {
  if (nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel, unsigned blocks, int threads) {
    kernel<<<blocks, threads, 0, st>>>(static_cast<const T*>(cov), static_cast<const T*>(mu),
                                       static_cast<const T*>(scal), static_cast<T*>(cov_out),
                                       static_cast<T*>(mu_out), nb);
  };
  if (indirect_predict_grouped(nb)) {
    constexpr long long I = ind_pred_instances(kIndPredGroup);
    launch(indirect_predict_group_kernel<T, kIndPredGroup>, static_cast<unsigned>((nb + I - 1) / I),
           static_cast<int>(I) * kIndPredGroup);
  } else {
    launch(indirect_predict_thread_kernel<T>, blocks_for(nb), kThreads);
  }
  return static_cast<int>(cudaGetLastError());
}

// the warps a block (and, in resident, an SM) of a launch at bank nb
template <typename T>
int indirect_predict_warps(long long nb, int* resident) {
  if (nb < 1) return -static_cast<int>(cudaErrorInvalidValue);
  return indirect_predict_grouped(nb)
             ? group_warps(indirect_predict_group_kernel<T, kIndPredGroup>,
                           ind_pred_instances(kIndPredGroup) * kIndPredGroup, 0, resident)
             : group_warps(indirect_predict_thread_kernel<T>, kThreads, 0, resident);
}

}  // namespace slam

#define SLAM_INDIRECT_PREDICT_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const void* cov, const void* mu, const void* scal, void* cov_out, void* mu_out, \
                      long long nb, void* stream) {                                                  \
    return slam::launch_indirect_predict<T>(cov, mu, scal, cov_out, mu_out, nb, stream);             \
  }                                                                                                  \
  extern "C" int NAME##_warps(long long nb) { return slam::indirect_predict_warps<T>(nb, nullptr); }  \
  extern "C" int NAME##_resident(long long nb) {                                                     \
    int resident = 0;                                                                                \
    const int warps = slam::indirect_predict_warps<T>(nb, &resident);                               \
    return warps < 0 ? warps : resident;                                                             \
  }

SLAM_INDIRECT_PREDICT_ENTRY(slam_indirect_predict_f32, float)
SLAM_INDIRECT_PREDICT_ENTRY(slam_indirect_predict_f64, double)
