// K9 · the IndirectPoseUKF prediction in one launch.
//
// Replaces the TPU kernel models/indirect_fused.py::_predict_kernel
// (launched by _indirect_predict_lanes). Per instance, one thread, all in
// registers (6 DOF: the position error ℝ³ and the orientation error SO(3)):
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
// (~280 bytes in float32 at 3.35 TB/s) against ~6.5k dependent operations
// in one thread (13 exp/log pairs, 4 Karcher iterations of 13 log maps with
// atan2); a launch at bank 65 536 is 512 blocks on 132 SMs. This first
// version keeps one thread per instance and the 13 sigma points unrolled.
//
// Operands (bank-last): cov (6, 6, nb) (col, row), lower half read; mu (7,
// nb) [position error xyz, quaternion wxyz]; scal (38) on the device: dt, τ,
// then Q (symmetric) row-major, read alike by every thread. Outputs: cov_out
// (6, 6, nb) both halves, mu_out (7, nb).

#include "small_ukf.cuh"
#include "so3.cuh"

namespace slam {

constexpr int kIndDof = 6;
constexpr int kIndSig = 2 * kIndDof + 1;  // 13
constexpr int kIndMeanIters = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
indirect_predict_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ scal,
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

template <typename T>
int launch_indirect_predict(const void* cov, const void* mu, const void* scal, void* cov_out, void* mu_out,
                            long long nb, void* stream) {
  indirect_predict_kernel<T><<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(scal), static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

extern "C" int slam_indirect_predict_f32(const void* cov, const void* mu, const void* scal, void* cov_out,
                                         void* mu_out, long long nb, void* stream) {
  return slam::launch_indirect_predict<float>(cov, mu, scal, cov_out, mu_out, nb, stream);
}

extern "C" int slam_indirect_predict_f64(const void* cov, const void* mu, const void* scal, void* cov_out,
                                         void* mu_out, long long nb, void* stream) {
  return slam::launch_indirect_predict<double>(cov, mu, scal, cov_out, mu_out, nb, stream);
}
