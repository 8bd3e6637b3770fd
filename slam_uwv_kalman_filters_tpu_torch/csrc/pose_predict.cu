// K2 · fused 53-DOF PoseUKF prediction, shared-parameter and full (banked) mode.
//
// Replaces the TPU kernel models/pose_fused.py::_pose_predict_body (built by
// _make_predict_kernel(False) and _make_predict_kernel("full"), launched by
// _pose_predict_lanes): in one launch
//   1. the equilibrated Cholesky core (kept factor) -> ±sigma deltas,
//   2. boxplus and the process model of every sigma point (reference
//      PoseUKF.cpp:12-84: position/velocity Euler steps, orientation with
//      earth rate at the sigma point's latitude, first-order-Markov decays),
//   3. the quaternion mean by MEAN_ITERS = 4 fixed Karcher iterations and
//      its deviations,
//   4. the flat means in closed form about the zero sigma point and their
//      deviations, in place,
//   5. the half-triangle reconstruct ½·Σ D·Dᵀ + Q, Q assembled per instance:
//      the orientation block R(μ_in)·Qrot·R(μ_in)ᵀ (lower half computed and
//      mirrored, so exactly symmetric) and the water-current inflation on the
//      diagonal entries 46..49.
// All 107 sigma points are summed one by one: the ± pairs are never folded
// (folding made missions NaN after tens to hundreds of ticks on the TPU).
//
// Bound on Hopper: memory. One thread per instance; the factor (53², bank-
// last) and the propagated points (107 x 54) live in global scratch, and the
// reconstruct reads the points 2·107·1431 times. All accesses are coalesced,
// but at fleet scale the working set is far beyond L2, so scratch traffic
// sets the time. This first version keeps the structure plain; a later one
// tiles the points in shared memory and gives each instance a warp.
//
// The mode is a template parameter, so the shared-mode code compiles as it did
// before the full mode existed. Operands (bank-last): cov (53, 53, nb)
// half-valid in, mu (54, nb), rr (3, nb), scal (14) [dt, lat0, 1/m_rad,
// EARTHW, wv_scale·dt³, dt²·Qrot row-major x9], and
//   shared mode: coeff/offs (54) Markov coefficient -dt/tau and rest point,
//     q0m (53, 53) dt²-scaled Q with its orientation block zeroed;
//   full mode (a banked Monte-Carlo parameter set): coeff/offs (54, nb), q0m
//     (53, 53, nb) per lane, and aux (12, nb) [lat0; 1/m_rad; dt²·Qrot x9;
//     wv_scale·dt³] in place of scal's entries 1, 2, 4 and 5..13 (note the
//     other order: Qrot before the current inflation). The Markov decay of
//     storage rows 10..53 then runs as its own pass, one row at a time, so
//     each per-lane coefficient is read once; it adds ~1.5k coalesced reads
//     per instance to the ~415k scratch accesses of the shared mode.
// Outputs: cov_out (53, 53, nb) written only at row >= col, mu_out (54, nb).
// Scratch: y (107, 54, nb), c (53, 53, nb). The body is
// pose_bodies.cuh::predict_body, which K5 (pose_step.cu) runs too.

#include "pose_bodies.cuh"

namespace slam {

template <typename T, bool FULL>
__global__ void __launch_bounds__(kThreads)
pose_predict_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ rr,
                    const T* __restrict__ coeff, const T* __restrict__ offs,
                    const T* __restrict__ q0m, const T* __restrict__ scal,
                    const T* __restrict__ aux, T* __restrict__ cov_out, T* __restrict__ mu_out,
                    T* __restrict__ y_s, T* __restrict__ c_s, long long nb) {
  const long long b = instance_index();
  if (b >= nb) return;
  predict_body<T, FULL>(b, cov, mu, rr, coeff, offs, q0m, scal, aux, cov_out, mu_out, y_s, c_s, nb);
}

template <typename T, bool FULL>
int launch_pose_predict(const void* cov, const void* mu, const void* rr, const void* coeff,
                        const void* offs, const void* q0m, const void* scal, const void* aux,
                        void* cov_out, void* mu_out, void* y, void* c, long long nb, void* stream) {
  if (FULL && aux == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  pose_predict_kernel<T, FULL><<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(rr),
      static_cast<const T*>(coeff), static_cast<const T*>(offs), static_cast<const T*>(q0m),
      static_cast<const T*>(scal), static_cast<const T*>(aux), static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), static_cast<T*>(y), static_cast<T*>(c), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_PREDICT_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* cov, const void* mu, const void* rr, const void* coeff,          \
                      const void* offs, const void* q0m, const void* scal, void* cov_out,          \
                      void* mu_out, void* y, void* c, long long nb, void* stream) {                \
    return slam::launch_pose_predict<T, false>(cov, mu, rr, coeff, offs, q0m, scal, nullptr,       \
                                               cov_out, mu_out, y, c, nb, stream);                 \
  }
#define SLAM_POSE_PREDICT_FULL_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* cov, const void* mu, const void* rr, const void* coeff,          \
                      const void* offs, const void* q0m, const void* scal, const void* aux,        \
                      void* cov_out, void* mu_out, void* y, void* c, long long nb, void* stream) {  \
    return slam::launch_pose_predict<T, true>(cov, mu, rr, coeff, offs, q0m, scal, aux, cov_out,   \
                                              mu_out, y, c, nb, stream);                           \
  }

SLAM_POSE_PREDICT_ENTRY(slam_pose_predict_f32, float)
SLAM_POSE_PREDICT_ENTRY(slam_pose_predict_f64, double)
SLAM_POSE_PREDICT_FULL_ENTRY(slam_pose_predict_full_f32, float)
SLAM_POSE_PREDICT_FULL_ENTRY(slam_pose_predict_full_f64, double)
