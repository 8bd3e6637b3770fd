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
// Bound on Hopper: memory (the valid covariance half read and written, 0.79
// ms at bank 131 072 in float32). Its first design gave each instance one
// thread with the factor and the points in bank-last global scratch (~1% of
// the bound). Here one warp predicts one instance (warp_predict.cuh): the
// factor and the points share the warp's tile of shared memory, no global
// scratch, the first design's bits. The block's warps load their instances'
// lower halves and means together, bank-minor (block_walk); the reconstruct
// writes each output entry from its lane. The warps per block are chosen from
// the occupancy of the mode's tile (resident_warps_log2, the widest block
// among those that keep the most warps resident).
//
// Operands (bank-last): cov (53, 53, nb) half-valid in, mu (54, nb), rr (3,
// nb), scal (14) [dt, lat0, 1/m_rad, EARTHW, wv_scale·dt³, dt²·Qrot row-major
// x9], and
//   shared mode: coeff/offs (54) Markov coefficient -dt/tau and rest point,
//     q0m (53, 53) dt²-scaled Q with its orientation block zeroed;
//   full mode (a banked Monte-Carlo parameter set): coeff/offs (54, nb), q0m
//     (53, 53, nb) per lane, and aux (12, nb) [lat0; 1/m_rad; dt²·Qrot x9;
//     wv_scale·dt³] in place of scal's entries 1, 2, 4 and 5..13 (note the
//     other order: Qrot before the current inflation). The block loads each
//     instance's coeff/offs into its tile.
// Outputs: cov_out (53, 53, nb) written only at row >= col, mu_out (54, nb).
// No scratch.

#include "warp_predict.cuh"

namespace slam {

template <typename T, bool FULL>
__global__ void __launch_bounds__(kWarpSize* kMaxWarps, sizeof(T) == 4 ? 2 : 1)
pose_predict_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ rr,
                    const T* __restrict__ coeff, const T* __restrict__ offs,
                    const T* __restrict__ q0m, const T* __restrict__ scal,
                    const T* __restrict__ aux, T* __restrict__ cov_out, T* __restrict__ mu_out,
                    long long nb, int log_w) {
  block_predict<T, FULL>(cov, mu, rr, coeff, offs, q0m, scal, aux, cov_out, mu_out, nb, log_w,
                         PredictTile(FULL).size);
}

// The launch's warps per block as log2, or a negated cudaError_t; `resident`
// receives the warps an SM keeps.
template <typename T, bool FULL>
int pose_predict_log_w(long long nb, int* resident = nullptr) {
  if (nb < 1) return -static_cast<int>(cudaErrorInvalidValue);
  static const long long max_bytes = opt_in_smem(pose_predict_kernel<T, FULL>);
  if (max_bytes < 0) return static_cast<int>(max_bytes);
  const long long bytes = static_cast<long long>(PredictTile(FULL).size) * sizeof(T);
  const int log_w = resident_warps_log2(pose_predict_kernel<T, FULL>, nb, bytes, max_bytes, resident);
  if (log_w < -1) return log_w + 1;
  return log_w < 0 ? -static_cast<int>(cudaErrorInvalidValue) : log_w;
}

template <typename T, bool FULL>
int launch_pose_predict(const void* cov, const void* mu, const void* rr, const void* coeff,
                        const void* offs, const void* q0m, const void* scal, const void* aux,
                        void* cov_out, void* mu_out, long long nb, void* stream) {
  if (FULL && aux == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int log_w = pose_predict_log_w<T, FULL>(nb);
  if (log_w < 0) return -log_w;
  const size_t bytes = static_cast<size_t>(PredictTile(FULL).size) * sizeof(T) << log_w;
  const unsigned blocks = static_cast<unsigned>((nb + (1LL << log_w) - 1) >> log_w);
  pose_predict_kernel<T, FULL><<<blocks, kWarpSize << log_w, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(rr),
      static_cast<const T*>(coeff), static_cast<const T*>(offs), static_cast<const T*>(q0m),
      static_cast<const T*>(scal), static_cast<const T*>(aux), static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), nb, log_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_PREDICT_WARPS(NAME, T, FULL)                                                    \
  extern "C" int NAME##_warps(long long nb) {                                                      \
    const int log_w = slam::pose_predict_log_w<T, FULL>(nb);                                       \
    return log_w < 0 ? log_w : 1 << log_w;                                                         \
  }                                                                                                \
  extern "C" int NAME##_resident(long long nb) {                                                   \
    int resident = 0;                                                                              \
    const int log_w = slam::pose_predict_log_w<T, FULL>(nb, &resident);                            \
    return log_w < 0 ? log_w : resident;                                                           \
  }
#define SLAM_POSE_PREDICT_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* cov, const void* mu, const void* rr, const void* coeff,          \
                      const void* offs, const void* q0m, const void* scal, void* cov_out,          \
                      void* mu_out, long long nb, void* stream) {                                  \
    return slam::launch_pose_predict<T, false>(cov, mu, rr, coeff, offs, q0m, scal, nullptr,       \
                                               cov_out, mu_out, nb, stream);                       \
  }                                                                                                \
  SLAM_POSE_PREDICT_WARPS(NAME, T, false)
#define SLAM_POSE_PREDICT_FULL_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* cov, const void* mu, const void* rr, const void* coeff,          \
                      const void* offs, const void* q0m, const void* scal, const void* aux,        \
                      void* cov_out, void* mu_out, long long nb, void* stream) {                   \
    return slam::launch_pose_predict<T, true>(cov, mu, rr, coeff, offs, q0m, scal, aux, cov_out,   \
                                              mu_out, nb, stream);                                 \
  }                                                                                                \
  SLAM_POSE_PREDICT_WARPS(NAME, T, true)

SLAM_POSE_PREDICT_ENTRY(slam_pose_predict_f32, float)
SLAM_POSE_PREDICT_ENTRY(slam_pose_predict_f64, double)
SLAM_POSE_PREDICT_FULL_ENTRY(slam_pose_predict_full_f32, float)
SLAM_POSE_PREDICT_FULL_ENTRY(slam_pose_predict_full_f64, double)
