// K5 · the whole PoseUKF filter step in one launch: predict + a chain of
// in-kernel-model updates.
//
// Replaces the TPU kernel models/pose_update_fused.py::_make_step_kernel
// (launched by _pose_step_lanes). Per instance, one thread:
//   1. K2's shared-mode predict (pose_bodies.cuh::predict_body) from the
//      input state into cov_out / mu_out;
//   2. for each update k of the chain, in order, K3's whole update
//      (pose_bodies.cuh::update_model_body) of the current cov_out / mu_out,
//      in place: a fresh equilibrated factor of the current covariance (a new
//      draw of sigma points, as ukfom's update does), the in-kernel h of model
//      k, the shared tail (common.cuh::update_tail). Update k writes its NIS,
//      gate outcome and innovation to its own outputs.
// The arithmetic is K2's and K3's, one copy of each body; the chain K2 →
// k·K3 computes the same function in 1 + k launches.
//
// The running covariance and mean are the outputs themselves: the predict
// writes cov_out / mu_out, and every update reads and rewrites them in place
// (the update body takes cov/cov_out and mu/mu_out without __restrict__; see
// pose_bodies.cuh). The TPU kernel keeps them in VMEM scratch and writes the
// outputs at the last update; here global scratch would cost one more
// 53·53·nb buffer and the same traffic.
//
// Bound on Hopper: memory, like K2 and K3 — the scratch of the two bodies
// (y, c, zs, cw; bank-last, coalesced) far exceeds L2 at fleet scale. The
// chain saves the 2k round trips of the covariance between launches, each
// ~3 % of a K3 launch at bank 131 072.
//
// The chain is a kernel argument: the launcher copies the model ids and the
// per-update pointers into a by-value StepChain of at most kMaxSteps
// updates. Models are the six of K3 that read no parameter block (velocity,
// z_position, xy_position, acceleration, pressure, water_velocity);
// body_efforts is refused, as the TPU kernel passes no model block.
//
// Operands (bank-last): cov (53, 53, nb) half-valid, mu (54, nb), rr (3, nb),
// coeff/offs (54), q0m (53, 53), scal (14) as K2's shared mode; per update k:
// z_k (m_k, nb), R_k (m_k, m_k, nb), and row k of scal6 (n, 6) [threshold,
// aux ×5] on the device. Outputs: cov_out (53, 53, nb) valid half, mu_out
// (54, nb); per update m2_k (nb), acc_k (nb) as 1/0, nu_k (m_k, nb).
// Scratch: y (107, 54, nb), c (53, 53, nb), zs (2, 53, m_max, nb),
// cw (m_max, 53, nb).

#include "pose_bodies.cuh"

namespace slam {

constexpr int kMaxSteps = 8;

template <typename T>
struct StepChain {
  int n;
  int model[kMaxSteps];
  const T* z[kMaxSteps];
  const T* r[kMaxSteps];
  T* m2[kMaxSteps];
  T* acc[kMaxSteps];
  T* nu[kMaxSteps];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
pose_step_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ rr,
                 const T* __restrict__ coeff, const T* __restrict__ offs,
                 const T* __restrict__ q0m, const T* __restrict__ scal,
                 const T* __restrict__ scal6, const StepChain<T> chain, T* cov_out, T* mu_out,
                 T* __restrict__ y_s, T* __restrict__ c_s, T* __restrict__ zs_s,
                 T* __restrict__ cw_s, long long nb) {
  const long long b = instance_index();
  if (b >= nb) return;
  predict_body<T, false>(b, cov, mu, rr, coeff, offs, q0m, scal, nullptr, cov_out, mu_out, y_s,
                         c_s, nb);
  for (int k = 0; k < chain.n; ++k) {
    update_model_body<T>(b, chain.model[k], 0, chain.z[k], chain.r[k], mu_out, cov_out,
                         scal6 + 6 * k, nullptr, nullptr, cov_out, mu_out, chain.m2[k],
                         chain.acc[k], chain.nu[k], c_s, zs_s, cw_s, nb);
  }
}

template <typename T>
int launch_pose_step(const void* cov, const void* mu, const void* rr, const void* coeff,
                     const void* offs, const void* q0m, const void* scal, int n_upd,
                     const int* models, const void* const* z, const void* const* r,
                     const void* scal6, void* const* m2, void* const* acc, void* const* nu,
                     void* cov_out, void* mu_out, void* y, void* c, void* zs, void* cw,
                     long long nb, void* stream) {
  if (n_upd < 1 || n_upd > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  StepChain<T> chain{};
  chain.n = n_upd;
  for (int k = 0; k < n_upd; ++k) {
    if (model_dim(models[k]) == 0 || models[k] == kBodyEfforts)
      return static_cast<int>(cudaErrorInvalidValue);
    chain.model[k] = models[k];
    chain.z[k] = static_cast<const T*>(z[k]);
    chain.r[k] = static_cast<const T*>(r[k]);
    chain.m2[k] = static_cast<T*>(m2[k]);
    chain.acc[k] = static_cast<T*>(acc[k]);
    chain.nu[k] = static_cast<T*>(nu[k]);
  }
  pose_step_kernel<T><<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(rr),
      static_cast<const T*>(coeff), static_cast<const T*>(offs), static_cast<const T*>(q0m),
      static_cast<const T*>(scal), static_cast<const T*>(scal6), chain, static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), static_cast<T*>(y), static_cast<T*>(c), static_cast<T*>(zs),
      static_cast<T*>(cw), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_STEP_ENTRY(NAME, T)                                                               \
  extern "C" int NAME(const void* cov, const void* mu, const void* rr, const void* coeff,           \
                      const void* offs, const void* q0m, const void* scal, int n_upd,               \
                      const int* models, const void* const* z, const void* const* r,                \
                      const void* scal6, void* const* m2, void* const* acc, void* const* nu,        \
                      void* cov_out, void* mu_out, void* y, void* c, void* zs, void* cw,            \
                      long long nb, void* stream) {                                                 \
    return slam::launch_pose_step<T>(cov, mu, rr, coeff, offs, q0m, scal, n_upd, models, z, r,      \
                                     scal6, m2, acc, nu, cov_out, mu_out, y, c, zs, cw, nb,         \
                                     stream);                                                       \
  }

SLAM_POSE_STEP_ENTRY(slam_pose_step_f32, float)
SLAM_POSE_STEP_ENTRY(slam_pose_step_f64, double)
