// K3 · fused PoseUKF measurement update with the measurement model in-kernel.
//
// Replaces the TPU kernel models/pose_update_fused.py::_make_update_model_kernel
// with _factor_innovation, _update_tail_from_sc and _model_measurement
// (launched by _pose_update_model_lanes), for all seven FUSED_MODELS selected
// by a runtime model id: velocity, z_position, xy_position, acceleration,
// pressure, water_velocity, body_efforts (Fossen inverse dynamics from a
// 119-scalar shared vehicle block). Per instance, one thread:
//   1. the equilibrated Cholesky core keeps the factor L̃ and the scale d;
//   2. h on the zero point and on μ ⊞ (±column j), the delta row k being
//      ±L̃(k, j)·d[k] — the (107, 53) delta tensor is never built;
//   3. the measurement mean, ν = z − ẑ, S = ½Σ dz·dzᵀ + R (second pass over
//      the stored Z), and C = ½·d ⊙ Σ_j L̃(:, j)·(Z⁺_j − Z⁻_j) from the factor;
//   4. the m x m Cholesky of S, W = C·L_S^-T by ascending forward
//      substitution, y = L_S^-1·ν, m2 = |y|², the gate as a select (a
//      threshold < 0 accepts any; a NaN S leaves the instance bit-identical to
//      its prior), the correction μ ⊞ W·y and the downdate cov − W·Wᵀ on the
//      valid half (row >= col) — the tail K4 shares (common.cuh::update_tail).
// Model parameters: 5 aux values, shared (scal[1..5]) or per instance (aux,
// (5, nb)); scal[0] is the gate threshold.
//
// Bound on Hopper: memory, like K2 — the kept factor (53², bank-last global
// scratch) is read once per sigma column by h and again for C, and the
// downdate reads and writes the valid half of the covariance. This first
// version is one thread per instance with coalesced bank-last accesses; a
// later one stages the factor in shared memory.
//
// Operands (bank-last): z (m, nb), R (m, m, nb), mu (54, nb), cov (53, 53, nb)
// half-valid, scal (6), mscal (119) or null, aux (5, nb) or null.
// Outputs: cov_out (53, 53, nb) valid half, mu_out (54, nb), m2 (nb),
// acc (nb) as 1/0, nu (m, nb). Scratch: c (53, 53, nb), zs (2, 53, m, nb),
// cw (m, 53, nb). The body (measurement models included) is
// pose_bodies.cuh::update_model_body, which K5 (pose_step.cu) runs too.

#include "pose_bodies.cuh"

namespace slam {

template <typename T>
__global__ void __launch_bounds__(kThreads)
pose_update_model_kernel(int model, int banked_aux, const T* __restrict__ z,
                         const T* __restrict__ rmat, const T* __restrict__ mu,
                         const T* __restrict__ cov, const T* __restrict__ scal,
                         const T* __restrict__ msc, const T* __restrict__ aux_b,
                         T* __restrict__ cov_out, T* __restrict__ mu_out, T* __restrict__ m2_out,
                         T* __restrict__ acc_out, T* __restrict__ nu_out, T* __restrict__ c_s,
                         T* __restrict__ zs_s, T* __restrict__ cw_s, long long nb) {
  const long long b = instance_index();
  if (b >= nb) return;
  update_model_body<T>(b, model, banked_aux, z, rmat, mu, cov, scal, msc, aux_b, cov_out, mu_out,
                       m2_out, acc_out, nu_out, c_s, zs_s, cw_s, nb);
}

template <typename T>
int launch_pose_update_model(int model, int banked_aux, const void* z, const void* r,
                             const void* mu, const void* cov, const void* scal, const void* msc,
                             const void* aux, void* cov_out, void* mu_out, void* m2, void* acc,
                             void* nu, void* c, void* zs, void* cw, long long nb, void* stream) {
  if (model_dim(model) == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (model == kBodyEfforts && msc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (banked_aux && aux == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  pose_update_model_kernel<T><<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      model, banked_aux, static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(mu), static_cast<const T*>(cov), static_cast<const T*>(scal),
      static_cast<const T*>(msc), static_cast<const T*>(aux), static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), static_cast<T*>(m2), static_cast<T*>(acc), static_cast<T*>(nu),
      static_cast<T*>(c), static_cast<T*>(zs), static_cast<T*>(cw), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_UPDATE_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(int model, int banked_aux, const void* z, const void* r, const void* mu,    \
                      const void* cov, const void* scal, const void* msc, const void* aux,        \
                      void* cov_out, void* mu_out, void* m2, void* acc, void* nu, void* c,        \
                      void* zs, void* cw, long long nb, void* stream) {                           \
    return slam::launch_pose_update_model<T>(model, banked_aux, z, r, mu, cov, scal, msc, aux,    \
                                             cov_out, mu_out, m2, acc, nu, c, zs, cw, nb, stream); \
  }

SLAM_POSE_UPDATE_ENTRY(slam_pose_update_model_f32, float)
SLAM_POSE_UPDATE_ENTRY(slam_pose_update_model_f64, double)
