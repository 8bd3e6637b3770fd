// K3 · fused PoseUKF measurement update with the measurement model in-kernel.
//
// Replaces the TPU kernel models/pose_update_fused.py::_make_update_model_kernel
// with _factor_innovation, _update_tail_from_sc and _model_measurement
// (launched by _pose_update_model_lanes), for all seven FUSED_MODELS selected
// by a runtime model id: velocity, z_position, xy_position, acceleration,
// pressure, water_velocity, body_efforts (Fossen inverse dynamics from a
// 119-scalar shared vehicle block). Per instance:
//   1. the equilibrated Cholesky core keeps the factor L̃ and the scale d;
//   2. h on the zero point and on μ ⊞ (±column j), the delta row k being
//      ±L̃(k, j)·d[k] — the (107, 53) delta tensor is never built;
//   3. the measurement mean, ν = z − ẑ, S = ½Σ dz·dzᵀ + R, and
//      C = ½·d ⊙ Σ_j L̃(:, j)·(Z⁺_j − Z⁻_j) from the factor;
//   4. the m x m Cholesky of S, W = C·L_S^-T by ascending forward
//      substitution, y = L_S^-1·ν, m2 = |y|², the gate as a select (a
//      threshold < 0 accepts any; a NaN S leaves the instance bit-identical to
//      its prior), the correction μ ⊞ W·y and the downdate cov − W·Wᵀ on the
//      valid half (row >= col).
// Model parameters: 5 aux values, shared (scal[1..5]) or per instance (aux,
// (5, nb)); scal[0] is the gate threshold.
//
// Bound on Hopper: memory (the valid covariance half read and written: 0.47
// ms at bank 131 072, float32). Its first design ran pose_bodies.cuh::
// update_model_body one thread per instance with the factor, the
// measurements and C/W in bank-last global scratch: ~n³/6 dependent
// read-modify-writes through L2 and 254 registers a thread, ~1% of the
// bound. Here one warp updates one instance (warp_update.cuh): the factor,
// the mean, the measurements, C and W in the warp's tile of shared memory,
// lanes sharing out independent outputs, every output in the one-thread
// body's order, so the results are its bits. The block's warps load their
// instances' valid halves and means together, bank-minor (block_walk), and
// the downdate reads the prior a second time the same way rather than keep
// a second tile that would halve the warps resident; it writes only the
// valid half. The warps per block are chosen from the occupancy of the
// model's tile (resident_warps_log2). K5 (pose_step.cu) runs the same block
// body (warp_update.cuh::block_update_model) after its predict.
//
// Operands (bank-last): z (m, nb), R (m, m, nb), mu (54, nb), cov (53, 53, nb)
// half-valid, scal (6), mscal (119) or null, aux (5, nb) or null.
// Outputs: cov_out (53, 53, nb) valid half, mu_out (54, nb), m2 (nb),
// acc (nb) as 1/0, nu (m, nb). No scratch.

#include "warp_update.cuh"

namespace slam {

template <typename T>
__global__ void __launch_bounds__(kWarpSize* kMaxWarps, sizeof(T) == 4 ? 2 : 1)
pose_update_model_kernel(int model, int banked_aux, const T* __restrict__ z, const T* __restrict__ rmat,
                         const T* __restrict__ mu, const T* __restrict__ cov, const T* __restrict__ scal,
                         const T* __restrict__ msc, const T* __restrict__ aux_b, T* __restrict__ cov_out,
                         T* __restrict__ mu_out, T* __restrict__ m2_out, T* __restrict__ acc_out,
                         T* __restrict__ nu_out, long long nb, int log_w) {
  block_update_model<T>(model, banked_aux, z, rmat, mu, cov, scal, msc, aux_b, cov_out, mu_out, m2_out, acc_out,
                        nu_out, nb, log_w, UpdateTile(model_dim(model)).size);
}

// The launch's warps per block as log2 (cached per model), or a negated
// cudaError_t.
template <typename T>
int pose_update_model_log_w(int model, long long nb) {
  if (model_dim(model) == 0 || nb < 1) return -static_cast<int>(cudaErrorInvalidValue);
  static const long long max_bytes = opt_in_smem(pose_update_model_kernel<T>);
  if (max_bytes < 0) return static_cast<int>(max_bytes);
  const long long bytes = static_cast<long long>(UpdateTile(model_dim(model)).size) * sizeof(T);
  const int log_w = resident_warps_log2(pose_update_model_kernel<T>, nb, bytes, max_bytes);
  if (log_w < -1) return log_w + 1;
  return log_w < 0 ? -static_cast<int>(cudaErrorInvalidValue) : log_w;
}

template <typename T>
int launch_pose_update_model(int model, int banked_aux, const void* z, const void* r, const void* mu,
                             const void* cov, const void* scal, const void* msc, const void* aux, void* cov_out,
                             void* mu_out, void* m2, void* acc, void* nu, long long nb, void* stream) {
  if (model == kBodyEfforts && msc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (banked_aux && aux == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int log_w = pose_update_model_log_w<T>(model, nb);
  if (log_w < 0) return -log_w;
  const size_t bytes = static_cast<size_t>(UpdateTile(model_dim(model)).size) * sizeof(T) << log_w;
  const unsigned blocks = static_cast<unsigned>((nb + (1LL << log_w) - 1) >> log_w);
  pose_update_model_kernel<T><<<blocks, kWarpSize << log_w, bytes, static_cast<cudaStream_t>(stream)>>>(
      model, banked_aux, static_cast<const T*>(z), static_cast<const T*>(r), static_cast<const T*>(mu),
      static_cast<const T*>(cov), static_cast<const T*>(scal), static_cast<const T*>(msc),
      static_cast<const T*>(aux), static_cast<T*>(cov_out), static_cast<T*>(mu_out), static_cast<T*>(m2),
      static_cast<T*>(acc), static_cast<T*>(nu), nb, log_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_UPDATE_ENTRY(NAME, T)                                                                       \
  extern "C" int NAME(int model, int banked_aux, const void* z, const void* r, const void* mu,                 \
                      const void* cov, const void* scal, const void* msc, const void* aux, void* cov_out,      \
                      void* mu_out, void* m2, void* acc, void* nu, long long nb, void* stream) {               \
    return slam::launch_pose_update_model<T>(model, banked_aux, z, r, mu, cov, scal, msc, aux, cov_out,        \
                                             mu_out, m2, acc, nu, nb, stream);                                 \
  }                                                                                                            \
  extern "C" int NAME##_warps(int model, long long nb) {                                                       \
    const int log_w = slam::pose_update_model_log_w<T>(model, nb);                                             \
    return log_w < 0 ? log_w : 1 << log_w;                                                                     \
  }

SLAM_POSE_UPDATE_ENTRY(slam_pose_update_model_f32, float)
SLAM_POSE_UPDATE_ENTRY(slam_pose_update_model_f64, double)
