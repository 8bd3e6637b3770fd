// K5 · the whole PoseUKF filter step in one launch: predict + a chain of
// in-kernel-model updates.
//
// Replaces the TPU kernel models/pose_update_fused.py::_make_step_kernel
// (launched by _pose_step_lanes). One warp per instance, W instances a
// block:
//   1. K2's shared-mode predict (warp_predict.cuh::block_predict) from the
//      input state, written to cov_out (valid half) / mu_out;
//   2. for each update k of the chain, in order, K3's whole update
//      (warp_update.cuh::block_update_model) of the current cov_out / mu_out,
//      in place: the block reloads its instances' valid halves and means, a
//      fresh equilibrated factor of the current covariance (a new draw of
//      sigma points, as ukfom's update does), the in-kernel h of model k, the
//      gain and the gate, then the block-wide downdate and select. Update k
//      writes its NIS, gate outcome and innovation to its own outputs.
// The arithmetic is K2's and K3's, one copy of each body, so the chain K2 →
// k·K3 computes the same function, bit for bit, in 1 + k launches.
//
// The running covariance and mean are the outputs themselves: the predict
// writes cov_out / mu_out, and every update reads and rewrites them in place
// (each entry read and written by one thread; see block_update_model). The
// round trip stays in the block between __syncthreads and is L2-hot: W
// instances' valid halves (5.7 KB each in float32). The TPU kernel keeps the
// state in VMEM scratch and writes the outputs at the last update.
//
// Bound on Hopper: memory (the valid half read once and written once, as for
// K2). Its first design ran both bodies one thread per instance with the
// factor, the points, the measurements and the gain in bank-last global
// scratch (y, c, zs, cw), ~1% of the bound. Now the tiles of shared memory
// hold all of it; no global scratch. A warp's tile is K2's (the larger:
// UpdateTile(6) is 3.5k entries), so K5 keeps as many warps resident as K2.
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
// (54, nb); per update m2_k (nb), acc_k (nb) as 1/0, nu_k (m_k, nb). No
// scratch.

#include "warp_predict.cuh"
#include "warp_update.cuh"

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

// a warp's tile: the larger of the predict's and the largest update's
__host__ __device__ inline int step_tile_size() {
  const int p = PredictTile(false).size, u = UpdateTile(kMaxM).size;
  return p > u ? p : u;
}

template <typename T>
__global__ void __launch_bounds__(kWarpSize* kMaxWarps, sizeof(T) == 4 ? 2 : 1)
pose_step_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ rr,
                 const T* __restrict__ coeff, const T* __restrict__ offs,
                 const T* __restrict__ q0m, const T* __restrict__ scal,
                 const T* __restrict__ scal6, const StepChain<T> chain, T* cov_out, T* mu_out,
                 long long nb, int log_w) {
  const int stride = step_tile_size();
  block_predict<T, false>(cov, mu, rr, coeff, offs, q0m, scal, nullptr, cov_out, mu_out, nb, log_w, stride);
  for (int k = 0; k < chain.n; ++k) {
    __syncthreads();  // the block's predict or previous update is written, its tiles free
    block_update_model<T>(chain.model[k], 0, chain.z[k], chain.r[k], mu_out, cov_out, scal6 + 6 * k, nullptr,
                          nullptr, cov_out, mu_out, chain.m2[k], chain.acc[k], chain.nu[k], nb, log_w, stride);
  }
}

// The launch's warps per block as log2, or a negated cudaError_t; `resident`
// receives the warps an SM keeps.
template <typename T>
int pose_step_log_w(long long nb, int* resident = nullptr) {
  if (nb < 1) return -static_cast<int>(cudaErrorInvalidValue);
  static const long long max_bytes = opt_in_smem(pose_step_kernel<T>);
  if (max_bytes < 0) return static_cast<int>(max_bytes);
  const long long bytes = static_cast<long long>(step_tile_size()) * sizeof(T);
  const int log_w = resident_warps_log2(pose_step_kernel<T>, nb, bytes, max_bytes, resident);
  if (log_w < -1) return log_w + 1;
  return log_w < 0 ? -static_cast<int>(cudaErrorInvalidValue) : log_w;
}

template <typename T>
int launch_pose_step(const void* cov, const void* mu, const void* rr, const void* coeff,
                     const void* offs, const void* q0m, const void* scal, int n_upd,
                     const int* models, const void* const* z, const void* const* r,
                     const void* scal6, void* const* m2, void* const* acc, void* const* nu,
                     void* cov_out, void* mu_out, long long nb, void* stream) {
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
  const int log_w = pose_step_log_w<T>(nb);
  if (log_w < 0) return -log_w;
  const size_t bytes = static_cast<size_t>(step_tile_size()) * sizeof(T) << log_w;
  const unsigned blocks = static_cast<unsigned>((nb + (1LL << log_w) - 1) >> log_w);
  pose_step_kernel<T><<<blocks, kWarpSize << log_w, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(rr),
      static_cast<const T*>(coeff), static_cast<const T*>(offs), static_cast<const T*>(q0m),
      static_cast<const T*>(scal), static_cast<const T*>(scal6), chain, static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), nb, log_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_STEP_ENTRY(NAME, T)                                                               \
  extern "C" int NAME(const void* cov, const void* mu, const void* rr, const void* coeff,           \
                      const void* offs, const void* q0m, const void* scal, int n_upd,               \
                      const int* models, const void* const* z, const void* const* r,                \
                      const void* scal6, void* const* m2, void* const* acc, void* const* nu,        \
                      void* cov_out, void* mu_out, long long nb, void* stream) {                    \
    return slam::launch_pose_step<T>(cov, mu, rr, coeff, offs, q0m, scal, n_upd, models, z, r,      \
                                     scal6, m2, acc, nu, cov_out, mu_out, nb, stream);              \
  }                                                                                                 \
  extern "C" int NAME##_warps(long long nb) {                                                       \
    const int log_w = slam::pose_step_log_w<T>(nb);                                                 \
    return log_w < 0 ? log_w : 1 << log_w;                                                          \
  }                                                                                                 \
  extern "C" int NAME##_resident(long long nb) {                                                    \
    int resident = 0;                                                                               \
    const int log_w = slam::pose_step_log_w<T>(nb, &resident);                                      \
    return log_w < 0 ? log_w : resident;                                                            \
  }

SLAM_POSE_STEP_ENTRY(slam_pose_step_f32, float)
SLAM_POSE_STEP_ENTRY(slam_pose_step_f64, double)
