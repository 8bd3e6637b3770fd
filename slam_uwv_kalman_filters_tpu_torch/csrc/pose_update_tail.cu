// K4 · the generic-h PoseUKF update tail.
//
// Replaces the TPU kernel models/pose_update_fused.py::_make_update_kernel
// (body _update_tail, then _update_tail_from_sc; launched by
// _pose_update_lanes): the update of a measurement model h that ran outside
// the kernel. Per instance, one thread:
//   1. S = ½·Σ dz·dzᵀ + R and C = ½·Σ δ·dzᵀ over all 107 sigma points, each
//      point summed on its own (the ± pairs are never folded);
//   2. the tail K3 shares (common.cuh::update_tail): the m x m Cholesky of S,
//      W = C·L_S^-T by ascending forward substitution, y = L_S^-1·ν, m2 = |y|²,
//      the gate as a select (a threshold < 0 accepts any; a NaN S leaves the
//      instance bit-identical to its prior), the correction μ ⊞ W·y and the
//      half-triangle downdate cov − W·Wᵀ.
// m is a template parameter, instantiated for 1 … kMaxM = 6 (every m the JAX
// package passes: 1, 2, 3, 6); the wrapper refuses a larger one.
//
// Bound on Hopper: memory. The deltas (107 x 53) are read once, in column
// chunks of kChunk with the chunk's m·kChunk sums in registers; dz is read
// once for S and once per chunk for C. The tail then reads C/W from a bank-
// last scratch 2m times per valid covariance entry (K3's structure). All
// accesses are coalesced (bank-last); a later version keeps W in shared
// memory.
//
// Operands (bank-last): deltas (107, 53, nb), dz (107, m, nb), nu (m, nb),
// R (m, m, nb), mu (54, nb), cov (53, 53, nb) half-valid, thr (by value).
// Outputs: cov_out (53, 53, nb) valid half, mu_out (54, nb), m2 (nb), acc (nb)
// as 1/0. Scratch: w (m, 53, nb).

#include "common.cuh"

namespace slam {

constexpr int kChunk = 8;  // delta columns whose C sums stay in registers

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
pose_update_tail_kernel(const T* __restrict__ deltas, const T* __restrict__ dz,
                        const T* __restrict__ nu_in, const T* __restrict__ rmat,
                        const T* __restrict__ mu, const T* __restrict__ cov, T thr,
                        T* __restrict__ cov_out, T* __restrict__ mu_out, T* __restrict__ m2_out,
                        T* __restrict__ acc_out, T* __restrict__ w_s, long long nb) {
  constexpr int N = kPoseN, S = kPoseS, K = kPoseSig;
  const long long b = instance_index();
  if (b >= nb) return;
  const T* d = deltas + b;
  const T* z = dz + b;
  T* w = w_s + b;  // (M, 53): C, then W in place
  auto D = [&](int p, int k) -> T { return d[(static_cast<long long>(p) * N + k) * nb]; };
  auto Zd = [&](int p, int i) -> T { return z[(static_cast<long long>(p) * M + i) * nb]; };
  auto C = [&](int i, int k) -> T& { return w[(static_cast<long long>(i) * N + k) * nb]; };

  T m[S];
  for (int s = 0; s < S; ++s) m[s] = mu[b + s * nb];
  T nu[kMaxM];
  for (int i = 0; i < M; ++i) nu[i] = nu_in[b + i * nb];

  // 1a. S = ½·Σ dz·dzᵀ + R, one pass over the points
  T sacc[M][M];
  for (int i = 0; i < M; ++i)
    for (int k = 0; k <= i; ++k) sacc[i][k] = T(0);
  for (int p = 0; p < K; ++p) {
    T zp[M];
    for (int i = 0; i < M; ++i) zp[i] = Zd(p, i);
    for (int i = 0; i < M; ++i)
      for (int k = 0; k <= i; ++k) sacc[i][k] += zp[i] * zp[k];
  }
  T Sm[kMaxM][kMaxM];
  for (int i = 0; i < M; ++i)
    for (int k = 0; k <= i; ++k)
      Sm[i][k] = Sm[k][i] = T(0.5) * sacc[i][k] + rmat[b + (static_cast<long long>(i) * M + k) * nb];

  // 1b. C = ½·Σ δ·dzᵀ, kChunk delta columns at a time
  for (int k0 = 0; k0 < N; k0 += kChunk) {
    T acc[M][kChunk];
    for (int i = 0; i < M; ++i)
      for (int kk = 0; kk < kChunk; ++kk) acc[i][kk] = T(0);
    for (int p = 0; p < K; ++p) {
      T zp[M];
      for (int i = 0; i < M; ++i) zp[i] = Zd(p, i);
      for (int kk = 0; kk < kChunk; ++kk) {
        if (k0 + kk < N) {
          const T dv = D(p, k0 + kk);
          for (int i = 0; i < M; ++i) acc[i][kk] += dv * zp[i];
        }
      }
    }
    for (int i = 0; i < M; ++i)
      for (int kk = 0; kk < kChunk; ++kk)
        if (k0 + kk < N) C(i, k0 + kk) = T(0.5) * acc[i][kk];
  }

  // 2. the shared tail: gain, gate, correction, downdate
  update_tail<T>(M, Sm, C, nu, m, thr, cov + b, cov_out, mu_out, m2_out, acc_out, b, nb);
}

template <typename T, int M>
void launch_m(const void* d, const void* dz, const void* nu, const void* r, const void* mu,
              const void* cov, double thr, void* cov_out, void* mu_out, void* m2, void* acc, void* w,
              long long nb, cudaStream_t stream) {
  pose_update_tail_kernel<T, M><<<blocks_for(nb), kThreads, 0, stream>>>(
      static_cast<const T*>(d), static_cast<const T*>(dz), static_cast<const T*>(nu),
      static_cast<const T*>(r), static_cast<const T*>(mu), static_cast<const T*>(cov),
      static_cast<T>(thr), static_cast<T*>(cov_out), static_cast<T*>(mu_out), static_cast<T*>(m2),
      static_cast<T*>(acc), static_cast<T*>(w), nb);
}

template <typename T>
int launch_pose_update_tail(int m, const void* d, const void* dz, const void* nu, const void* r,
                            const void* mu, const void* cov, double thr, void* cov_out,
                            void* mu_out, void* m2, void* acc, void* w, long long nb,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: launch_m<T, 1>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, w, nb, st); break;
    case 2: launch_m<T, 2>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, w, nb, st); break;
    case 3: launch_m<T, 3>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, w, nb, st); break;
    case 4: launch_m<T, 4>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, w, nb, st); break;
    case 5: launch_m<T, 5>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, w, nb, st); break;
    case 6: launch_m<T, 6>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, w, nb, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_UPDATE_TAIL_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(int m, const void* d, const void* dz, const void* nu, const void* r,        \
                      const void* mu, const void* cov, double thr, void* cov_out, void* mu_out,   \
                      void* m2, void* acc, void* w, long long nb, void* stream) {                \
    return slam::launch_pose_update_tail<T>(m, d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2,  \
                                            acc, w, nb, stream);                                 \
  }

SLAM_POSE_UPDATE_TAIL_ENTRY(slam_pose_update_tail_f32, float)
SLAM_POSE_UPDATE_TAIL_ENTRY(slam_pose_update_tail_f64, double)
