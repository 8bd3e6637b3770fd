// K10 · the IndirectPoseUKF visual-marker update with state augmentation,
// in one launch.
//
// Replaces the TPU kernel models/indirect_fused.py::_make_marker_kernel
// (launched by _indirect_markers_lanes). Per instance, one thread:
//   1. the 12-DOF augmented covariance (src/IndirectPoseUKF.cpp:26-33,
//      94-135): the filter block ⊕ the marker pose's, zero cross-covariance;
//      the augmented mean is the error state and the marker pose;
//   2. for each corner c (a runtime loop, no cap): the 12x12 Crout factor L
//      of P (small_ukf.cuh); 25 sigma points, each built from its ±column of
//      L when needed (the 25x12 deltas are never stored); through
//      measurementVisualLandmark (src/IndirectPoseUKF.cpp:38-50): the
//      reference pose ∘ error ∘ camera extrinsics, inverted, applied to the
//      corner that the marker pose moves, normalized to a bearing; the S²
//      Karcher mean of the 25 bearings (s2.cuh, MEAN_ITERS = 4 fixed
//      iterations seeded from point 0), its basis, dZ = bearing ⊟ mean and
//      the innovation z_c ⊟ mean; S = ½ΣdZdZᵀ + R_c, C = ½ΣδdZᵀ and
//      small_ukf.cuh's Kalman tail with a threshold of −1 (every corner is
//      accepted, src/IndirectPoseUKF.cpp:131); the correction moves both
//      positions and ⊞ both quaternions (so3.cuh); m2 and ν written;
//   3. the 6x6 filter block (both halves) and the 7 mean rows written: the
//      marker block is marginalized out (src/IndirectPoseUKF.cpp:134).
//
// Bound on Hopper: latency. Each instance reads 28 + 7 + 7 + 7 values and 7
// per corner and writes 43 + 3 per corner against ~16k dependent operations
// per corner in one thread (a 12x12 factor, 25 sigma points with two ⊞ maps
// and the bearing model, 4 Karcher iterations over 25 bearings with atan2).
// The 12x12 covariance, its factor and the 25 bearings do not fit in
// registers in float64 and spill to local memory; the loops over the sigma
// points and the corners stay rolled (#pragma unroll 1) to keep the build
// short. This first version keeps one thread per instance.
//
// Operands (bank-last): cov (6, 6, nb) (col, row), lower half read; mu (7,
// nb); ref (7, nb) the pose reference [position, quaternion]; mk (7, nb) the
// marker pose; z (k, 3, nb) unit bearings; r (k, 2, 2, nb) tangent
// covariances; scal (43 + 3k) on the device: the camera-in-body position
// (3) and orientation (4), the marker pose's 6x6 covariance row-major
// (symmetric, lower half read), then each corner's position in the marker
// frame. Outputs: cov_out (6, 6, nb) both halves, mu_out (7, nb), m2 (k,
// nb), nu (k, 2, nb).

#include "s2.cuh"
#include "small_ukf.cuh"
#include "so3.cuh"

namespace slam {

constexpr int kAugDof = 12;
constexpr int kAugSig = 2 * kAugDof + 1;  // 25
constexpr int kMarkerMeanIters = 4;

// the tangent delta of sigma point p: 0 for p = 0, else ± column (p − 1)/2
// of the factor L (+ for odd p)
template <typename T>
__device__ __forceinline__ void sigma_delta(const T (&L)[kAugDof][kAugDof], int p, T (&d)[kAugDof]) {
  const int j = p > 0 ? (p - 1) >> 1 : 0;
  const bool plus = (p & 1) != 0;
#pragma unroll
  for (int i = 0; i < kAugDof; ++i) d[i] = (p > 0 && i >= j) ? (plus ? L[i][j] : -L[i][j]) : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
indirect_markers_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ ref,
                        const T* __restrict__ mk, const T* __restrict__ z, const T* __restrict__ r,
                        const T* __restrict__ scal, int n_corners, T* __restrict__ cov_out,
                        T* __restrict__ mu_out, T* __restrict__ m2_out, T* __restrict__ nu_out, long long nb) {
  constexpr int N = kAugDof, K = kAugSig;
  const long long b = instance_index();
  if (b >= nb) return;
  const T cam_p[3] = {scal[0], scal[1], scal[2]};
  const Quat<T> cam_q{scal[3], scal[4], scal[5], scal[6]};
  const T ref_p[3] = {ref[b], ref[b + nb], ref[b + 2 * nb]};
  const Quat<T> ref_q{ref[b + 3 * nb], ref[b + 4 * nb], ref[b + 5 * nb], ref[b + 6 * nb]};
  T pos[3] = {mu[b], mu[b + nb], mu[b + 2 * nb]};
  Quat<T> qe{mu[b + 3 * nb], mu[b + 4 * nb], mu[b + 5 * nb], mu[b + 6 * nb]};
  T mpos[3] = {mk[b], mk[b + nb], mk[b + 2 * nb]};
  Quat<T> mq{mk[b + 3 * nb], mk[b + 4 * nb], mk[b + 5 * nb], mk[b + 6 * nb]};

  T P[N][N];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      P[i][j] = P[j][i] = cov[b + (static_cast<long long>(j) * 6 + i) * nb];
      P[6 + i][6 + j] = P[6 + j][6 + i] = scal[7 + 6 * i + j];
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) P[6 + i][j] = P[j][6 + i] = T(0);
  }

#pragma unroll 1
  for (int c = 0; c < n_corners; ++c) {
    const T fp[3] = {scal[43 + 3 * c], scal[44 + 3 * c], scal[45 + 3 * c]};
    T L[N][N];
    crout<T, N>(P, L);
    T bear[K][3];
#pragma unroll 1
    for (int p = 0; p < K; ++p) {
      T d[N];
      sigma_delta(L, p, d);
      const T sp[3] = {pos[0] + d[0], pos[1] + d[1], pos[2] + d[2]};
      const Quat<T> sq = so3_boxplus(qe, d[3], d[4], d[5], T(1));
      const T smp[3] = {mpos[0] + d[6], mpos[1] + d[7], mpos[2] + d[8]};
      const Quat<T> smq = so3_boxplus(mq, d[9], d[10], d[11], T(1));
      // measurementVisualLandmark: body = ref ∘ error, camera = body ∘ extrinsics
      const Quat<T> body_q = qmul(ref_q, sq);
      T body_p[3], cam_nav_p[3], f_nav[3], f_cam[3];
      rot_fwd(ref_q, sp[0], sp[1], sp[2], body_p[0], body_p[1], body_p[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i) body_p[i] += ref_p[i];
      const Quat<T> cam_nav_q = qmul(body_q, cam_q);
      rot_fwd(body_q, cam_p[0], cam_p[1], cam_p[2], cam_nav_p[0], cam_nav_p[1], cam_nav_p[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i) cam_nav_p[i] += body_p[i];
      rot_fwd(smq, fp[0], fp[1], fp[2], f_nav[0], f_nav[1], f_nav[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i) f_nav[i] = (f_nav[i] + smp[i]) - cam_nav_p[i];
      rot_fwd(qconj(cam_nav_q), f_nav[0], f_nav[1], f_nav[2], f_cam[0], f_cam[1], f_cam[2]);
      const T inv_n = T(1) / d_sqrt(f_cam[0] * f_cam[0] + f_cam[1] * f_cam[1] + f_cam[2] * f_cam[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i) bear[p][i] = inv_n * f_cam[i];
    }
    T zm[3];
    s2_karcher_mean<T, K, kMarkerMeanIters, 1>(bear, zm);
    const S2Basis<T> B = s2_basis(zm);
    T S[2][2] = {{T(0), T(0)}, {T(0), T(0)}}, C[N][2];
#pragma unroll
    for (int i = 0; i < N; ++i) C[i][0] = C[i][1] = T(0);
#pragma unroll 1
    for (int p = 0; p < K; ++p) {
      T d[N], dz[2];
      sigma_delta(L, p, d);
      s2_boxminus(bear[p], zm, B, dz[0], dz[1]);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int e = 0; e < 2; ++e) S[a][e] += dz[a] * dz[e];
#pragma unroll
        for (int i = 0; i < N; ++i) C[i][a] += d[i] * dz[a];
      }
    }
    const long long zc = static_cast<long long>(c) * 3 * nb + b;
    const T zv[3] = {z[zc], z[zc + nb], z[zc + 2 * nb]};
    T nu[2];
    s2_boxminus(zv, zm, B, nu[0], nu[1]);
    const long long rc = static_cast<long long>(c) * 4 * nb + b;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int e = 0; e < 2; ++e) S[a][e] = T(0.5) * S[a][e] + r[rc + (2 * a + e) * nb];
#pragma unroll
      for (int i = 0; i < N; ++i) C[i][a] *= T(0.5);
    }
    T corr[N], m2;
    kalman_tail<T, N, 2>(P, S, C, nu, T(-1), corr, m2);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pos[i] += corr[i];
      mpos[i] += corr[6 + i];
    }
    qe = so3_boxplus(qe, corr[3], corr[4], corr[5], T(1));
    mq = so3_boxplus(mq, corr[9], corr[10], corr[11], T(1));
    m2_out[static_cast<long long>(c) * nb + b] = m2;
    nu_out[static_cast<long long>(c) * 2 * nb + b] = nu[0];
    nu_out[static_cast<long long>(c) * 2 * nb + nb + b] = nu[1];
  }

#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) cov_out[b + (static_cast<long long>(j) * 6 + i) * nb] = P[i][j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) mu_out[b + i * nb] = pos[i];
  mu_out[b + 3 * nb] = qe.w;
  mu_out[b + 4 * nb] = qe.x;
  mu_out[b + 5 * nb] = qe.y;
  mu_out[b + 6 * nb] = qe.z;
}

template <typename T>
int launch_indirect_markers(const void* cov, const void* mu, const void* ref, const void* mk, const void* z,
                            const void* r, const void* scal, int n_corners, void* cov_out, void* mu_out, void* m2,
                            void* nu, long long nb, void* stream) {
  if (n_corners < 1) return static_cast<int>(cudaErrorInvalidValue);
  indirect_markers_kernel<T><<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(ref), static_cast<const T*>(mk),
      static_cast<const T*>(z), static_cast<const T*>(r), static_cast<const T*>(scal), n_corners,
      static_cast<T*>(cov_out), static_cast<T*>(mu_out), static_cast<T*>(m2), static_cast<T*>(nu), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_INDIRECT_MARKERS_ENTRY(NAME, T)                                                                  \
  extern "C" int NAME(const void* cov, const void* mu, const void* ref, const void* mk, const void* z,        \
                      const void* r, const void* scal, int n_corners, void* cov_out, void* mu_out, void* m2, \
                      void* nu, long long nb, void* stream) {                                                 \
    return slam::launch_indirect_markers<T>(cov, mu, ref, mk, z, r, scal, n_corners, cov_out, mu_out, m2, nu, \
                                            nb, stream);                                                     \
  }

SLAM_INDIRECT_MARKERS_ENTRY(slam_indirect_markers_f32, float)
SLAM_INDIRECT_MARKERS_ENTRY(slam_indirect_markers_f64, double)
