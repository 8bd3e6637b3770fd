// K11 · the PoseUKF visual-marker update with the 59-DOF state augmentation,
// in one launch.
//
// Replaces the TPU kernel models/pose_marker_fused.py::_make_marker_kernel
// (launched by _pose_marker_lanes). Per instance, one thread:
//   1. the 59x59 augmented covariance (src/PoseUKF.cpp:613-654): the valid
//      (row >= col) half of the 53x53 lanes covariance, a zero cross block
//      and the shared marker-pose prior; the augmented mean is the 54
//      storage rows and the marker pose;
//   2. for each corner c (a runtime loop, no cap): a fresh equilibrated 59x59
//      factor (common.cuh::equilibrated_core in keep mode); the
//      119 sigma points in the order zero, +columns, -columns, each delta
//      rebuilt from its factor column (row k of column j is ±L~(k, j)·d_k;
//      the 119x59 deltas are never stored) and only at the 12 tangent rows
//      the bearing model reads; through measurementVisualLandmark
//      (src/PoseUKF.cpp:233-243): the vehicle pose ∘ camera extrinsics,
//      inverted, applied to the corner that the marker pose moves,
//      normalized to a bearing with the norm floored at the dtype's tiny;
//      the S² Karcher mean of the 119 bearings (s2.cuh's basis, ⊞ and ⊟;
//      MEAN_ITERS = 4 fixed iterations seeded at the zero point), dZ =
//      bearing ⊟ mean, ν = z_c ⊟ mean; S = ½ΣdZdZᵀ + R_c and C = ½·d ⊙
//      Σ_j L~(:, j)·(dZ⁺_j − dZ⁻_j); the 2x2 Cholesky of S, W = C·L⁻ᵀ, y =
//      L⁻¹ν, m2 = |y|², every corner accepted (src/PoseUKF.cpp:646-648); the
//      correction W·y on the flats and ⊞ into both quaternions; the downdate
//      of the valid half of the augmented covariance by W·Wᵀ; m2 and ν
//      written;
//   3. the marker block marginalized out: the top-left 53x53 valid half and
//      the 54 mean rows written.
// The tail is K11's own: common.cuh::update_tail is fixed to the 53-DOF
// state and one quaternion.
//
// Bound on Hopper: operations per corner ~1.4e5 (the 59x59 factor ~7e4, the
// 119 bearing evaluations, 4 Karcher iterations and the deviations ~5e4 with
// sin, cos, sqrt and atan2, C and the downdate ~1.4e4) against ~6.2 KB of
// float32 in and out per instance: operation-bound. This first version is
// one thread per instance; the augmented covariance, its factor, the
// bearings and C/W live in bank-last global scratch (coalesced across a
// warp: neighbouring threads touch neighbouring addresses) and every loop
// over points, columns and corners stays rolled (#pragma unroll 1) so the
// build stays short. A later version gives each instance a warp or a block
// with the factor in shared memory.
//
// Operands (bank-last): cov (53, 53, nb) (col, row), lower half read; mu
// (54, nb); mk (7, nb) the marker pose's mean [position, quaternion]; z (k,
// 3, nb) unit bearings; r (k, 2, 2, nb) tangent covariances; scal (43 + 3k)
// on the device: the camera-in-IMU position (3) and orientation (4), the
// marker pose's 6x6 covariance row-major (the half j >= i of entry (i, j)
// read), then each corner's position in the marker frame. Outputs: cov_out
// (53, 53, nb) valid half, mu_out (54, nb), m2 (k, nb), nu (k, 2, nb).
// Scratch: a (59, 59, nb) the augmented covariance, c (59, 59, nb) its kept
// factor, bear (119, 3, nb) the bearings (then their deviations), w (2, 59,
// nb) C, then W.

#include "s2.cuh"

namespace slam {

constexpr int kAugN = kPoseN + 6;        // 59
constexpr int kAugSig = 2 * kAugN + 1;   // 119
constexpr int kPoseMarkerIters = 4;      // MEAN_ITERS of the bearings' mean

// the predicted bearing of one sigma point: d holds its tangent delta at rows
// 0..5 (vehicle position, orientation) and 53..58 (marker position,
// orientation)
template <typename T>
__device__ __forceinline__ void marker_bearing(const T (&pos)[3], const Quat<T>& q, const T (&mpos)[3],
                                               const Quat<T>& mq, const T (&d)[12], const T (&fp)[3],
                                               const T (&cam_p)[3], const Quat<T>& cam_q, T (&out)[3]) {
  const Quat<T> qs = qnorm(qmul(q, qexp(d[3], d[4], d[5])));
  const Quat<T> mqs = qnorm(qmul(mq, qexp(d[9], d[10], d[11])));
  // the camera in nav: (qs, pos + d) ∘ (cam_q, cam_p)
  const Quat<T> cnq = qnorm(qmul(qs, cam_q));
  T rp[3], fn[3], f[3];
  rot_fwd(qs, cam_p[0], cam_p[1], cam_p[2], rp[0], rp[1], rp[2]);
  // the feature in nav (marker pose ∘ fp), relative to the camera
  rot_fwd(mqs, fp[0], fp[1], fp[2], fn[0], fn[1], fn[2]);
  T rel[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rel[i] = ((mpos[i] + d[6 + i]) + fn[i]) - ((pos[i] + d[i]) + rp[i]);
  rot_inv(cnq, rel[0], rel[1], rel[2], f[0], f[1], f[2]);
  const T n2 = f[0] * f[0] + f[1] * f[1] + f[2] * f[2];
  const T inv = T(1) / d_sqrt(d_max(n2, d_tiny(T(0))));
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = inv * f[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pose_markers_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ mk,
                    const T* __restrict__ z, const T* __restrict__ r, const T* __restrict__ scal, int n_corners,
                    T* __restrict__ cov_out, T* __restrict__ mu_out, T* __restrict__ m2_out,
                    T* __restrict__ nu_out, T* __restrict__ a_s, T* __restrict__ c_s, T* __restrict__ bear_s,
                    T* __restrict__ w_s, long long nb) {
  constexpr int N = kAugN, N0 = kPoseN, S0 = kPoseS, K = kAugSig;
  const long long b = instance_index();
  if (b >= nb) return;
  T* a = a_s + b;
  const T* c = c_s + b;
  T* bear = bear_s + b;
  T* w = w_s + b;
  auto A = [&](int col, int row) -> T& { return a[(static_cast<long long>(col) * N + row) * nb]; };
  auto F = [&](int col, int row) -> T { return c[(static_cast<long long>(col) * N + row) * nb]; };
  auto P = [&](int p, int i) -> T& { return bear[(static_cast<long long>(p) * 3 + i) * nb]; };
  auto W = [&](int i, int k) -> T& { return w[(static_cast<long long>(i) * N + k) * nb]; };

  const T cam_p[3] = {scal[0], scal[1], scal[2]};
  const Quat<T> cam_q{scal[3], scal[4], scal[5], scal[6]};

  // 1. the augmented covariance's valid half: pose block, zero cross block,
  // marker-pose prior
#pragma unroll 1
  for (int col = 0; col < N0; ++col) {
#pragma unroll 1
    for (int row = col; row < N0; ++row) A(col, row) = cov[(static_cast<long long>(col) * N0 + row) * nb + b];
#pragma unroll 1
    for (int row = N0; row < N; ++row) A(col, row) = T(0);
  }
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {
#pragma unroll 1
    for (int j = i; j < 6; ++j) A(N0 + i, N0 + j) = scal[7 + 6 * i + j];
  }
  // the mean: the poses in registers, the flat rows 7..53 in mu_out
  T pos[3] = {mu[b], mu[b + nb], mu[b + 2 * nb]};
  Quat<T> q{mu[b + 3 * nb], mu[b + 4 * nb], mu[b + 5 * nb], mu[b + 6 * nb]};
  T mpos[3] = {mk[b], mk[b + nb], mk[b + 2 * nb]};
  Quat<T> mq{mk[b + 3 * nb], mk[b + 4 * nb], mk[b + 5 * nb], mk[b + 6 * nb]};
#pragma unroll 1
  for (int s = 7; s < S0; ++s) mu_out[b + s * nb] = mu[b + s * nb];

#pragma unroll 1
  for (int cn = 0; cn < n_corners; ++cn) {
    const T fp[3] = {scal[43 + 3 * cn], scal[44 + 3 * cn], scal[45 + 3 * cn]};
    // 2a. the kept equilibrated factor: column j of L at row k is F(j, k)·d_k
    T dvec[N];
    equilibrated_core<T, true>(a, c_s + b, nb, N, dvec, NoEmit());

    // 2b. the bearings of the 119 sigma points: zero, +columns, -columns
#pragma unroll 1
    for (int p = 0; p < K; ++p) {
      const int j = p == 0 ? 0 : (p <= N ? p - 1 : p - 1 - N);
      const T sign = p <= N ? T(1) : T(-1);
      T d[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const int row = i < 6 ? i : N0 + i - 6;
        d[i] = p == 0 ? T(0) : sign * (F(j, row) * dvec[row]);
      }
      T out[3];
      marker_bearing(pos, q, mpos, mq, d, fp, cam_p, cam_q, out);
#pragma unroll
      for (int i = 0; i < 3; ++i) P(p, i) = out[i];
    }

    // 2c. their S² Karcher mean: a fixed MEAN_ITERS iterations seeded at the
    // zero point, the sum over the points in order
    T zm[3] = {P(0, 0), P(0, 1), P(0, 2)};
    const T inv_k = T(1) / T(K);
#pragma unroll 1
    for (int it = 0; it < kPoseMarkerIters; ++it) {
      const S2Basis<T> B = s2_basis(zm);
      T s0 = T(0), s1 = T(0);
#pragma unroll 1
      for (int p = 0; p < K; ++p) {
        const T y[3] = {P(p, 0), P(p, 1), P(p, 2)};
        T d0, d1;
        s2_boxminus(y, zm, B, d0, d1);
        s0 += d0;
        s1 += d1;
      }
      T next[3];
      s2_boxplus(zm, s0 * inv_k, s1 * inv_k, B, next);
#pragma unroll
      for (int i = 0; i < 3; ++i) zm[i] = next[i];
    }

    // 2d. the deviations dZ (kept in the bearings' first two rows), S and
    // the ± differences dZ⁺_j − dZ⁻_j (kept in the + points' rows)
    const S2Basis<T> B = s2_basis(zm);
    T s00 = T(0), s10 = T(0), s11 = T(0);
#pragma unroll 1
    for (int p = 0; p < K; ++p) {
      const T y[3] = {P(p, 0), P(p, 1), P(p, 2)};
      T d0, d1;
      s2_boxminus(y, zm, B, d0, d1);
      s00 += d0 * d0;
      s10 += d1 * d0;
      s11 += d1 * d1;
      P(p, 0) = d0;
      P(p, 1) = d1;
    }
#pragma unroll 1
    for (int j = 0; j < N; ++j) {
      P(1 + j, 0) -= P(1 + N + j, 0);
      P(1 + j, 1) -= P(1 + N + j, 1);
    }
    // C(a, k) = ½·d_k·Σ_{j <= k} L~(k, j)·(dZ⁺_j − dZ⁻_j)[a]
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      T acc0 = T(0), acc1 = T(0);
#pragma unroll 1
      for (int j = 0; j <= k; ++j) {
        const T l = F(j, k);
        acc0 += l * P(1 + j, 0);
        acc1 += l * P(1 + j, 1);
      }
      W(0, k) = T(0.5) * dvec[k] * acc0;
      W(1, k) = T(0.5) * dvec[k] * acc1;
    }

    // 2e. the innovation, S + R, the 2x2 gain (every corner accepted)
    const long long zc = static_cast<long long>(cn) * 3 * nb + b;
    const T zv[3] = {z[zc], z[zc + nb], z[zc + 2 * nb]};
    T nu0, nu1;
    s2_boxminus(zv, zm, B, nu0, nu1);
    const long long rc = static_cast<long long>(cn) * 4 * nb + b;
    s00 = T(0.5) * s00 + r[rc];
    s10 = T(0.5) * s10 + r[rc + 2 * nb];
    s11 = T(0.5) * s11 + r[rc + 3 * nb];
    const T l00 = d_sqrt(s00);
    const T i00 = T(1) / l00;
    const T l10 = s10 * i00;
    const T i11 = T(1) / d_sqrt(s11 - l10 * l10);
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      const T w0 = W(0, k) * i00;
      W(0, k) = w0;
      W(1, k) = (W(1, k) - l10 * w0) * i11;
    }
    const T y0 = nu0 * i00;
    const T y1 = (nu1 - l10 * y0) * i11;
    m2_out[static_cast<long long>(cn) * nb + b] = y0 * y0 + y1 * y1;
    nu_out[static_cast<long long>(cn) * 2 * nb + b] = nu0;
    nu_out[static_cast<long long>(cn) * 2 * nb + nb + b] = nu1;

    // 2f. the correction W·y: flats, then ⊞ into both quaternions
    auto corr = [&](int k) -> T { return W(0, k) * y0 + W(1, k) * y1; };
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pos[i] += corr(i);
      mpos[i] += corr(N0 + i);
    }
    q = qnorm(qmul(q, qexp(corr(3), corr(4), corr(5))));
    mq = qnorm(qmul(mq, qexp(corr(N0 + 3), corr(N0 + 4), corr(N0 + 5))));
#pragma unroll 1
    for (int k = 6; k < N0; ++k) mu_out[b + (k + 1) * nb] += corr(k);

    // 2g. the downdate of the valid half by W·Wᵀ
#pragma unroll 1
    for (int col = 0; col < N; ++col) {
      const T w0c = W(0, col), w1c = W(1, col);
#pragma unroll 1
      for (int row = col; row < N; ++row) A(col, row) -= w0c * W(0, row) + w1c * W(1, row);
    }
  }

  // 3. marginalize the marker block: the 53x53 valid half and the pose rows
#pragma unroll 1
  for (int col = 0; col < N0; ++col) {
#pragma unroll 1
    for (int row = col; row < N0; ++row) cov_out[(static_cast<long long>(col) * N0 + row) * nb + b] = A(col, row);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) mu_out[b + i * nb] = pos[i];
  mu_out[b + 3 * nb] = q.w;
  mu_out[b + 4 * nb] = q.x;
  mu_out[b + 5 * nb] = q.y;
  mu_out[b + 6 * nb] = q.z;
}

template <typename T>
int launch_pose_markers(const void* cov, const void* mu, const void* mk, const void* z, const void* r,
                        const void* scal, int n_corners, void* cov_out, void* mu_out, void* m2, void* nu, void* a,
                        void* c, void* bear, void* w, long long nb, void* stream) {
  if (n_corners < 1) return static_cast<int>(cudaErrorInvalidValue);
  pose_markers_kernel<T><<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(mk), static_cast<const T*>(z),
      static_cast<const T*>(r), static_cast<const T*>(scal), n_corners, static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), static_cast<T*>(m2), static_cast<T*>(nu), static_cast<T*>(a), static_cast<T*>(c),
      static_cast<T*>(bear), static_cast<T*>(w), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_MARKERS_ENTRY(NAME, T)                                                                      \
  extern "C" int NAME(const void* cov, const void* mu, const void* mk, const void* z, const void* r,          \
                      const void* scal, int n_corners, void* cov_out, void* mu_out, void* m2, void* nu,       \
                      void* a, void* c, void* bear, void* w, long long nb, void* stream) {                    \
    return slam::launch_pose_markers<T>(cov, mu, mk, z, r, scal, n_corners, cov_out, mu_out, m2, nu, a, c,    \
                                        bear, w, nb, stream);                                                 \
  }

SLAM_POSE_MARKERS_ENTRY(slam_pose_markers_f32, float)
SLAM_POSE_MARKERS_ENTRY(slam_pose_markers_f64, double)
