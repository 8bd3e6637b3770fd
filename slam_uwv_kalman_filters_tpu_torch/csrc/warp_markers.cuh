// The warp-per-instance body of K11, the PoseUKF visual-marker update with the
// 59-DOF state augmentation.
//
// Replaces, one warp per instance, the TPU kernel models/pose_marker_fused.py::
// _make_marker_kernel (launched by _pose_marker_lanes); the reference is
// src/PoseUKF.cpp:613-654 and, for the bearing model, :233-243. Its function
// and its results are those of its first design, one thread per instance,
// bit for bit: every output is made by one lane, in the one-thread body's
// order and with its expressions; the lanes share out independent outputs,
// and every sum over the sigma points runs in ascending order on one lane
// (each lane makes the same sum, so all lanes hold it without a broadcast).
//
// Per corner (a runtime loop, no cap), one warp:
//   1. the augmented covariance's valid half into the factor's lower half,
//      then warp_factor in keep mode with no stop (a failed pivot runs on as
//      NaN, as the one-thread kernel's factor did);
//   2. the bearings of the 119 sigma points, zero, +columns, -columns: lane
//      p % 32 makes whole points, 32 a round, from the 12 tangent rows the
//      bearing model reads (row k of column j is ±L̃(k, j)·d_k);
//   3. their S² Karcher mean, MEAN_ITERS = 4 fixed iterations seeded at the
//      zero point: the lanes make the ⊟ terms, every lane sums them;
//   4. the deviations dZ (over the bearings), S's three sums, then the ±
//      differences dZ⁺_j − dZ⁻_j;
//   5. C(a, k) = ½·d_k·Σ_{j<=k} L̃(k, j)·(dZ⁺_j − dZ⁻_j)[a], one lane per row k
//      (k = lane, then k = 58 − lane);
//   6. ν = z ⊟ mean, S + R, the 2x2 gain on every lane (every corner is
//      accepted, src/PoseUKF.cpp:646-648), W, y, m2 and ν written by lane 0;
//   7. the correction W·y on the flats and ⊞ into both quaternions, one lane
//      per storage row of the 61-row augmented mean;
//   8. the downdate of the augmented covariance's valid half by W·Wᵀ, one
//      entry per lane.
//
// The warp's tile (T units, n = 59):
//   [0, n·ld)         the factor, column-major (warp_factor.cuh), ld = 59;
//                     its strict upper half holds the augmented covariance's
//                     valid half, entry (r, c), r > c, at [r·ld + c]
//   d, dinv           D and D^-1 (n each)
//   adiag             the augmented covariance's diagonal (n)
//   bear              the 119 bearings, bear[p·3 + a]; then dZ in a = 0, 1,
//                     and the + points' rows the ± differences
//   terms             the Karcher terms (2 per point); then C(a, k) at
//                     [a·n + k], then W in place
//   mean              the 54 storage rows, then the marker pose's 7
// 4314 entries: 17.3 KB in float32, 12 warps an SM (34.5 KB and 6 in
// float64). The factor's strict upper half is free in keep mode because the
// bearing stage selects zero there (row < j), as a select and not a branch;
// the first design read explicit zeros. A layout with a packed region of its
// own for the augmented covariance (6025 entries, 9 warps an SM) took 46.7
// ms for 4 corners at bank 131 072 against this one's 36.2 (NVIDIA H100
// 80GB HBM3, 700 W).
#pragma once

#include "s2.cuh"
#include "warp_factor.cuh"

namespace slam {

constexpr int kAugN = kPoseN + 6;        // 59
constexpr int kAugS = kPoseS + 7;        // 61 storage rows of the augmented mean
constexpr int kAugSig = 2 * kAugN + 1;   // 119
constexpr int kPoseMarkerIters = 4;      // MEAN_ITERS of the bearings' mean

struct MarkerTile {
  int ld, d, dinv, adiag, bear, terms, mean, size;
  __host__ __device__ MarkerTile() : ld(warp_ld(kAugN)) {
    d = kAugN * ld;
    dinv = d + kAugN;
    adiag = dinv + kAugN;
    bear = adiag + kAugN;
    terms = bear + 3 * kAugSig;
    mean = terms + 2 * kAugSig;
    size = mean + kAugS;
  }
};

// the augmented covariance's entry (row, c), row >= c, in tile s
template <typename T>
__device__ __forceinline__ T& marker_cov(T* s, const MarkerTile& t, int c, int row) {
  return row == c ? s[t.adiag + c] : s[row * t.ld + c];
}

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

// One warp, one corner of instance b, on its tile s (the augmented
// covariance's valid half and the 61-row mean): stages 1-8 above. fp is the
// corner in the marker frame; z and r point at the corner's bearing (element
// a at z[a·nb]) and tangent covariance (entry (i, k) at r[(2i + k)·nb]) of
// the instance; m2 and nu at its outputs.
template <typename T>
__device__ void warp_marker_corner(T* s, const MarkerTile& t, const T (&fp)[3], const T (&cam_p)[3],
                                   const Quat<T>& cam_q, const T* __restrict__ z, const T* __restrict__ r,
                                   T* __restrict__ m2, T* __restrict__ nu, long long nb) {
  constexpr int N = kAugN, N0 = kPoseN, K = kAugSig;
  const int lane = threadIdx.x % kWarpSize, ld = t.ld;
  T* const d = s + t.d;
  T* const bear = s + t.bear;
  T* const terms = s + t.terms;
  T* const cw = terms;  // C(a, k), then W(a, k), at cw[a·N + k]
  T* const m = s + t.mean;
  auto A = [&](int c, int row) -> T& { return marker_cov(s, t, c, row); };

  // 1. the kept equilibrated factor of the augmented covariance
  for (int c = 0; c < N; ++c)
    for (int row = c + lane; row < N; row += kWarpSize) s[c * ld + row] = A(c, row);
  __syncwarp();
  warp_factor<T, false, false>(s, d, s + t.dinv, N, ld);

  // 2. the bearings of the 119 sigma points, lane p % 32 (factor column j at
  // row k is s[j·ld + k]·d_k for k >= j, and zero above the diagonal)
  {
    const T pos[3] = {m[0], m[1], m[2]};
    const Quat<T> q{m[3], m[4], m[5], m[6]};
    const T mpos[3] = {m[54], m[55], m[56]};
    const Quat<T> mq{m[57], m[58], m[59], m[60]};
    for (int p = lane; p < K; p += kWarpSize) {
      const int j = p == 0 ? 0 : (p <= N ? p - 1 : p - 1 - N);
      const T sign = p <= N ? T(1) : T(-1);
      T dl[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const int row = i < 6 ? i : N0 + i - 6;
        const T f = row >= j ? s[j * ld + row] : T(0);
        dl[i] = p == 0 ? T(0) : sign * (f * d[row]);
      }
      T out[3];
      marker_bearing(pos, q, mpos, mq, dl, fp, cam_p, cam_q, out);
#pragma unroll
      for (int a = 0; a < 3; ++a) bear[p * 3 + a] = out[a];
    }
  }
  __syncwarp();

  // 3. the S² Karcher mean, seeded at the zero point: the lanes make the ⊟
  // terms, every lane sums them in ascending p
  T zm[3] = {bear[0], bear[1], bear[2]};
  const T inv_k = T(1) / T(K);
  for (int it = 0; it < kPoseMarkerIters; ++it) {
    const S2Basis<T> B = s2_basis(zm);
    for (int p = lane; p < K; p += kWarpSize) {
      const T y[3] = {bear[p * 3], bear[p * 3 + 1], bear[p * 3 + 2]};
      s2_boxminus(y, zm, B, terms[2 * p], terms[2 * p + 1]);
    }
    __syncwarp();
    T s0 = T(0), s1 = T(0);
    for (int p = 0; p < K; ++p) {
      s0 += terms[2 * p];
      s1 += terms[2 * p + 1];
    }
    T next[3];
    s2_boxplus(zm, s0 * inv_k, s1 * inv_k, B, next);
#pragma unroll
    for (int a = 0; a < 3; ++a) zm[a] = next[a];
    __syncwarp();  // the terms are read before the next iteration rewrites them
  }

  // 4. the deviations dZ over the bearings, S's sums (every lane, ascending
  // p), then the ± differences in the + points' rows
  const S2Basis<T> B = s2_basis(zm);
  for (int p = lane; p < K; p += kWarpSize) {
    const T y[3] = {bear[p * 3], bear[p * 3 + 1], bear[p * 3 + 2]};
    s2_boxminus(y, zm, B, bear[p * 3], bear[p * 3 + 1]);
  }
  __syncwarp();
  T s00 = T(0), s10 = T(0), s11 = T(0);
  for (int p = 0; p < K; ++p) {
    const T d0 = bear[p * 3], d1 = bear[p * 3 + 1];
    s00 += d0 * d0;
    s10 += d1 * d0;
    s11 += d1 * d1;
  }
  __syncwarp();
  for (int j = lane; j < N; j += kWarpSize) {
    bear[(1 + j) * 3] -= bear[(1 + N + j) * 3];
    bear[(1 + j) * 3 + 1] -= bear[(1 + N + j) * 3 + 1];
  }
  __syncwarp();

  // 5. C(a, k) = ½·d_k·Σ_{j<=k} L̃(k, j)·(dZ⁺_j − dZ⁻_j)[a], one lane per row
  for (int pass = 0; pass < 2; ++pass) {
    const int k = pass == 0 ? lane : N - 1 - lane;
    if (pass == 1 && k < kWarpSize) break;
    T acc0 = T(0), acc1 = T(0);
    for (int j = 0; j <= k; ++j) {
      const T l = s[j * ld + k];
      acc0 += l * bear[(1 + j) * 3];
      acc1 += l * bear[(1 + j) * 3 + 1];
    }
    cw[k] = T(0.5) * d[k] * acc0;
    cw[N + k] = T(0.5) * d[k] * acc1;
  }
  __syncwarp();

  // 6. the innovation, S + R and the 2x2 gain (every lane), W, y, m2
  // ν = z ⊟ mean: the first design's compiler sank the last add of each
  // projection past the gain loop, away from its product, which was then
  // rounded on its own; its PTX: fma(b_0, v_0, b_1·v_1) + b_2·v_2
  const T zv[3] = {z[0], z[nb], z[2 * nb]};
  T v[3];
  s2_log_vector(zv, zm, B, v);
  const T nu0 = add_rn(fma_rn(B.b0[0], v[0], mul_rn(B.b0[1], v[1])), mul_rn(B.b0[2], v[2]));
  const T nu1 = add_rn(fma_rn(B.b1[0], v[0], mul_rn(B.b1[1], v[1])), mul_rn(B.b1[2], v[2]));
  s00 = T(0.5) * s00 + r[0];
  s10 = T(0.5) * s10 + r[2 * nb];
  s11 = T(0.5) * s11 + r[3 * nb];
  const T l00 = d_sqrt(s00);
  const T i00 = T(1) / l00;
  const T l10 = s10 * i00;
  const T i11 = T(1) / d_sqrt(s11 - l10 * l10);
  for (int k = lane; k < N; k += kWarpSize) {
    const T w0 = cw[k] * i00;
    cw[k] = w0;
    cw[N + k] = (cw[N + k] - l10 * w0) * i11;
  }
  const T y0 = nu0 * i00;
  const T y1 = (nu1 - l10 * y0) * i11;
  if (lane == 0) {
    m2[0] = y0 * y0 + y1 * y1;
    nu[0] = nu0;
    nu[nb] = nu1;
  }
  __syncwarp();

  // 7. the correction W·y, one lane per storage row: flats, then ⊞ into the
  // vehicle's (rows 3..6) and the marker's (57..60) quaternion (read
  // everything first, then write)
  auto corr = [&](int k) -> T { return cw[k] * y0 + cw[N + k] * y1; };
  auto updated = [&](int row) -> T {
    if (row >= 3 && row < 7) {
      const Quat<T> qn = qnorm(qmul(Quat<T>{m[3], m[4], m[5], m[6]}, qexp(corr(3), corr(4), corr(5))));
      return row == 3 ? qn.w : row == 4 ? qn.x : row == 5 ? qn.y : qn.z;
    }
    if (row >= 57) {
      const Quat<T> qn =
          qnorm(qmul(Quat<T>{m[57], m[58], m[59], m[60]}, qexp(corr(N0 + 3), corr(N0 + 4), corr(N0 + 5))));
      return row == 57 ? qn.w : row == 58 ? qn.x : row == 59 ? qn.y : qn.z;
    }
    return m[row] + corr(row < 3 ? row : row - 1);
  };
  const int r1 = lane + kWarpSize;
  const T v0 = updated(lane), v1 = r1 < kAugS ? updated(r1) : T(0);
  __syncwarp();
  m[lane] = v0;
  if (r1 < kAugS) m[r1] = v1;

  // 8. the downdate of the valid half by W·Wᵀ
  for (int c = 0; c < N; ++c) {
    const T w0c = cw[c], w1c = cw[N + c];
    for (int row = c + lane; row < N; row += kWarpSize) A(c, row) -= w0c * cw[row] + w1c * cw[N + row];
  }
  __syncwarp();
}

}  // namespace slam
