// The S² (unit sphere) algebra of one thread: the Householder tangent basis,
// the exponential and log maps in it, and the fixed-iteration Karcher mean.
// Every guard constant is the JAX package's (ops/manifolds.py), so the
// kernels agree with the generic path to rounding away from the guards.
//
// Replaces the TPU helpers models/bottom_fused.py::_s2_basis, _s2_boxplus,
// _s2_boxminus and _s2_karcher_mean. Two differences of form: the log map
// calls the native atan2 (the TPU kernel carries a Cephes polynomial because
// Mosaic has no inverse trigonometry), and nothing else changes.
#pragma once

#include "common.cuh"

namespace slam {

template <typename T>
struct S2Basis {
  T b0[3], b1[3];
};

// columns 0 and 1 of the Householder reflection mapping e3 to ±x, the sign
// from the hemisphere (x2 >= 0); the identity's where |v|² < 1e-24
template <typename T>
__device__ __forceinline__ S2Basis<T> s2_basis(const T (&x)[3]) {
  const T sign = x[2] >= T(0) ? T(1) : T(-1);
  const T v0 = sign * x[0], v1 = sign * x[1], v2 = sign * x[2] - T(1);
  const T vv = v0 * v0 + v1 * v1 + v2 * v2;
  S2Basis<T> B;
  if (vv < T(1e-24)) {
    B.b0[0] = T(1); B.b0[1] = T(0); B.b0[2] = T(0);
    B.b1[0] = T(0); B.b1[1] = T(1); B.b1[2] = T(0);
    return B;
  }
  const T s = T(2) / vv;
  B.b0[0] = T(1) - s * v0 * v0; B.b0[1] = -s * v0 * v1; B.b0[2] = -s * v0 * v2;
  B.b1[0] = -s * v1 * v0; B.b1[1] = T(1) - s * v1 * v1; B.b1[2] = -s * v1 * v2;
  return B;
}

// y = x ⊞ (d0, d1): cos|v|·x + sin|v|/|v|·v, v = B·d, renormalized by
// 1/sqrt (not rsqrt: its error would land on the unit vector directly)
template <typename T>
__device__ __forceinline__ void s2_boxplus(const T (&x)[3], T d0, T d1, const S2Basis<T>& B, T (&y)[3]) {
  T v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = B.b0[i] * d0 + B.b1[i] * d1;
  const T t2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const T theta = d_sqrt(t2);
  const bool small = t2 < T(1e-24);
  const T sinc = small ? T(1) - t2 / T(6) : d_sin(theta) / theta;
  const T c = d_cos(theta);
  T w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = c * x[i] + sinc * v[i];
  const T inv = T(1) / d_sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = inv * w[i];
}

// v = θ·u, the tangent vector of y ⊟ x before its projection on the basis:
// θ = atan2(|x × y|, x·y) along the tangential part u of y; where that part
// is < 1e-12, 0 if x·y > 0 and the first basis column times θ (= π) at the
// antipode
template <typename T>
__device__ __forceinline__ void s2_log_vector(const T (&y)[3], const T (&x)[3], const S2Basis<T>& B, T (&v)[3]) {
  const T cx = x[1] * y[2] - x[2] * y[1];
  const T cy = x[2] * y[0] - x[0] * y[2];
  const T cz = x[0] * y[1] - x[1] * y[0];
  const T s = d_sqrt(cx * cx + cy * cy + cz * cz);
  const T d = x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
  const T theta = d_atan2(s, d);
  T t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = y[i] - d * x[i];
  const T tn = d_sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]);
  T u[3];
  if (tn < T(1e-12)) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = d > T(0) ? T(0) : B.b0[i];
  } else {
    const T inv = T(1) / tn;
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = t[i] * inv;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = theta * u[i];
}

// (d0, d1) = y ⊟ x in the basis B at x (s2_log_vector, projected)
template <typename T>
__device__ __forceinline__ void s2_boxminus(const T (&y)[3], const T (&x)[3], const S2Basis<T>& B, T& d0,
                                            T& d1) {
  T v[3];
  s2_log_vector(y, x, B, v);
  d0 = B.b0[0] * v[0] + B.b0[1] * v[1] + B.b0[2] * v[2];
  d1 = B.b1[0] * v[0] + B.b1[1] * v[1] + B.b1[2] * v[2];
}

// equal-weight mean of K points seeded from point 0, a fixed ITERS
// iterations of m ← m ⊞ mean_i(p_i ⊟ m); UNROLL is the unroll factor of the
// loop over the points (all of them by default; 1 keeps a long loop rolled)
template <typename T, int K, int ITERS, int UNROLL = K>
__device__ __forceinline__ void s2_karcher_mean(const T (&pts)[K][3], T (&m)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) m[i] = pts[0][i];
  const T inv_k = T(1) / T(K);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const S2Basis<T> B = s2_basis(m);
    T s0 = T(0), s1 = T(0);
#pragma unroll (UNROLL)
    for (int p = 0; p < K; ++p) {
      T d0, d1;
      s2_boxminus(pts[p], m, B, d0, d1);
      s0 += d0;
      s1 += d1;
    }
    T next[3];
    s2_boxplus(m, s0 * inv_k, s1 * inv_k, B, next);
#pragma unroll
    for (int i = 0; i < 3; ++i) m[i] = next[i];
  }
}

}  // namespace slam
