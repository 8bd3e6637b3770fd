// The SO(3) algebra of one thread, on common.cuh's quaternions: ⊞ and ⊟,
// the fixed-iteration Karcher mean and the rotation matrix. Conjugation and
// rotation of a vector are common.cuh's qconj and rot_fwd (R(q)·v = v +
// w·t + u × t, t = 2·u × v).
//
// Replaces the TPU helpers models/indirect_fused.py::_qconj, _qrot,
// _so3_boxplus, _so3_boxminus, _so3_karcher_mean and _rot_matrix. One
// difference of form: qlog's arctangent is the native atan2 (the TPU kernel
// carries a polynomial).
#pragma once

#include "common.cuh"

namespace slam {

// q ⊗ e renormalized by 1/sqrt (not rsqrt: its error would land on the unit
// quaternion directly)
template <typename T>
__device__ __forceinline__ Quat<T> so3_times(const Quat<T>& q, const Quat<T>& e) {
  const Quat<T> y = qmul(q, e);
  const T inv = T(1) / d_sqrt(y.w * y.w + y.x * y.x + y.y * y.y + y.z * y.z);
  return {inv * y.w, inv * y.x, inv * y.y, inv * y.z};
}

// q ⊞ (scale·d) = q ⊗ Exp(scale·d), renormalized
template <typename T>
__device__ __forceinline__ Quat<T> so3_boxplus(const Quat<T>& q, T dx, T dy, T dz, T scale) {
  return so3_times(q, qexp(dx * scale, dy * scale, dz * scale));
}

// a ⊟ b = Log(b⁻¹ ⊗ a)
template <typename T>
__device__ __forceinline__ void so3_boxminus(const Quat<T>& a, const Quat<T>& b, T& rx, T& ry, T& rz) {
  qlog(qmul(qconj(b), a), rx, ry, rz);
}

// equal-weight mean of K unit quaternions seeded from point 0, a fixed
// ITERS iterations of m ← m ⊞ mean_i(p_i ⊟ m)
template <typename T, int K, int ITERS>
__device__ __forceinline__ Quat<T> so3_karcher_mean(const Quat<T> (&pts)[K]) {
  Quat<T> m = pts[0];
  const T inv_k = T(1) / T(K);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    T sx = T(0), sy = T(0), sz = T(0);
#pragma unroll
    for (int p = 0; p < K; ++p) {
      T rx, ry, rz;
      so3_boxminus(pts[p], m, rx, ry, rz);
      sx += rx;
      sy += ry;
      sz += rz;
    }
    m = so3_boxplus(m, sx * inv_k, sy * inv_k, sz * inv_k, T(1));
  }
  return m;
}

// the rotation matrix of a unit quaternion
template <typename T>
__device__ __forceinline__ void rot_matrix(const Quat<T>& q, T (&R)[3][3]) {
  const T w = q.w, x = q.x, y = q.y, z = q.z;
  R[0][0] = T(1) - T(2) * (y * y + z * z);
  R[0][1] = T(2) * (x * y - w * z);
  R[0][2] = T(2) * (x * z + w * y);
  R[1][0] = T(2) * (x * y + w * z);
  R[1][1] = T(1) - T(2) * (x * x + z * z);
  R[1][2] = T(2) * (y * z - w * x);
  R[2][0] = T(2) * (x * z - w * y);
  R[2][1] = T(2) * (y * z + w * x);
  R[2][2] = T(1) - T(2) * (x * x + y * y);
}

}  // namespace slam
