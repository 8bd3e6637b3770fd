// Shared device code of the kernels: typed math and the quaternion helpers.
//
// Layout: every per-instance array is bank-last, (..., nb). A one-thread
// kernel (K6, K7, K9, K10) gives each instance a thread, offsets its base
// pointers by its instance b, and element i of its own array is then
// p[i * nb]: neighbouring threads touch neighbouring addresses, so every load
// and store of a warp is coalesced. Matrices are (col, row, nb): entry (c, r)
// of instance b is at p[(c * n + r) * nb + b]. The warp kernels give each
// instance a warp (warp_factor.cuh).
#pragma once

#include <cuda_runtime.h>

namespace slam {

constexpr int kThreads = 128;  // threads per block (instances per block)
constexpr int kMaxN = 64;      // largest matrix the warp factor takes (two rows a lane)
constexpr int kPoseN = 53;     // PoseUKF tangent dimension
constexpr int kPoseS = 54;     // PoseUKF storage rows
constexpr int kPoseSig = 107;  // 2·53 + 1 sigma points

inline unsigned blocks_for(long long nb) {
  return static_cast<unsigned>((nb + kThreads - 1) / kThreads);
}

__device__ __forceinline__ long long instance_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// ---- float / double overloads of the math the kernels use ----------------
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double d_rsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float d_sin(float x) { return sinf(x); }
__device__ __forceinline__ double d_sin(double x) { return sin(x); }
__device__ __forceinline__ float d_cos(float x) { return cosf(x); }
__device__ __forceinline__ double d_cos(double x) { return cos(x); }
__device__ __forceinline__ float d_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double d_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }
__device__ __forceinline__ float d_tiny(float) { return 1.17549435e-38f; }  // FLT_MIN
__device__ __forceinline__ double d_tiny(double) { return 2.2250738585072014e-308; }  // DBL_MIN
__device__ __forceinline__ float d_nan(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ double d_nan(double) { return __longlong_as_double(0x7ff8000000000000LL); }

// rounding spelled out where a kernel must fuse (or not) as another build did
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T d_max(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T d_clamp(T x, T lo, T hi) { return x < lo ? lo : (x > hi ? hi : x); }

// ---- quaternions [w, x, y, z] ---------------------------------------------
template <typename T>
struct Quat {
  T w, x, y, z;
};

template <typename T>
__device__ __forceinline__ Quat<T> qmul(const Quat<T>& a, const Quat<T>& b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

template <typename T>
__device__ __forceinline__ Quat<T> qconj(const Quat<T>& a) {
  return {a.w, -a.x, -a.y, -a.z};
}

// rotation vector -> quaternion (MTK half-angle convention, Taylor-guarded),
// given the squared angle theta2 = |v|² (qexp_sq; for a caller that rounds
// it its own way) or making it (qexp)
template <typename T>
__device__ __forceinline__ Quat<T> qexp_sq(T theta2, T vx, T vy, T vz) {
  const T theta = d_sqrt(theta2);
  const bool small = theta2 < T(1e-12);
  const T safe = small ? T(1) : theta;
  const T sinc = small ? T(0.5) - theta2 / T(48) : d_sin(T(0.5) * safe) / safe;
  return {d_cos(T(0.5) * theta), sinc * vx, sinc * vy, sinc * vz};
}

template <typename T>
__device__ __forceinline__ Quat<T> qexp(T vx, T vy, T vz) {
  return qexp_sq(vx * vx + vy * vy + vz * vz, vx, vy, vz);
}

// quaternion -> rotation vector (hemisphere w >= 0, Taylor-guarded), as
// scale·(qx, qy, qz): qlog_parts stops before the three products, for a
// caller that fuses each into a sum (K2's Karcher mean)
template <typename T>
__device__ __forceinline__ void qlog_parts(Quat<T> q, T& scale, T& qx, T& qy, T& qz) {
  if (q.w < T(0)) {
    q.w = -q.w; q.x = -q.x; q.y = -q.y; q.z = -q.z;
  }
  const T w = d_clamp(q.w, T(-1), T(1));
  const T n2 = q.x * q.x + q.y * q.y + q.z * q.z;
  const T n = d_sqrt(n2);
  const T theta = T(2) * d_atan2(n, w);
  const bool small = n2 < T(1e-24);
  const T safe_n = small ? T(1) : n;
  scale = small ? T(2) / d_max(w, T(1e-6)) : theta / safe_n;
  qx = q.x; qy = q.y; qz = q.z;
}

template <typename T>
__device__ __forceinline__ void qlog(const Quat<T>& q, T& rx, T& ry, T& rz) {
  T scale, qx, qy, qz;
  qlog_parts(q, scale, qx, qy, qz);
  rx = scale * qx; ry = scale * qy; rz = scale * qz;
}

template <typename T>
__device__ __forceinline__ Quat<T> qnorm(const Quat<T>& q) {
  const T inv = d_rsqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  return {q.w * inv, q.x * inv, q.y * inv, q.z * inv};
}

// R(q)^-1 v and R(q) v, componentwise Rodrigues
template <typename T>
__device__ __forceinline__ void rot_inv(const Quat<T>& q, T vx, T vy, T vz, T& ox, T& oy, T& oz) {
  const T tx = T(2) * (q.z * vy - q.y * vz);
  const T ty = T(2) * (q.x * vz - q.z * vx);
  const T tz = T(2) * (q.y * vx - q.x * vy);
  ox = vx + q.w * tx + (q.z * ty - q.y * tz);
  oy = vy + q.w * ty + (q.x * tz - q.z * tx);
  oz = vz + q.w * tz + (q.y * tx - q.x * ty);
}

template <typename T>
__device__ __forceinline__ void rot_fwd(const Quat<T>& q, T vx, T vy, T vz, T& ox, T& oy, T& oz) {
  const T tx = T(2) * (q.y * vz - q.z * vy);
  const T ty = T(2) * (q.z * vx - q.x * vz);
  const T tz = T(2) * (q.x * vy - q.y * vx);
  ox = vx + q.w * tx + (q.y * tz - q.z * ty);
  oy = vy + q.w * ty + (q.z * tx - q.x * tz);
  oz = vz + q.w * tz + (q.x * ty - q.y * tx);
}

constexpr int kMaxM = 6;  // the largest measurement dimension of K3, K4 and K5

}  // namespace slam
