// Shared device code of the PoseUKF kernels: typed math, the quaternion
// helpers, the one-thread equilibrated Cholesky core (K11) and the update
// tail of K4.
//
// Layout: every per-instance array is bank-last, (..., nb), one thread per
// instance. A thread offsets its base pointers by its instance b, and element
// i of its own array is then p[i * nb]: neighbouring threads touch
// neighbouring addresses, so every load and store of a warp is coalesced.
// Matrices are (col, row, nb): entry (c, r) of instance b is at
// p[(c * n + r) * nb + b].
#pragma once

#include <cuda_runtime.h>

namespace slam {

constexpr int kThreads = 128;  // threads per block (instances per block)
constexpr int kMaxN = 64;      // largest matrix the core takes (local arrays)
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

// rotation vector -> quaternion (MTK half-angle convention, Taylor-guarded)
template <typename T>
__device__ __forceinline__ Quat<T> qexp(T vx, T vy, T vz) {
  const T theta2 = vx * vx + vy * vy + vz * vz;
  const T theta = d_sqrt(theta2);
  const bool small = theta2 < T(1e-12);
  const T safe = small ? T(1) : theta;
  const T sinc = small ? T(0.5) - theta2 / T(48) : d_sin(T(0.5) * safe) / safe;
  return {d_cos(T(0.5) * theta), sinc * vx, sinc * vy, sinc * vz};
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

// ---- the equilibrated Cholesky core ---------------------------------------
// Replaces the TPU core ops/kernels.py::equilibrated_sigma_columns for K11
// (pose_markers.cu). K1, K2, K3, K5, K8 and K12 run the same function one
// warp per matrix in shared memory (warp_factor.cuh).
//
// One thread factors one instance: L = D·chol(D^-1·A·D^-1), D = sqrt(max(diag
// A, tiny)). `a` is the instance's (n, n) input in (col, row) order and only
// its lower half (row >= col) is read, so a half-valid lanes covariance is
// fine. `s` is (n, n) scratch, `dvec` receives D. Right-looking: column j is
// finalized (scaled by 1/pivot), then the trailing columns k > j are
// downdated over rows >= k. After column j is final, emit(j, pivot) is called;
// rows > j of column j then hold the below-vector in `s`.
//
// KEEP = true leaves the finalized equilibrated factor in `s`: explicit zeros
// above the diagonal, the pivot on it, the below-vector under it, so the
// factor column j is s(j, r) · dvec[r]. The downdates read a prior column
// only strictly below its diagonal, so writing the head is safe.
//
// The TPU version blocks the downdates in rank-16 panels for its vector unit;
// this one applies them column by column (equal up to rounding).
template <typename T, bool KEEP, typename Emit>
__device__ void equilibrated_core(const T* a, T* s, long long nb, int n, T* dvec, Emit emit) {
  T dinv[kMaxN];
  for (int j = 0; j < n; ++j) {
    dvec[j] = d_sqrt(d_max(a[(static_cast<long long>(j) * n + j) * nb], d_tiny(T(0))));
    dinv[j] = T(1) / dvec[j];
  }
  for (int c = 0; c < n; ++c) {
    for (int r = c; r < n; ++r) {
      const long long e = (static_cast<long long>(c) * n + r) * nb;
      s[e] = a[e] * (dinv[c] * dinv[r]);
    }
  }
  for (int j = 0; j < n; ++j) {
    const long long cj = static_cast<long long>(j) * n;
    const T piv = d_sqrt(s[(cj + j) * nb]);
    const T inv = T(1) / piv;
    for (int r = j + 1; r < n; ++r) s[(cj + r) * nb] *= inv;
    if (KEEP) {
      for (int r = 0; r < j; ++r) s[(cj + r) * nb] = T(0);
      s[(cj + j) * nb] = piv;
    }
    emit(j, piv);
    for (int k = j + 1; k < n; ++k) {
      const T lkj = s[(cj + k) * nb];
      const long long ck = static_cast<long long>(k) * n;
      for (int r = k; r < n; ++r) s[(ck + r) * nb] -= lkj * s[(cj + r) * nb];
    }
  }
}

struct NoEmit {
  template <typename T>
  __device__ void operator()(int, T) const {}
};

// ---- the update tail of K4 (and of K3's and K5's first designs) -------------
// Replaces the TPU tail models/pose_update_fused.py::_update_tail_from_sc.
//
// From the innovation covariance S (M x M, registers), the cross-covariance C
// (accessor C(i, k) -> T&, rows i < M of a bank-last (M, 53) scratch; C is
// overwritten by W in place), the innovation nu and the prior mean m (storage
// rows), per instance: the M x M Cholesky of S, W = C·L^-T by ascending
// forward substitution, y = L^-1·nu, m2 = |y|², the gate as a select (a
// threshold < 0 accepts any; a NaN S leaves the instance bit-identical to its
// prior), the correction μ ⊞ W·y (flats plus the quaternion) and the
// downdate cov − W·Wᵀ on the valid half (row >= col). `a` is the instance's
// prior covariance (already offset by b); the outputs are offset here.
constexpr int kMaxM = 6;

template <typename T, typename CAcc>
__device__ __forceinline__ void update_tail(int M, T (&Sm)[kMaxM][kMaxM], CAcc C, const T* nu,
                                            const T* m, T thr, const T* a, T* cov_out, T* mu_out,
                                            T* m2_out, T* acc_out, long long b, long long nb) {
  constexpr int N = kPoseN, S = kPoseS;
  T L[kMaxM][kMaxM], inv_diag[kMaxM], y[kMaxM];
  for (int j = 0; j < M; ++j) {
    T s = Sm[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = d_sqrt(s);
    const T inv = T(1) / L[j][j];
    for (int i = j + 1; i < M; ++i) {
      T t = Sm[i][j];
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
  for (int i = 0; i < M; ++i) inv_diag[i] = T(1) / L[i][i];
  for (int i = 0; i < M; ++i) {
    for (int k = 0; k < N; ++k) {
      T t = C(i, k);
      for (int kk = 0; kk < i; ++kk) t -= L[i][kk] * C(kk, k);
      C(i, k) = t * inv_diag[i];
    }
    T u = nu[i];
    for (int kk = 0; kk < i; ++kk) u -= L[i][kk] * y[kk];
    y[i] = u * inv_diag[i];
  }
  T m2 = T(0);
  for (int i = 0; i < M; ++i) m2 += y[i] * y[i];
  const bool accept = (m2 <= thr) || (thr < T(0));
  m2_out[b] = m2;
  acc_out[b] = accept ? T(1) : T(0);

  T corr[N];
  for (int k = 0; k < N; ++k) {
    T t = T(0);
    for (int i = 0; i < M; ++i) t += C(i, k) * y[i];
    corr[k] = t;
  }
  const Quat<T> qn = qnorm(qmul(Quat<T>{m[3], m[4], m[5], m[6]}, qexp(corr[3], corr[4], corr[5])));
  for (int s = 0; s < 3; ++s) mu_out[b + s * nb] = accept ? m[s] + corr[s] : m[s];
  mu_out[b + 3 * nb] = accept ? qn.w : m[3];
  mu_out[b + 4 * nb] = accept ? qn.x : m[4];
  mu_out[b + 5 * nb] = accept ? qn.y : m[5];
  mu_out[b + 6 * nb] = accept ? qn.z : m[6];
  for (int s = 7; s < S; ++s) mu_out[b + s * nb] = accept ? m[s] + corr[s - 1] : m[s];

  T* co = cov_out + b;
  for (int cc = 0; cc < N; ++cc) {
    for (int r = cc; r < N; ++r) {
      const long long e = (static_cast<long long>(cc) * N + r) * nb;
      const T prior = a[e];
      if (accept) {
        T t = T(0);
        for (int i = 0; i < M; ++i) t += C(i, cc) * C(i, r);
        co[e] = prior - t;
      } else {
        co[e] = prior;
      }
    }
  }
}

}  // namespace slam
