// Device code shared by the small-filter whole-step kernels, K6 (VelocityUKF,
// 4 DOF) and K7 (BottomUKF, 3 DOF): the unrolled Cholesky–Crout factor, the
// two substitutions, and the Kalman tail of a measurement update. Everything
// is a fixed-size register array of one thread's instance.
//
// Replaces the TPU helpers models/velocity_fused.py::_draw_deltas (the Crout
// factor) and ::_kalman_tail, which the JAX BottomUKF kernel imports too.
#pragma once

#include "common.cuh"

namespace slam {

// Cholesky–Crout of an M x M grid (lower half used)
template <typename T, int M>
__device__ __forceinline__ void crout(const T (&A)[M][M], T (&L)[M][M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = d_sqrt(s);
    const T inv = T(1) / L[j][j];
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      T t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
}

// x = (L·Lᵀ)⁻¹ rhs
template <typename T, int M>
__device__ __forceinline__ void solve_chol(const T (&L)[M][M], const T (&inv_d)[M], const T (&rhs)[M],
                                           T (&x)[M]) {
  T y[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T t = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t -= L[i][k] * y[k];
    y[i] = t * inv_d[i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) t -= L[k][i] * x[k];
    x[i] = t * inv_d[i];
  }
}

// The Kalman tail of one update of a D-DOF state with an M-dimensional
// measurement: from the innovation covariance S (lower half read), the
// cross-covariance C (D x M) and the innovation nu, the M x M Crout factor
// L_S of S, the NIS m2 = νᵀS⁻¹ν, the gain rows K_i = S⁻¹C_i, the correction
// corr = K·ν and, where the gate accepts (a threshold < 0 accepts any; a NaN
// S rejects), the exactly symmetric downdate P − (K·L_S)(K·L_S)ᵀ of both
// halves of P. Returns whether the gate accepts; the caller applies corr to
// the mean only then, so a rejected instance keeps its prior bit for bit.
template <typename T, int D, int M>
__device__ __forceinline__ bool kalman_tail(T (&P)[D][D], const T (&S)[M][M], const T (&C)[D][M],
                                            const T (&nu)[M], T thr, T (&corr)[D], T& m2) {
  T Ls[M][M], inv_d[M], q[M];
  crout<T, M>(S, Ls);
#pragma unroll
  for (int a = 0; a < M; ++a) inv_d[a] = T(1) / Ls[a][a];
  solve_chol<T, M>(Ls, inv_d, nu, q);
  m2 = T(0);
#pragma unroll
  for (int a = 0; a < M; ++a) m2 += nu[a] * q[a];
  const bool accept = (thr < T(0)) || (m2 <= thr);
  T K[D][M], W[D][M];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    solve_chol<T, M>(Ls, inv_d, C[i], K[i]);
    T t = T(0);
#pragma unroll
    for (int a = 0; a < M; ++a) t += K[i][a] * nu[a];
    corr[i] = t;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T w = T(0);
#pragma unroll
      for (int c = a; c < M; ++c) w += K[i][c] * Ls[c][a];
      W[i][a] = w;
    }
  }
  if (accept) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T t = T(0);
#pragma unroll
        for (int a = 0; a < M; ++a) t += W[i][a] * W[j][a];
        P[i][j] = P[j][i] = P[i][j] - t;
      }
    }
  }
  return accept;
}

}  // namespace slam
