// K6 · the whole VelocityUKF step in one launch: (optional) predict through
// the Fossen forward dynamics + a chain of linear DVL / pressure updates.
//
// Replaces the TPU kernel models/velocity_fused.py::_make_step_kernel
// (launched by _velocity_step_lanes). Per instance, one thread, everything in
// registers (the state is 4 DOF; ~350 bytes per instance move):
//   1. predict (DO_PREDICT): the 4x4 Cholesky–Crout factor of P, the 9 ukfom
//      sigma points (row 0 the mean, rows 2j+1 / 2j+2 the ±j-th factor
//      column) and the orientation tracker as a tenth row, each pushed
//      through one explicit-Euler step of the 6-DOF Fossen dynamics
//      ν̇ = M⁻¹(τ − C(ν)ν − D_lin·ν − D_quad·(|ν|∘ν) − g(q)) read from the
//      165-scalar parameter block (staged in shared memory once per block);
//      the depth of each sigma point integrates the rotated new velocity;
//      the mean and the deviations of the 9 points are taken about the zero
//      sigma point (Y_0 + Σ(Y_i − Y_0)/9), every point summed on its own;
//      P = ½ΣdYdYᵀ + dt·Q; the tracker takes the full kinematic step
//      (position by the rotated new velocity, orientation by qexp of the new
//      rate) with common.cuh's qexp / qmul / qnorm;
//   2. each update of the chain observes state rows directly (DVL rows 0..2,
//      pressure row 3), so the ukfom sigma-point update reduces exactly to
//      S = H·P·Hᵀ + R, C = P·Hᵀ: the m x m Crout factor of S, the NIS νᵀS⁻¹ν,
//      the gain K = C·S⁻¹, the gate as a select (a threshold < 0 accepts any;
//      a NaN S leaves the instance's prior), the correction μ + K·ν and the
//      exactly symmetric downdate P − (K·L_S)(K·L_S)ᵀ.
//
// Bound on Hopper: latency. Each instance reads ~31 and writes ~21 values
// (4x4 cov, mean, efforts, gyro, tracker), ~200 bytes in float32 at 3.35 TB/s,
// against ~3k dependent operations in one thread; a launch at bank 65 536 is
// 512 blocks on 132 SMs. This first version keeps one thread per instance.
//
// Operands (bank-last): cov (4, 4, nb) (col, row), mu (4, nb), eff (6, nb),
// av (3, nb), trk (13, nb) [pos 3, quat wxyz 4, lin vel 3, ang vel 3], scal
// (165) [dt; M ×36; M⁻¹ ×36; D_lin ×36; D_quad ×36; B − W; B·cob − W·cog ×3;
// dt·Q ×16], all row-major; per update k: z_k (m_k, nb), R_k (m_k, m_k, nb),
// the threshold by value. Outputs: cov_out (4, 4, nb) both halves, mu_out
// (4, nb), trk_out (13, nb); per update m2_k (nb), acc_k (nb) as 1/0, nu_k
// (m_k, nb). The chain is a by-value VelChain of at most kVelMaxSteps updates.

#include "common.cuh"

namespace slam {

constexpr int kVelDof = 4;
constexpr int kVelSig = 2 * kVelDof + 1;  // 9
constexpr int kVelTrk = 13;
constexpr int kVelNScal = 165;
constexpr int kVelMaxSteps = 8;
// parameter-block offsets
constexpr int kVDt = 0, kVM = 1, kVMi = 37, kVDl = 73, kVDq = 109, kVBw = 145, kVRv = 146,
              kVQ = 149;

enum VelModel : int { kVelDvl = 0, kVelPressure = 1 };

template <typename T>
struct VelChain {
  int n;
  int model[kVelMaxSteps];
  T thr[kVelMaxSteps];
  const T* z[kVelMaxSteps];
  const T* r[kVelMaxSteps];
  T* m2[kVelMaxSteps];
  T* acc[kVelMaxSteps];
  T* nu[kVelMaxSteps];
};

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

// One linear update observing rows ROW0 .. ROW0 + M − 1 of the state.
template <typename T, int M, int ROW0>
__device__ __forceinline__ void linear_update(T (&P)[kVelDof][kVelDof], T (&mu)[kVelDof],
                                              const T* z, const T* rmat, T thr, T* m2_out,
                                              T* acc_out, T* nu_out, long long b, long long nb) {
  T S[M][M], Ls[M][M], inv_d[M], nu[M], q[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int c = 0; c < M; ++c)
      S[a][c] = P[ROW0 + a][ROW0 + c] + rmat[b + (static_cast<long long>(a) * M + c) * nb];
    nu[a] = z[b + a * nb] - mu[ROW0 + a];
    nu_out[b + a * nb] = nu[a];
  }
  crout<T, M>(S, Ls);
#pragma unroll
  for (int a = 0; a < M; ++a) inv_d[a] = T(1) / Ls[a][a];
  solve_chol<T, M>(Ls, inv_d, nu, q);
  T m2 = T(0);
#pragma unroll
  for (int a = 0; a < M; ++a) m2 += nu[a] * q[a];
  const bool accept = (thr < T(0)) || (m2 <= thr);
  m2_out[b] = m2;
  acc_out[b] = accept ? T(1) : T(0);
  T K[kVelDof][M], W[kVelDof][M], corr[kVelDof];
#pragma unroll
  for (int i = 0; i < kVelDof; ++i) {
    T ci[M];
#pragma unroll
    for (int a = 0; a < M; ++a) ci[a] = P[i][ROW0 + a];
    solve_chol<T, M>(Ls, inv_d, ci, K[i]);
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
    for (int i = 0; i < kVelDof; ++i) {
      mu[i] += corr[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T t = T(0);
#pragma unroll
        for (int a = 0; a < M; ++a) t += W[i][a] * W[j][a];
        P[i][j] = P[j][i] = P[i][j] - t;
      }
    }
  }
}

template <typename T, bool DO_PREDICT>
__global__ void __launch_bounds__(kThreads)
velocity_step_kernel(const T* __restrict__ cov, const T* __restrict__ mu_in,
                     const T* __restrict__ eff, const T* __restrict__ av,
                     const T* __restrict__ trk, const T* __restrict__ scal, const VelChain<T> chain,
                     T* __restrict__ cov_out, T* __restrict__ mu_out, T* __restrict__ trk_out,
                     long long nb) {
  constexpr int D = kVelDof, K = kVelSig;
  __shared__ T s[kVelNScal];
  if (DO_PREDICT) {
    for (int i = threadIdx.x; i < kVelNScal; i += blockDim.x) s[i] = scal[i];
    __syncthreads();
  }
  const long long b = instance_index();
  if (b >= nb) return;

  T P[D][D], mu[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    mu[i] = mu_in[b + i * nb];
#pragma unroll
    for (int j = 0; j <= i; ++j) P[i][j] = P[j][i] = cov[b + (static_cast<long long>(j) * D + i) * nb];
  }
  T tk[kVelTrk];
#pragma unroll
  for (int i = 0; i < kVelTrk; ++i) tk[i] = trk[b + i * nb];

  if constexpr (DO_PREDICT) {
    const T dt = s[kVDt];
    // sigma deltas: point 0 zero, points 2j+1 / 2j+2 the ±j-th factor column
    T L[D][D];
    crout<T, D>(P, L);
    auto delta = [&](int row, int pt) -> T {
      if (pt == 0) return T(0);
      const int j = (pt - 1) / 2;
      const T v = j <= row ? L[row][j] : T(0);
      return (pt & 1) ? v : -v;
    };
    // third row of R(q) of the tracker: up_body = Rᵀe_z and the depth rate
    // (R·v)_z read exactly these three numbers
    const T qw = tk[3], qx = tk[4], qy = tk[5], qz = tk[6];
    const T r2[3] = {T(2) * (qx * qz - qw * qy), T(2) * (qy * qz + qw * qx),
                     T(1) - T(2) * (qx * qx + qy * qy)};
    // restoring term g(q) = −[(B−W)·up; (B·cob − W·cog) × up]
    const T rv[3] = {s[kVRv], s[kVRv + 1], s[kVRv + 2]};
    const T bw = s[kVBw];
    const T g6[6] = {-(bw * r2[0]), -(bw * r2[1]), -(bw * r2[2]),
                     -(rv[1] * r2[2] - rv[2] * r2[1]), -(rv[2] * r2[0] - rv[0] * r2[2]),
                     -(rv[0] * r2[1] - rv[1] * r2[0])};
    T tau[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) tau[i] = eff[b + i * nb];
    const T w_in[3] = {av[b], av[b + nb], av[b + 2 * nb]};

    // one Fossen step of a 6-DOF velocity; returns the new 6-DOF velocity
    auto fossen = [&](const T (&nu)[6], T (&out)[6]) {
      T p6[6], anu[6], rhs[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        T t = T(0);
#pragma unroll
        for (int j = 0; j < 6; ++j) t += s[kVM + 6 * i + j] * nu[j];
        p6[i] = t;
        anu[i] = d_abs(nu[i]) * nu[i];
      }
      // C(ν)ν = [ω × p1; ω × p2 + v × p1]
      const T cor[6] = {nu[4] * p6[2] - nu[5] * p6[1], nu[5] * p6[0] - nu[3] * p6[2],
                        nu[3] * p6[1] - nu[4] * p6[0],
                        (nu[4] * p6[5] - nu[5] * p6[4]) + (nu[1] * p6[2] - nu[2] * p6[1]),
                        (nu[5] * p6[3] - nu[3] * p6[5]) + (nu[2] * p6[0] - nu[0] * p6[2]),
                        (nu[3] * p6[4] - nu[4] * p6[3]) + (nu[0] * p6[1] - nu[1] * p6[0])};
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        T dmp = T(0);
#pragma unroll
        for (int j = 0; j < 6; ++j) dmp += s[kVDl + 6 * i + j] * nu[j] + s[kVDq + 6 * i + j] * anu[j];
        rhs[i] = tau[i] - cor[i] - dmp - g6[i];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < 6; ++j) a += s[kVMi + 6 * i + j] * rhs[j];
        out[i] = nu[i] + dt * a;
      }
    };

    // the 9 sigma points: new velocity and depth
    T Y[K][D];
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const T nu6[6] = {mu[0] + delta(0, p), mu[1] + delta(1, p), mu[2] + delta(2, p),
                        w_in[0], w_in[1], w_in[2]};
      T nv[6];
      fossen(nu6, nv);
      Y[p][0] = nv[0];
      Y[p][1] = nv[1];
      Y[p][2] = nv[2];
      Y[p][3] = (mu[3] + delta(3, p)) + dt * (r2[0] * nv[0] + r2[1] * nv[1] + r2[2] * nv[2]);
    }
    // mean and deviations about the zero point, then ½ΣdYdYᵀ + dt·Q
    const T inv_n = T(1) / T(K);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const T y0 = Y[0][i];
      T acc = T(0);
#pragma unroll
      for (int p = 1; p < K; ++p) acc += Y[p][i] - y0;
      const T dbar = acc * inv_n;
      mu[i] = y0 + dbar;
#pragma unroll
      for (int p = 0; p < K; ++p) Y[p][i] = (Y[p][i] - y0) - dbar;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T acc = T(0);
#pragma unroll
        for (int p = 0; p < K; ++p) acc += Y[p][i] * Y[p][j];
        P[i][j] = P[j][i] = T(0.5) * acc + s[kVQ + 4 * i + j];
      }
    }

    // the tracker: its own velocity through the dynamics, then the pose
    const T tnu[6] = {tk[7], tk[8], tk[9], tk[10], tk[11], tk[12]};
    T tn[6];
    fossen(tnu, tn);
    const T u[3] = {qx, qy, qz};
    const T t2[3] = {T(2) * (u[1] * tn[2] - u[2] * tn[1]), T(2) * (u[2] * tn[0] - u[0] * tn[2]),
                     T(2) * (u[0] * tn[1] - u[1] * tn[0])};
    const T rot[3] = {tn[0] + qw * t2[0] + (u[1] * t2[2] - u[2] * t2[1]),
                      tn[1] + qw * t2[1] + (u[2] * t2[0] - u[0] * t2[2]),
                      tn[2] + qw * t2[2] + (u[0] * t2[1] - u[1] * t2[0])};
    const Quat<T> qn = qnorm(qmul(Quat<T>{qw, qx, qy, qz}, qexp(tn[3] * dt, tn[4] * dt, tn[5] * dt)));
    tk[0] += dt * rot[0];
    tk[1] += dt * rot[1];
    tk[2] += dt * rot[2];
    tk[3] = qn.w; tk[4] = qn.x; tk[5] = qn.y; tk[6] = qn.z;
#pragma unroll
    for (int i = 0; i < 6; ++i) tk[7 + i] = tn[i];
  }

  // the measurement chain
  for (int k = 0; k < chain.n; ++k) {
    if (chain.model[k] == kVelDvl)
      linear_update<T, 3, 0>(P, mu, chain.z[k], chain.r[k], chain.thr[k], chain.m2[k], chain.acc[k],
                             chain.nu[k], b, nb);
    else
      linear_update<T, 1, 3>(P, mu, chain.z[k], chain.r[k], chain.thr[k], chain.m2[k], chain.acc[k],
                             chain.nu[k], b, nb);
  }

#pragma unroll
  for (int i = 0; i < D; ++i) {
    mu_out[b + i * nb] = mu[i];
#pragma unroll
    for (int j = 0; j < D; ++j) cov_out[b + (static_cast<long long>(j) * D + i) * nb] = P[i][j];
  }
#pragma unroll
  for (int i = 0; i < kVelTrk; ++i) trk_out[b + i * nb] = tk[i];
}

template <typename T>
int launch_velocity_step(int do_predict, const void* cov, const void* mu, const void* eff,
                         const void* av, const void* trk, const void* scal, int n_upd,
                         const int* models, const void* const* z, const void* const* r,
                         const double* thr, void* const* m2, void* const* acc, void* const* nu,
                         void* cov_out, void* mu_out, void* trk_out, long long nb, void* stream) {
  if (n_upd < 0 || n_upd > kVelMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  if (do_predict && scal == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  VelChain<T> chain{};
  chain.n = n_upd;
  for (int k = 0; k < n_upd; ++k) {
    if (models[k] != kVelDvl && models[k] != kVelPressure) return static_cast<int>(cudaErrorInvalidValue);
    chain.model[k] = models[k];
    chain.thr[k] = static_cast<T>(thr[k]);
    chain.z[k] = static_cast<const T*>(z[k]);
    chain.r[k] = static_cast<const T*>(r[k]);
    chain.m2[k] = static_cast<T*>(m2[k]);
    chain.acc[k] = static_cast<T*>(acc[k]);
    chain.nu[k] = static_cast<T*>(nu[k]);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (do_predict)
    velocity_step_kernel<T, true><<<blocks_for(nb), kThreads, 0, st>>>(
        static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(eff),
        static_cast<const T*>(av), static_cast<const T*>(trk), static_cast<const T*>(scal), chain,
        static_cast<T*>(cov_out), static_cast<T*>(mu_out), static_cast<T*>(trk_out), nb);
  else
    velocity_step_kernel<T, false><<<blocks_for(nb), kThreads, 0, st>>>(
        static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(eff),
        static_cast<const T*>(av), static_cast<const T*>(trk), static_cast<const T*>(scal), chain,
        static_cast<T*>(cov_out), static_cast<T*>(mu_out), static_cast<T*>(trk_out), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_VELOCITY_STEP_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(int do_predict, const void* cov, const void* mu, const void* eff,            \
                      const void* av, const void* trk, const void* scal, int n_upd,                \
                      const int* models, const void* const* z, const void* const* r,               \
                      const double* thr, void* const* m2, void* const* acc, void* const* nu,       \
                      void* cov_out, void* mu_out, void* trk_out, long long nb, void* stream) {    \
    return slam::launch_velocity_step<T>(do_predict, cov, mu, eff, av, trk, scal, n_upd, models,   \
                                         z, r, thr, m2, acc, nu, cov_out, mu_out, trk_out, nb,     \
                                         stream);                                                  \
  }

SLAM_VELOCITY_STEP_ENTRY(slam_velocity_step_f32, float)
SLAM_VELOCITY_STEP_ENTRY(slam_velocity_step_f64, double)
