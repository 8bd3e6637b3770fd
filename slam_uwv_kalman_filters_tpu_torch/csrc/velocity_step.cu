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
//      S = H·P·Hᵀ + R, C = P·Hᵀ, then the Kalman tail of small_ukf.cuh
//      (shared with K7): the m x m Crout factor of S, the NIS νᵀS⁻¹ν, the gain
//      K = C·S⁻¹, the gate as a select (a threshold < 0 accepts any; a NaN S
//      leaves the instance's prior), the correction μ + K·ν and the exactly
//      symmetric downdate P − (K·L_S)(K·L_S)ᵀ.
//
// Bound on Hopper: bytes at large banks, latency at small ones. Each
// instance reads ~31 and writes ~21 values (4x4 cov, mean, efforts, gyro,
// tracker), ~200 bytes in float32 at 3.35 TB/s, against ~3k operations, ~2k
// of them in the ten Fossen evaluations. One thread an instance, everything
// in registers, takes 0.0144 ms for 65 536 instances (NVIDIA H100 80GB
// HBM3, 700 W, float32): the load, the chain and the store run one after
// the other in a single wave; one instance takes 0.0068. Two designs of the
// predicting step, picked by the bank (velocity_group):
//   - small banks: a group of G = 16 lanes an instance (group_ukf.cuh). Lane
//     g makes the Fossen evaluation g of the ten (the 9 sigma points and, as
//     the tenth, the tracker with its pose); the new velocities and depths
//     come to every lane by shuffle, and every lane runs the rest of the
//     one-thread body on identical values (the 4x4 factor and the sigma
//     rows before the dynamics, the mean and deviations about point 0,
//     ½ΣdYdYᵀ + dt·Q, the chain of updates).
//     Loads and stores are staged in shared memory (stage_in / stage_out),
//     so each bank-last row moves in runs of a block's instances;
//   - large banks, and the update-only step: one thread an instance.
// Both give the same bits: every value is made by one lane with the
// one-thread expressions, every sum over the points ascending.
//
// Operands (bank-last): cov (4, 4, nb) (col, row), mu (4, nb), eff (6, nb),
// av (3, nb), trk (13, nb) [pos 3, quat wxyz 4, lin vel 3, ang vel 3], scal
// (165) [dt; M ×36; M⁻¹ ×36; D_lin ×36; D_quad ×36; B − W; B·cob − W·cog ×3;
// dt·Q ×16], all row-major; per update k: z_k (m_k, nb), R_k (m_k, m_k, nb),
// the threshold by value. Outputs: cov_out (4, 4, nb) both halves, mu_out
// (4, nb), trk_out (13, nb); per update m2_k (nb), acc_k (nb) as 1/0, nu_k
// (m_k, nb). The chain is a by-value VelChain of at most kVelMaxSteps updates.

#include "group_ukf.cuh"

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

// One linear update observing rows ROW0 .. ROW0 + M − 1 of the state: for
// such an H the ukfom update is S = H·P·Hᵀ + R, C = P·Hᵀ, then the Kalman
// tail of small_ukf.cuh. Row r of the instance's z, R, m2, acc and ν at
// [r·stride] of the pointers given (the bank at stride nb, a stage at
// stride I); only a lane with write stores.
template <typename T, int M, int ROW0>
__device__ __forceinline__ void linear_update(T (&P)[kVelDof][kVelDof], T (&mu)[kVelDof],
                                              const T* z, const T* rmat, T thr, T* m2_out,
                                              T* acc_out, T* nu_out, long long stride, bool write) {
  T S[M][M], nu[M], C[kVelDof][M], corr[kVelDof], m2;
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int c = 0; c < M; ++c)
      S[a][c] = P[ROW0 + a][ROW0 + c] + rmat[(a * M + c) * stride];
    nu[a] = z[a * stride] - mu[ROW0 + a];
    if (write) nu_out[a * stride] = nu[a];
  }
#pragma unroll
  for (int i = 0; i < kVelDof; ++i) {
#pragma unroll
    for (int a = 0; a < M; ++a) C[i][a] = P[i][ROW0 + a];
  }
  const bool accept = kalman_tail<T, kVelDof, M>(P, S, C, nu, thr, corr, m2);
  if (write) {
    m2_out[0] = m2;
    acc_out[0] = accept ? T(1) : T(0);
  }
  if (accept) {
#pragma unroll
    for (int i = 0; i < kVelDof; ++i) mu[i] += corr[i];
  }
}

// The one-thread build's rounding, written out. ptxas fuses a product into
// the sum that reads it, or not, by how the product is shared across the
// unrolled sigma points; a group's lanes share other values, and their code
// would round otherwise. The helpers below give each product, sum and fused
// product as that build's SASS has it (a·b − c·d as fma(a, b, −c·d), sums
// of products as FMA chains from 0), and both designs call them.

// row `row` of sigma point pt's delta: point 0 zero, points 2j+1 / 2j+2 the
// ±j-th column of the factor L
template <typename T>
__device__ __forceinline__ T velocity_delta(const T (&L)[kVelDof][kVelDof], int row, int pt) {
  if (pt == 0) return T(0);
  const int j = (pt - 1) / 2;
  const T v = j <= row ? L[row][j] : T(0);
  return (pt & 1) ? v : -v;
}

// a·b − c·d
template <typename T>
__device__ __forceinline__ T cross_rn(T a, T b, T c, T d) {
  return fma_rn(a, b, -mul_rn(c, d));
}

// third row r2 of R(q) of the tracker (up_body = Rᵀe_z and the depth rate
// (R·v)_z read exactly these three numbers) and the restoring term g(q) =
// −[(B−W)·up; (B·cob − W·cog) × up] as g[i] = −bw·r2[i] (i < 3; the dynamics
// fuse the product into their sum) and g[3 + i] = −gr[i]
template <typename T>
__device__ __forceinline__ void velocity_restoring(const T* s, T qw, T qx, T qy, T qz, T (&r2)[3], T& bw,
                                                   T (&gr)[3]) {
  r2[0] = T(2) * cross_rn(qx, qz, qw, qy);
  r2[1] = T(2) * fma_rn(qw, qx, mul_rn(qy, qz));
  r2[2] = add_rn(T(1), -(T(2) * fma_rn(qx, qx, mul_rn(qy, qy))));
  const T rv[3] = {s[kVRv], s[kVRv + 1], s[kVRv + 2]};
  bw = s[kVBw];
  gr[0] = cross_rn(rv[1], r2[2], rv[2], r2[1]);
  gr[1] = cross_rn(rv[2], r2[0], rv[0], r2[2]);
  gr[2] = cross_rn(rv[0], r2[1], rv[1], r2[0]);
}

// one Fossen step of a 6-DOF velocity from the parameter block s: the new
// 6-DOF velocity nu + dt·M⁻¹(τ − C(ν)ν − D(ν)ν − g)
template <typename T>
__device__ __forceinline__ void velocity_fossen(const T* s, const T (&tau)[6], const T (&r2)[3], T bw,
                                                const T (&gr)[3], T dt, const T (&nu)[6], T (&out)[6]) {
  T p6[6], anu[6], rhs[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T t = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) t = fma_rn(s[kVM + 6 * i + j], nu[j], t);
    p6[i] = t;
    anu[i] = mul_rn(d_abs(nu[i]), nu[i]);
  }
  // C(ν)ν = [ω × p1; ω × p2 + v × p1]
  const T cor[6] = {cross_rn(nu[4], p6[2], nu[5], p6[1]), cross_rn(nu[5], p6[0], nu[3], p6[2]),
                    cross_rn(nu[3], p6[1], nu[4], p6[0]),
                    add_rn(cross_rn(nu[4], p6[5], nu[5], p6[4]), cross_rn(nu[1], p6[2], nu[2], p6[1])),
                    add_rn(cross_rn(nu[5], p6[3], nu[3], p6[5]), cross_rn(nu[2], p6[0], nu[0], p6[2])),
                    add_rn(cross_rn(nu[3], p6[4], nu[4], p6[3]), cross_rn(nu[0], p6[1], nu[1], p6[0]))};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T dmp = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j)
      dmp = add_rn(dmp, fma_rn(s[kVDl + 6 * i + j], nu[j], mul_rn(s[kVDq + 6 * i + j], anu[j])));
    const T x = add_rn(add_rn(tau[i], -cor[i]), -dmp);
    rhs[i] = i < 3 ? fma_rn(bw, r2[i], x) : add_rn(x, gr[i - 3]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T a = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) a = fma_rn(s[kVMi + 6 * i + j], rhs[j], a);
    out[i] = fma_rn(dt, a, nu[i]);
  }
}

// the depth of a sigma point: its prior depth z + dt·(R·v)_z of the new
// velocity nv
template <typename T>
__device__ __forceinline__ T velocity_depth(T z, const T (&r2)[3], const T (&nv)[6], T dt) {
  return fma_rn(dt, fma_rn(r2[2], nv[2], fma_rn(r2[0], nv[0], mul_rn(r2[1], nv[1]))), z);
}

// the mean of the 9 points Y about point 0 (Y_0 + Σ(Y_i − Y_0)/9), their
// deviations from it in place, and P = ½ΣdYdYᵀ + dt·Q (dt·Q at q, row-major)
template <typename T>
__device__ __forceinline__ void velocity_moments(T (&Y)[kVelSig][kVelDof], const T* q, T (&mu)[kVelDof],
                                                 T (&P)[kVelDof][kVelDof]) {
  constexpr int D = kVelDof, K = kVelSig;
  const T inv_n = T(1) / T(K);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const T y0 = Y[0][i];
    T acc = T(0);
#pragma unroll
    for (int p = 1; p < K; ++p) acc = add_rn(acc, add_rn(Y[p][i], -y0));
    mu[i] = fma_rn(acc, inv_n, y0);
#pragma unroll
    for (int p = 0; p < K; ++p) Y[p][i] = fma_rn(-acc, inv_n, add_rn(Y[p][i], -y0));
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T acc = T(0);
#pragma unroll
      for (int p = 0; p < K; ++p) acc = fma_rn(Y[p][i], Y[p][j], acc);
      P[i][j] = P[j][i] = fma_rn(T(0.5), acc, q[4 * i + j]);
    }
  }
}

// the tracker's full kinematic step from its orientation q = (qw, u) and new
// 6-DOF velocity nv: the position by the rotated new velocity, the
// orientation by qexp of the new rate (common.cuh's qexp / qmul / qnorm);
// row r of trk_out at to[r·stride]
template <typename T>
__device__ __forceinline__ void tracker_step(const T (&pos)[3], T qw, const T (&u)[3], const T (&nv)[6], T dt,
                                             T* to, long long stride) {
  const T t2[3] = {T(2) * cross_rn(u[1], nv[2], u[2], nv[1]), T(2) * cross_rn(u[2], nv[0], u[0], nv[2]),
                   T(2) * cross_rn(u[0], nv[1], u[1], nv[0])};
  const T rot[3] = {add_rn(fma_rn(qw, t2[0], nv[0]), cross_rn(u[1], t2[2], u[2], t2[1])),
                    add_rn(fma_rn(qw, t2[1], nv[1]), cross_rn(u[2], t2[0], u[0], t2[2])),
                    add_rn(fma_rn(qw, t2[2], nv[2]), cross_rn(u[0], t2[1], u[1], t2[0]))};
  const Quat<T> qn = qnorm(qmul(Quat<T>{qw, u[0], u[1], u[2]}, qexp(nv[3] * dt, nv[4] * dt, nv[5] * dt)));
#pragma unroll
  for (int i = 0; i < 3; ++i) to[i * stride] = fma_rn(dt, rot[i], pos[i]);
  to[3 * stride] = qn.w;
  to[4 * stride] = qn.x;
  to[5 * stride] = qn.y;
  to[6 * stride] = qn.z;
#pragma unroll
  for (int i = 0; i < 6; ++i) to[(7 + i) * stride] = nv[i];
}

// ---- large banks and the update-only step: one thread an instance -----------

template <typename T, bool DO_PREDICT>
__global__ void __launch_bounds__(kThreads)
velocity_step_thread_kernel(const T* __restrict__ cov, const T* __restrict__ mu_in,
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
    // the sigma deltas of the factor
    T L[D][D];
    crout<T, D>(P, L);
    const auto delta = [&](int row, int pt) { return velocity_delta(L, row, pt); };
    const T qw = tk[3], qx = tk[4], qy = tk[5], qz = tk[6];
    T r2[3], bw, gr[3];
    velocity_restoring(s, qw, qx, qy, qz, r2, bw, gr);
    T tau[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) tau[i] = eff[b + i * nb];
    const T w_in[3] = {av[b], av[b + nb], av[b + 2 * nb]};

    // the 9 sigma points: new velocity and depth
    T Y[K][D];
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const T nu6[6] = {add_rn(mu[0], delta(0, p)), add_rn(mu[1], delta(1, p)), add_rn(mu[2], delta(2, p)),
                        w_in[0], w_in[1], w_in[2]};
      T nv[6];
      velocity_fossen(s, tau, r2, bw, gr, dt, nu6, nv);
      Y[p][0] = nv[0];
      Y[p][1] = nv[1];
      Y[p][2] = nv[2];
      Y[p][3] = velocity_depth(add_rn(mu[3], delta(3, p)), r2, nv, dt);
    }
    velocity_moments(Y, s + kVQ, mu, P);

    // the tracker: its own velocity through the dynamics, then the pose
    const T tnu[6] = {tk[7], tk[8], tk[9], tk[10], tk[11], tk[12]};
    T tn[6];
    velocity_fossen(s, tau, r2, bw, gr, dt, tnu, tn);
    tracker_step({tk[0], tk[1], tk[2]}, qw, {qx, qy, qz}, tn, dt, tk, 1);
  }

  // the measurement chain
  for (int k = 0; k < chain.n; ++k) {
    if (chain.model[k] == kVelDvl)
      linear_update<T, 3, 0>(P, mu, chain.z[k] + b, chain.r[k] + b, chain.thr[k], chain.m2[k] + b,
                             chain.acc[k] + b, chain.nu[k] + b, nb, true);
    else
      linear_update<T, 1, 3>(P, mu, chain.z[k] + b, chain.r[k] + b, chain.thr[k], chain.m2[k] + b,
                             chain.acc[k] + b, chain.nu[k] + b, nb, true);
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

// ---- small banks, predicting: a group of G lanes an instance ----------------

// stage rows: the loads (cov's lower half (i, j <= i) in packed order, mu,
// eff, av, trk), an update's z and R; the stores (cov, mu, trk), an update's
// m2, acc and ν
constexpr int kVelInRows = 10 + kVelDof + 6 + 3 + kVelTrk;  // 36
constexpr int kVelOutRows = kVelDof * kVelDof + kVelDof + kVelTrk;  // 33
constexpr int kVelUpdOutRows = 2 + 3;

template <typename T, int G>
__global__ void __launch_bounds__(kGroupThreads)
velocity_step_group_kernel(const T* __restrict__ cov, const T* __restrict__ mu_in,
                           const T* __restrict__ eff, const T* __restrict__ av,
                           const T* __restrict__ trk, const T* __restrict__ scal, const VelChain<T> chain,
                           T* __restrict__ cov_out, T* __restrict__ mu_out, T* __restrict__ trk_out,
                           long long nb) {
  // lane g evaluates the rows p ≡ g (mod G) of ten: the sigma points 0..8,
  // the tracker at 9 (lane 9 mod G, its pass 9 / G)
  constexpr int D = kVelDof, K = kVelSig, I = kGroupThreads / G, Q = (K + G) / G;
  constexpr int kTrkPass = K / G, kTrkLane = K % G;
  __shared__ T s[kVelNScal];
  __shared__ T in_stage[kVelInRows * I], out_stage[(kVelOutRows + kVelUpdOutRows) * I];
  const long long b0 = static_cast<long long>(blockIdx.x) * I;
  const auto rows = [](int r) { return r; };
  const auto at = [](T* base) { return [base](int r, int i) -> T& { return base[r * I + i]; }; };
  for (int i = threadIdx.x; i < kVelNScal; i += blockDim.x) s[i] = scal[i];
  stage_in(cov, 10, [](int e) { int i, j; tri_entry(e, i, j); return j * kVelDof + i; }, b0, I, nb, at(in_stage));
  stage_in(mu_in, D, rows, b0, I, nb, at(in_stage + 10 * I));
  stage_in(eff, 6, rows, b0, I, nb, at(in_stage + 14 * I));
  stage_in(av, 3, rows, b0, I, nb, at(in_stage + 20 * I));
  stage_in(trk, kVelTrk, rows, b0, I, nb, at(in_stage + 23 * I));
  __syncthreads();
  const Group<G> grp;
  const T* const in = in_stage + grp.index;
  T* const out = out_stage + grp.index;
  const bool lead = grp.g == 0;

  T P[D][D], mu[D];
  {
    int r = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j, ++r) P[i][j] = P[j][i] = in[r * I];
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) mu[i] = in[(10 + i) * I];
  const T dt = s[kVDt];
  // the sigma deltas of the factor
  T L[D][D];
  crout<T, D>(P, L);
  const auto delta = [&](int row, int pt) { return velocity_delta(L, row, pt); };
  const T qw = in[26 * I], qx = in[27 * I], qy = in[28 * I], qz = in[29 * I];
  T r2[3], bw, gr[3];
  velocity_restoring(s, qw, qx, qy, qz, r2, bw, gr);
  T tau[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) tau[i] = in[(14 + i) * I];
  const T w_in[3] = {in[20 * I], in[21 * I], in[22 * I]};
  // the sigma points' rows before the dynamics, every point on every lane;
  // each lane then takes its own
  T v0[K], v1[K], v2[K], z3[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    v0[p] = add_rn(mu[0], delta(0, p));
    v1[p] = add_rn(mu[1], delta(1, p));
    v2[p] = add_rn(mu[2], delta(2, p));
    z3[p] = add_rn(mu[3], delta(3, p));
  }

  // the lane's rows through the dynamics: the new velocity and depth of a
  // sigma point; the tracker's new velocity, kept for its pose
  T yq[D][Q], tn[6];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int p = k * G + grp.g < K ? k * G + grp.g : 0;
    const bool tracker = k == kTrkPass && grp.g == kTrkLane;
    const T nu6[6] = {tracker ? in[30 * I] : pick(v0, p), tracker ? in[31 * I] : pick(v1, p),
                      tracker ? in[32 * I] : pick(v2, p), tracker ? in[33 * I] : w_in[0],
                      tracker ? in[34 * I] : w_in[1], tracker ? in[35 * I] : w_in[2]};
    T nv[6];
    velocity_fossen(s, tau, r2, bw, gr, dt, nu6, nv);
    yq[0][k] = nv[0];
    yq[1][k] = nv[1];
    yq[2][k] = nv[2];
    yq[3][k] = velocity_depth(pick(z3, p), r2, nv, dt);
    if (k == kTrkPass) {
#pragma unroll
      for (int i = 0; i < 6; ++i) tn[i] = nv[i];
    }
  }
  // every lane: the points' rows by shuffle, then their mean, deviations and
  // ½ΣdYdYᵀ + dt·Q; the tracker's lane its pose
  T Yr[D][K], Y[K][D];
#pragma unroll
  for (int i = 0; i < D; ++i) group_gather(grp, yq[i], Yr[i]);
#pragma unroll
  for (int p = 0; p < K; ++p) {
#pragma unroll
    for (int i = 0; i < D; ++i) Y[p][i] = Yr[i][p];
  }
  velocity_moments(Y, s + kVQ, mu, P);
  if (grp.g == kTrkLane)
    tracker_step({in[23 * I], in[24 * I], in[25 * I]}, qw, {qx, qy, qz}, tn, dt, out + 20 * I, I);
  __syncthreads();  // the loads are read before the first update restages them

  // the measurement chain, every lane on identical values; lane 0 stores
  T* const upd = out + kVelOutRows * I;
  for (int k = 0; k < chain.n; ++k) {
    const bool dvl = chain.model[k] == kVelDvl;
    const int m = dvl ? 3 : 1;
    stage_in(chain.z[k], m, rows, b0, I, nb, at(in_stage));
    stage_in(chain.r[k], m * m, rows, b0, I, nb, at(in_stage + m * I));
    __syncthreads();
    if (dvl)
      linear_update<T, 3, 0>(P, mu, in, in + 3 * I, chain.thr[k], upd, upd + I, upd + 2 * I, I, lead);
    else
      linear_update<T, 1, 3>(P, mu, in, in + I, chain.thr[k], upd, upd + I, upd + 2 * I, I, lead);
    __syncthreads();
    T* const ustage = out_stage + kVelOutRows * I;
    stage_out(chain.m2[k], 1, rows, b0, I, nb, at(ustage));
    stage_out(chain.acc[k], 1, rows, b0, I, nb, at(ustage + I));
    stage_out(chain.nu[k], m, rows, b0, I, nb, at(ustage + 2 * I));
  }

  if (lead) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      out[(16 + i) * I] = mu[i];
#pragma unroll
      for (int j = 0; j < D; ++j) out[(j * D + i) * I] = P[i][j];
    }
  }
  __syncthreads();
  stage_out(cov_out, D * D, rows, b0, I, nb, at(out_stage));
  stage_out(mu_out, D, rows, b0, I, nb, at(out_stage + 16 * I));
  stage_out(trk_out, kVelTrk, rows, b0, I, nb, at(out_stage + 20 * I));
}

// The group size of a predicting launch at bank nb, 0 for one thread an
// instance: SLAM_VELOCITY_GROUP lanes up to SLAM_VELOCITY_GROUP_BANKS
// instances. tools/small_kernel_times.py (predict + DVL, float32, NVIDIA
// H100 80GB HBM3 at 700 W) timed 16 lanes at 0.0063 ms for one instance,
// 0.0069 for 256 and 0.0073 for 2048 against 0.0068, 0.0075 and 0.0076 for
// one thread, and 0.0085 against 0.0080 at 4096; 2, 4 and 8 lanes were
// slower at every bank. It builds this file with both macros set to time
// any design at any bank.
#ifndef SLAM_VELOCITY_GROUP
#define SLAM_VELOCITY_GROUP 16
#endif
#ifndef SLAM_VELOCITY_GROUP_BANKS
#define SLAM_VELOCITY_GROUP_BANKS 2048
#endif
constexpr int kVelGroup = SLAM_VELOCITY_GROUP;
inline int velocity_group(long long nb) { return nb <= SLAM_VELOCITY_GROUP_BANKS ? kVelGroup : 0; }

template <typename T>
int launch_velocity_step(int do_predict, const void* cov, const void* mu, const void* eff,
                         const void* av, const void* trk, const void* scal, int n_upd,
                         const int* models, const void* const* z, const void* const* r,
                         const double* thr, void* const* m2, void* const* acc, void* const* nu,
                         void* cov_out, void* mu_out, void* trk_out, long long nb, void* stream) {
  if (nb < 1 || n_upd < 0 || n_upd > kVelMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
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
  const auto launch = [&](auto kernel, unsigned blocks, int threads) {
    kernel<<<blocks, threads, 0, st>>>(static_cast<const T*>(cov), static_cast<const T*>(mu),
                                       static_cast<const T*>(eff), static_cast<const T*>(av),
                                       static_cast<const T*>(trk), static_cast<const T*>(scal), chain,
                                       static_cast<T*>(cov_out), static_cast<T*>(mu_out),
                                       static_cast<T*>(trk_out), nb);
  };
  if (do_predict && velocity_group(nb)) {
    constexpr long long I = kGroupThreads / kVelGroup;
    launch(velocity_step_group_kernel<T, kVelGroup>, static_cast<unsigned>((nb + I - 1) / I), kGroupThreads);
  } else if (do_predict) {
    launch(velocity_step_thread_kernel<T, true>, blocks_for(nb), kThreads);
  } else {
    launch(velocity_step_thread_kernel<T, false>, blocks_for(nb), kThreads);
  }
  return static_cast<int>(cudaGetLastError());
}

// the warps a block (and, in resident, an SM) of the predicting launch at
// bank nb
template <typename T>
int velocity_step_warps(long long nb, int* resident) {
  if (nb < 1) return -static_cast<int>(cudaErrorInvalidValue);
  return velocity_group(nb) ? group_warps(velocity_step_group_kernel<T, kVelGroup>, kGroupThreads, 0, resident)
                            : group_warps(velocity_step_thread_kernel<T, true>, kThreads, 0, resident);
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
  }                                                                                                \
  extern "C" int NAME##_warps(long long nb) { return slam::velocity_step_warps<T>(nb, nullptr); }   \
  extern "C" int NAME##_resident(long long nb) {                                                   \
    int resident = 0;                                                                              \
    const int warps = slam::velocity_step_warps<T>(nb, &resident);                                 \
    return warps < 0 ? warps : resident;                                                           \
  }

SLAM_VELOCITY_STEP_ENTRY(slam_velocity_step_f32, float)
SLAM_VELOCITY_STEP_ENTRY(slam_velocity_step_f64, double)
