// K3 · fused PoseUKF measurement update with the measurement model in-kernel.
//
// Replaces the TPU kernel models/pose_update_fused.py::_make_update_model_kernel
// with _factor_innovation, _update_tail_from_sc and _model_measurement
// (launched by _pose_update_model_lanes), for all seven FUSED_MODELS selected
// by a runtime model id: velocity, z_position, xy_position, acceleration,
// pressure, water_velocity, body_efforts (Fossen inverse dynamics from a
// 119-scalar shared vehicle block). Per instance, one thread:
//   1. the equilibrated Cholesky core keeps the factor L̃ and the scale d;
//   2. h on the zero point and on μ ⊞ (±column j), the delta row k being
//      ±L̃(k, j)·d[k] — the (107, 53) delta tensor is never built;
//   3. the measurement mean, ν = z − ẑ, S = ½Σ dz·dzᵀ + R (second pass over
//      the stored Z), and C = ½·d ⊙ Σ_j L̃(:, j)·(Z⁺_j − Z⁻_j) from the factor;
//   4. the m x m Cholesky of S, W = C·L_S^-T by ascending forward
//      substitution, y = L_S^-1·ν, m2 = |y|², the gate as a select (a
//      threshold < 0 accepts any; a NaN S leaves the instance bit-identical to
//      its prior), the correction μ ⊞ W·y and the downdate cov − W·Wᵀ on the
//      valid half (row >= col) — the tail K4 shares (common.cuh::update_tail).
// Model parameters: 5 aux values, shared (scal[1..5]) or per instance (aux,
// (5, nb)); scal[0] is the gate threshold.
//
// Bound on Hopper: memory, like K2 — the kept factor (53², bank-last global
// scratch) is read once per sigma column by h and again for C, and the
// downdate reads and writes the valid half of the covariance. This first
// version is one thread per instance with coalesced bank-last accesses; a
// later one stages the factor in shared memory.
//
// Operands (bank-last): z (m, nb), R (m, m, nb), mu (54, nb), cov (53, 53, nb)
// half-valid, scal (6), mscal (119) or null, aux (5, nb) or null.
// Outputs: cov_out (53, 53, nb) valid half, mu_out (54, nb), m2 (nb),
// acc (nb) as 1/0, nu (m, nb). Scratch: c (53, 53, nb), zs (2, 53, m, nb),
// cw (m, 53, nb).

#include "common.cuh"

namespace slam {

enum Model : int {
  kVelocity = 0,
  kZPosition = 1,
  kXYPosition = 2,
  kAcceleration = 3,
  kPressure = 4,
  kWaterVelocity = 5,
  kBodyEfforts = 6,
};

__host__ __device__ constexpr int model_dim(int model) {
  return model == kVelocity ? 3 : model == kZPosition ? 1 : model == kXYPosition ? 2
       : model == kAcceleration ? 3 : model == kPressure ? 1 : model == kWaterVelocity ? 2
       : model == kBodyEfforts ? 6 : 0;
}

template <typename T>
__device__ __forceinline__ void cross3(const T u[3], const T t[3], T out[3]) {
  out[0] = u[1] * t[2] - u[2] * t[1];
  out[1] = u[2] * t[0] - u[0] * t[2];
  out[2] = u[0] * t[1] - u[1] * t[0];
}

// Measurement of `model` at the sigma point μ ⊞ δ; m holds μ's storage rows,
// dl(k) returns tangent row k of δ. Fields the model does not read stay at μ.
template <typename T, typename Delta>
__device__ void measure(int model, const T* m, Delta dl, const T* aux, const T* msc, T* out) {
  auto x = [&](int s, int k) -> T { return m[s] + dl(k); };
  auto quat = [&]() -> Quat<T> {
    return qnorm(qmul(Quat<T>{m[3], m[4], m[5], m[6]}, qexp(dl(3), dl(4), dl(5))));
  };
  switch (model) {
    case kVelocity: {
      rot_inv(quat(), x(7, 6), x(8, 7), x(9, 8), out[0], out[1], out[2]);
      return;
    }
    case kZPosition:
      out[0] = x(2, 2);
      return;
    case kXYPosition:
      out[0] = x(0, 0);
      out[1] = x(1, 1);
      return;
    case kAcceleration: {
      const T g = x(19, 18);
      T rx, ry, rz;
      rot_inv(quat(), x(10, 9), x(11, 10), x(12, 11) + g, rx, ry, rz);
      out[0] = rx + x(16, 15);
      out[1] = ry + x(17, 16);
      out[2] = rz + x(18, 17);
      return;
    }
    case kPressure: {
      T lx, ly, lz;
      rot_fwd(quat(), aux[1], aux[2], aux[3], lx, ly, lz);
      const T sensor_z = x(2, 2) + lz;
      out[0] = aux[0] - sensor_z * x(19, 18) * x(53, 52);
      return;
    }
    case kWaterVelocity: {
      const T cw = aux[0];
      const Quat<T> q = quat();
      const T v0 = x(7, 6), v1 = x(8, 7), v2 = x(9, 8);
      T ax, ay, az, bx, by, bz;
      rot_inv(q, v0 - x(47, 46), v1 - x(48, 47), v2, ax, ay, az);
      rot_inv(q, v0 - x(49, 48), v1 - x(50, 49), v2, bx, by, bz);
      out[0] = cw * bx + (T(1) - cw) * ax + x(51, 50);
      out[1] = cw * by + (T(1) - cw) * ay + x(52, 51);
      return;
    }
    case kBodyEfforts: {
      // tau = M·nu_dot + C(nu)·nu + D_lin·nu + D_quad·(|nu|∘nu) + g(q) with
      // the sigma point's (x, y, psi) inertia/damping blocks substituted into
      // the shared 6x6 matrices (mat33 storage is column-major: k = 3·b2 + a2)
      const int idx[3] = {0, 1, 5};
      T M6[6][6], L6[6][6], Q6[6][6];
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j) {
          M6[i][j] = msc[6 * i + j];
          L6[i][j] = msc[36 + 6 * i + j];
          Q6[i][j] = msc[72 + 6 * i + j];
        }
      for (int a2 = 0; a2 < 3; ++a2)
        for (int b2 = 0; b2 < 3; ++b2) {
          const int k = 3 * b2 + a2;
          M6[idx[a2]][idx[b2]] = x(20 + k, 19 + k);
          L6[idx[a2]][idx[b2]] = x(29 + k, 28 + k);
          Q6[idx[a2]][idx[b2]] = x(38 + k, 37 + k);
        }
      const T weight = msc[108], buoy = msc[109];
      const T cog[3] = {msc[110], msc[111], msc[112]};
      const T cob[3] = {msc[113], msc[114], msc[115]};
      const T pib[3] = {msc[116], msc[117], msc[118]};
      const T w[3] = {aux[0], aux[1], aux[2]};
      const Quat<T> q = quat();
      T vb[3], wv[3], ab[3], cw[3], cc[3];
      rot_inv(q, x(7, 6), x(8, 7), x(9, 8), vb[0], vb[1], vb[2]);
      cross3(w, pib, cw);
      rot_inv(q, x(47, 46), x(48, 47), T(0), wv[0], wv[1], wv[2]);
      const T v6[6] = {vb[0] - cw[0] - wv[0], vb[1] - cw[1] - wv[1], vb[2] - cw[2] - wv[2],
                       w[0], w[1], w[2]};
      rot_inv(q, x(10, 9), x(11, 10), x(12, 11), ab[0], ab[1], ab[2]);
      cross3(w, cw, cc);
      const T a3[3] = {ab[0] - cc[0], ab[1] - cc[1], ab[2] - cc[2]};
      T p1[3], p2[3];
      for (int i = 0; i < 3; ++i) {
        p1[i] = T(0);
        p2[i] = T(0);
        for (int j = 0; j < 6; ++j) {
          p1[i] += M6[i][j] * v6[j];
          p2[i] += M6[3 + i][j] * v6[j];
        }
      }
      T c1[3], c2a[3], c2b[3];
      cross3(w, p1, c1);
      cross3(w, p2, c2a);
      cross3(v6, p1, c2b);
      const T cor[6] = {c1[0], c1[1], c1[2], c2a[0] + c2b[0], c2a[1] + c2b[1], c2a[2] + c2b[2]};
      T up[3];
      rot_inv(q, T(0), T(0), T(1), up[0], up[1], up[2]);
      const T dwb = buoy - weight;
      const T fg[3] = {-up[0] * weight, -up[1] * weight, -up[2] * weight};
      const T fb[3] = {up[0] * buoy, up[1] * buoy, up[2] * buoy};
      T tg[3], tb[3];
      cross3(cog, fg, tg);
      cross3(cob, fb, tb);
      const T g6[6] = {-(up[0] * dwb), -(up[1] * dwb), -(up[2] * dwb),
                       -(tg[0] + tb[0]), -(tg[1] + tb[1]), -(tg[2] + tb[2])};
      for (int i = 0; i < 6; ++i) {
        const T ma = M6[i][0] * a3[0] + M6[i][1] * a3[1] + M6[i][2] * a3[2];
        T dl_ = T(0), dq = T(0);
        for (int j = 0; j < 6; ++j) {
          dl_ += L6[i][j] * v6[j];
          dq += Q6[i][j] * (d_abs(v6[j]) * v6[j]);
        }
        out[i] = ma + cor[i] + (dl_ + dq) + g6[i];
      }
      return;
    }
    default:
      return;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pose_update_model_kernel(int model, int banked_aux, const T* __restrict__ z,
                         const T* __restrict__ rmat, const T* __restrict__ mu,
                         const T* __restrict__ cov, const T* __restrict__ scal,
                         const T* __restrict__ msc, const T* __restrict__ aux_b,
                         T* __restrict__ cov_out, T* __restrict__ mu_out, T* __restrict__ m2_out,
                         T* __restrict__ acc_out, T* __restrict__ nu_out, T* __restrict__ c_s,
                         T* __restrict__ zs_s, T* __restrict__ cw_s, long long nb) {
  constexpr int N = kPoseN, S = kPoseS;
  const long long b = instance_index();
  if (b >= nb) return;
  const int M = model_dim(model);
  const T* a = cov + b;
  T* c = c_s + b;
  T* zs = zs_s + b;  // (2, 53, M): Z of the ±columns
  T* cw = cw_s + b;  // (M, 53): C, then W in place
  auto C = [&](int i, int k) -> T& { return cw[(static_cast<long long>(i) * N + k) * nb]; };
  auto Z = [&](int sg, int j, int i) -> T& {
    return zs[((static_cast<long long>(sg) * N + j) * M + i) * nb];
  };

  T m[S];
  for (int s = 0; s < S; ++s) m[s] = mu[b + s * nb];
  T aux[5];
  for (int i = 0; i < 5; ++i) aux[i] = banked_aux ? aux_b[b + i * nb] : scal[1 + i];
  const T thr = scal[0];

  // 1. kept equilibrated factor
  T dvec[N];
  equilibrated_core<T, true>(a, c, nb, N, dvec, NoEmit());

  // 2. measurements of the zero point and the ±columns
  T z0[kMaxM], zp[kMaxM], zm[kMaxM], out[kMaxM];
  measure<T>(model, m, [](int) { return T(0); }, aux, msc, z0);
  for (int i = 0; i < M; ++i) zp[i] = zm[i] = T(0);
  for (int sg = 0; sg < 2; ++sg) {
    const T sign = sg == 0 ? T(1) : T(-1);
    for (int j = 0; j < N; ++j) {
      auto dl = [&](int k) -> T { return sign * (c[(static_cast<long long>(j) * N + k) * nb] * dvec[k]); };
      measure<T>(model, m, dl, aux, msc, out);
      for (int i = 0; i < M; ++i) {
        Z(sg, j, i) = out[i];
        if (sg == 0) zp[i] += out[i] - z0[i]; else zm[i] += out[i] - z0[i];
      }
    }
  }

  // 3. mean, innovation, S, C. The mean is taken about the zero point,
  // z0 + Σ(Z_i − z0)/107, and so are the deviations: a running float32 sum
  // of 107 pressures (~1e5 Pa) or specific forces (~9.8) would round at the
  // scale of the value instead of the spread.
  const T inv_n = T(1) / T(kPoseSig);
  T dzbar[kMaxM], nu[kMaxM], dz0[kMaxM];
  for (int i = 0; i < M; ++i) {
    dzbar[i] = (zp[i] + zm[i]) * inv_n;
    nu[i] = (z[b + i * nb] - z0[i]) - dzbar[i];
    nu_out[b + i * nb] = nu[i];
    dz0[i] = -dzbar[i];
  }
  T Sm[kMaxM][kMaxM];
  for (int i = 0; i < M; ++i)
    for (int k = 0; k <= i; ++k) {
      T sp = T(0), sm = T(0);
      for (int j = 0; j < N; ++j) {
        sp += ((Z(0, j, i) - z0[i]) - dzbar[i]) * ((Z(0, j, k) - z0[k]) - dzbar[k]);
        sm += ((Z(1, j, i) - z0[i]) - dzbar[i]) * ((Z(1, j, k) - z0[k]) - dzbar[k]);
      }
      Sm[i][k] = Sm[k][i] =
          T(0.5) * (sp + sm + dz0[i] * dz0[k]) + rmat[b + (static_cast<long long>(i) * M + k) * nb];
    }
  for (int i = 0; i < M; ++i)
    for (int k = 0; k < N; ++k) {
      T acc = T(0);
      for (int j = 0; j <= k; ++j)
        acc += c[(static_cast<long long>(j) * N + k) * nb] * (Z(0, j, i) - Z(1, j, i));
      C(i, k) = T(0.5) * dvec[k] * acc;
    }

  // 4. the shared tail: gain, gate, correction, downdate (common.cuh)
  update_tail<T>(M, Sm, C, nu, m, thr, a, cov_out, mu_out, m2_out, acc_out, b, nb);
}

template <typename T>
int launch_pose_update_model(int model, int banked_aux, const void* z, const void* r,
                             const void* mu, const void* cov, const void* scal, const void* msc,
                             const void* aux, void* cov_out, void* mu_out, void* m2, void* acc,
                             void* nu, void* c, void* zs, void* cw, long long nb, void* stream) {
  if (model_dim(model) == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (model == kBodyEfforts && msc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (banked_aux && aux == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  pose_update_model_kernel<T><<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      model, banked_aux, static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(mu), static_cast<const T*>(cov), static_cast<const T*>(scal),
      static_cast<const T*>(msc), static_cast<const T*>(aux), static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), static_cast<T*>(m2), static_cast<T*>(acc), static_cast<T*>(nu),
      static_cast<T*>(c), static_cast<T*>(zs), static_cast<T*>(cw), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_UPDATE_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(int model, int banked_aux, const void* z, const void* r, const void* mu,    \
                      const void* cov, const void* scal, const void* msc, const void* aux,        \
                      void* cov_out, void* mu_out, void* m2, void* acc, void* nu, void* c,        \
                      void* zs, void* cw, long long nb, void* stream) {                           \
    return slam::launch_pose_update_model<T>(model, banked_aux, z, r, mu, cov, scal, msc, aux,    \
                                             cov_out, mu_out, m2, acc, nu, c, zs, cw, nb, stream); \
  }

SLAM_POSE_UPDATE_ENTRY(slam_pose_update_model_f32, float)
SLAM_POSE_UPDATE_ENTRY(slam_pose_update_model_f64, double)
