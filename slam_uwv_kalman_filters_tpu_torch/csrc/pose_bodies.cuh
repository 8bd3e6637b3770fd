// The per-instance bodies of the PoseUKF predict (K2) and the in-kernel-model
// update (K3), one copy each, called by the __global__ kernels of K2
// (pose_predict.cu), K3 (pose_update.cu) and the whole step K5 (pose_step.cu).
//
// Each body is the work of one thread on instance b, with every operand
// pointer at its array's start (bank-last layout, common.cuh). The caller
// checks b < nb.
//
// Aliasing: K5 updates its running covariance and mean in place, so the
// update body takes cov/cov_out and mu/mu_out without __restrict__ (the same
// pointer may be passed as both). That is safe: the mean is read into
// registers before any store, the factorization reads cov before the tail
// writes, and the tail reads each covariance entry before it writes the same
// entry (common.cuh::update_tail).
#pragma once

#include "common.cuh"

namespace slam {

// ---- K2: the fused 53-DOF prediction ---------------------------------------
// See pose_predict.cu for the algorithm and the operands of both modes.
constexpr int kMeanIters = 4;

template <typename T, bool FULL>
__device__ __forceinline__ void predict_body(long long b, const T* __restrict__ cov,
                                             const T* __restrict__ mu, const T* __restrict__ rr,
                                             const T* __restrict__ coeff, const T* __restrict__ offs,
                                             const T* __restrict__ q0m, const T* __restrict__ scal,
                                             const T* __restrict__ aux, T* __restrict__ cov_out,
                                             T* __restrict__ mu_out, T* __restrict__ y_s,
                                             T* __restrict__ c_s, long long nb) {
  constexpr int N = kPoseN, S = kPoseS, K = kPoseSig;
  const T* a = cov + b;
  T* c = c_s + b;
  T* y = y_s + b;
  auto Y = [&](int i, int s) -> T& { return y[(static_cast<long long>(i) * S + s) * nb]; };

  T dt, lat0, mradinv, earthw, wv_scale;
  if constexpr (FULL) {
    dt = scal[0]; earthw = scal[3];
    lat0 = aux[b]; mradinv = aux[b + nb]; wv_scale = aux[b + 11 * nb];
  } else {
    dt = scal[0]; lat0 = scal[1]; mradinv = scal[2]; earthw = scal[3]; wv_scale = scal[4];
  }
  T m[S];
  for (int s = 0; s < S; ++s) m[s] = mu[b + s * nb];
  const T rx = rr[b], ry = rr[b + nb], rz = rr[b + 2 * nb];

  // 1. kept equilibrated factor: column j of L at row k is c(j, k)·dvec[k]
  T dvec[N];
  equilibrated_core<T, true>(a, c, nb, N, dvec, NoEmit());

  // 2. boxplus + process model, one sigma point at a time
  const Quat<T> mq{m[3], m[4], m[5], m[6]};
  for (int i = 0; i < K; ++i) {
    const int j = (i - 1) / 2;
    const T sign = (i & 1) ? T(1) : T(-1);
    auto dl = [&](int k) -> T {
      return i == 0 ? T(0) : sign * (c[(static_cast<long long>(j) * N + k) * nb] * dvec[k]);
    };
    const T px = m[0] + dl(0), py = m[1] + dl(1), pz = m[2] + dl(2);
    const Quat<T> q = qnorm(qmul(mq, qexp(dl(3), dl(4), dl(5))));
    // flats: storage row s = tangent row s - 1
    const T vx = m[7] + dl(6), vy = m[8] + dl(7), vz = m[9] + dl(8);
    const T ax = m[10] + dl(9), ay = m[11] + dl(10), az = m[12] + dl(11);
    Y(i, 0) = px + dt * vx;
    Y(i, 1) = py + dt * vy;
    Y(i, 2) = pz + dt * vz;
    const T lat = lat0 + px * mradinv;
    const T er_x = earthw * d_cos(lat), er_z = earthw * d_sin(lat);
    const T ux = rx - (m[13] + dl(12)), uy = ry - (m[14] + dl(13)), uz = rz - (m[15] + dl(14));
    const T tx = T(2) * (q.y * uz - q.z * uy);
    const T ty = T(2) * (q.z * ux - q.x * uz);
    const T tz = T(2) * (q.x * uy - q.y * ux);
    const T wx = ux + q.w * tx + (q.y * tz - q.z * ty) - er_x;
    const T wy = uy + q.w * ty + (q.z * tx - q.x * tz);
    const T wz = uz + q.w * tz + (q.x * ty - q.y * tx) - er_z;
    const Quat<T> yq = qnorm(qmul(q, qexp(wx * dt, wy * dt, wz * dt)));
    Y(i, 3) = yq.w; Y(i, 4) = yq.x; Y(i, 5) = yq.y; Y(i, 6) = yq.z;
    Y(i, 7) = vx + dt * ax;
    Y(i, 8) = vy + dt * ay;
    Y(i, 9) = vz + dt * az;
    if constexpr (!FULL) {
      for (int s = 10; s < S; ++s) {
        const T xs = m[s] + dl(s - 1);
        Y(i, s) = xs + coeff[s] * (xs - offs[s]);
      }
    }
  }
  if constexpr (FULL) {
    // the Markov decays with per-lane coefficients, one storage row at a time
    for (int s = 10; s < S; ++s) {
      const T cs = coeff[b + s * nb], os = offs[b + s * nb];
      const long long col = static_cast<long long>(s - 1) * nb;  // tangent row s - 1
      for (int i = 0; i < K; ++i) {
        const int j = (i - 1) / 2;
        const T sign = (i & 1) ? T(1) : T(-1);
        const T dl = i == 0 ? T(0) : sign * (c[static_cast<long long>(j) * N * nb + col] * dvec[s - 1]);
        const T xs = m[s] + dl;
        Y(i, s) = xs + cs * (xs - os);
      }
    }
  }

  // 3. the quaternion mean by fixed Karcher iterations, then its deviations
  // Log(mean⁻¹·q_i) in place over storage rows 3..5 (row 6 is then free)
  const T inv_n = T(1) / T(K);
  Quat<T> mqo{Y(0, 3), Y(0, 4), Y(0, 5), Y(0, 6)};
  for (int it = 0; it < kMeanIters; ++it) {
    T sx = T(0), sy = T(0), sz = T(0);
    for (int i = 0; i < K; ++i) {
      T lx, ly, lz;
      qlog(qmul(qconj(mqo), Quat<T>{Y(i, 3), Y(i, 4), Y(i, 5), Y(i, 6)}), lx, ly, lz);
      sx += lx; sy += ly; sz += lz;
    }
    mqo = qnorm(qmul(mqo, qexp(sx * inv_n, sy * inv_n, sz * inv_n)));
  }
  mu_out[b + 3 * nb] = mqo.w;
  mu_out[b + 4 * nb] = mqo.x;
  mu_out[b + 5 * nb] = mqo.y;
  mu_out[b + 6 * nb] = mqo.z;
  for (int i = 0; i < K; ++i) {
    T lx, ly, lz;
    qlog(qmul(qconj(mqo), Quat<T>{Y(i, 3), Y(i, 4), Y(i, 5), Y(i, 6)}), lx, ly, lz);
    Y(i, 3) = lx; Y(i, 4) = ly; Y(i, 5) = lz;
  }

  // 4. each flat storage row s: its mean in closed form and its deviations,
  // in place at tangent row s (position) or s − 1 (the rest; ascending s, so
  // the row written was read before). Mean and deviations are taken about
  // the zero point, Y_0 + Σ(Y_i − Y_0)/107 and (Y_i − Y_0) − d̄, so the
  // rounding scales with the sigma spread rather than with the value: a
  // running float32 sum of 107 gravities (~9.8) loses ~1e-5 per predict,
  // which the acceleration update turns into velocity error. One row at a
  // time keeps the two scalars in registers.
  for (int s = 0; s < S; ++s) {
    if (s >= 3 && s < 7) continue;
    const int k = s < 3 ? s : s - 1;
    const T yz = Y(0, s);
    T acc = T(0);
    for (int i = 1; i < K; ++i) acc += Y(i, s) - yz;
    const T dbar = acc * inv_n;
    mu_out[b + s * nb] = yz + dbar;
    for (int i = 0; i < K; ++i) Y(i, k) = (Y(i, s) - yz) - dbar;
  }

  // 5. per-instance Q pieces, then the half-triangle ½ΣDDᵀ + Q
  const T w0 = m[3], x0 = m[4], y0 = m[5], z0 = m[6];
  const T R[3][3] = {
      {1 - 2 * (y0 * y0 + z0 * z0), 2 * (x0 * y0 - w0 * z0), 2 * (x0 * z0 + w0 * y0)},
      {2 * (x0 * y0 + w0 * z0), 1 - 2 * (x0 * x0 + z0 * z0), 2 * (y0 * z0 - w0 * x0)},
      {2 * (x0 * z0 - w0 * y0), 2 * (y0 * z0 + w0 * x0), 1 - 2 * (x0 * x0 + y0 * y0)}};
  // dt²·Qrot entry k (row-major)
  auto qr = [&](int k) -> T {
    if constexpr (FULL) return aux[b + (2 + k) * nb];
    else return scal[5 + k];
  };
  T Tm[3][3], B3[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Tm[i][j] = R[i][0] * qr(j) + R[i][1] * qr(3 + j) + R[i][2] * qr(6 + j);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j <= i; ++j)
      B3[i][j] = B3[j][i] = Tm[i][0] * R[j][0] + Tm[i][1] * R[j][1] + Tm[i][2] * R[j][2];
  const T wvq = wv_scale * (m[7] * m[7] + m[8] * m[8] + T(100) * m[9] * m[9]);

  T* co = cov_out + b;
  for (int cc = 0; cc < N; ++cc) {
    for (int r = cc; r < N; ++r) {
      T acc = T(0);
      for (int i = 0; i < K; ++i) acc += Y(i, cc) * Y(i, r);
      T q;
      if constexpr (FULL) q = q0m[(static_cast<long long>(cc) * N + r) * nb + b];
      else q = q0m[cc * N + r];
      T v = T(0.5) * acc + q;
      if (cc >= 3 && r < 6) v += B3[r - 3][cc - 3];
      if (cc == r && cc >= 46 && cc < 50) v += wvq;
      co[(static_cast<long long>(cc) * N + r) * nb] = v;
    }
  }
}

// ---- K3: the in-kernel measurement models ----------------------------------
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

// ---- K3: the whole in-kernel-model update of instance b --------------------
// See pose_update.cu for the algorithm and the operands. `scal` is the
// [threshold, aux ×5] block; with banked_aux the aux values come from the
// (5, nb) lanes aux_b instead.
template <typename T>
__device__ __forceinline__ void update_model_body(
    long long b, int model, int banked_aux, const T* __restrict__ z, const T* __restrict__ rmat,
    const T* mu, const T* cov, const T* __restrict__ scal, const T* __restrict__ msc,
    const T* __restrict__ aux_b, T* cov_out, T* mu_out, T* __restrict__ m2_out,
    T* __restrict__ acc_out, T* __restrict__ nu_out, T* __restrict__ c_s, T* __restrict__ zs_s,
    T* __restrict__ cw_s, long long nb) {
  constexpr int N = kPoseN, S = kPoseS;
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

}  // namespace slam
