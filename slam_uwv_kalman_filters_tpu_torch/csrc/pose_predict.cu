// K2 · fused 53-DOF PoseUKF prediction, shared-parameter and full (banked) mode.
//
// Replaces the TPU kernel models/pose_fused.py::_pose_predict_body (built by
// _make_predict_kernel(False) and _make_predict_kernel("full"), launched by
// _pose_predict_lanes): in one launch
//   1. the equilibrated Cholesky core (kept factor) -> ±sigma deltas,
//   2. boxplus and the process model of every sigma point (reference
//      PoseUKF.cpp:12-84: position/velocity Euler steps, orientation with
//      earth rate at the sigma point's latitude, first-order-Markov decays),
//   3. the quaternion mean by MEAN_ITERS = 4 fixed Karcher iterations and
//      its deviations,
//   4. the flat means in closed form about the zero sigma point and their
//      deviations, in place,
//   5. the half-triangle reconstruct ½·Σ D·Dᵀ + Q, Q assembled per instance:
//      the orientation block R(μ_in)·Qrot·R(μ_in)ᵀ (lower half computed and
//      mirrored, so exactly symmetric) and the water-current inflation on the
//      diagonal entries 46..49.
// All 107 sigma points are summed one by one: the ± pairs are never folded
// (folding made missions NaN after tens to hundreds of ticks on the TPU).
//
// Bound on Hopper: memory. One thread per instance; the factor (53², bank-
// last) and the propagated points (107 x 54) live in global scratch, and the
// reconstruct reads the points 2·107·1431 times. All accesses are coalesced,
// but at fleet scale the working set is far beyond L2, so scratch traffic
// sets the time. This first version keeps the structure plain; a later one
// tiles the points in shared memory and gives each instance a warp.
//
// The mode is a template parameter, so the shared-mode code compiles as it did
// before the full mode existed. Operands (bank-last): cov (53, 53, nb)
// half-valid in, mu (54, nb), rr (3, nb), scal (14) [dt, lat0, 1/m_rad,
// EARTHW, wv_scale·dt³, dt²·Qrot row-major x9], and
//   shared mode: coeff/offs (54) Markov coefficient -dt/tau and rest point,
//     q0m (53, 53) dt²-scaled Q with its orientation block zeroed;
//   full mode (a banked Monte-Carlo parameter set): coeff/offs (54, nb), q0m
//     (53, 53, nb) per lane, and aux (12, nb) [lat0; 1/m_rad; dt²·Qrot x9;
//     wv_scale·dt³] in place of scal's entries 1, 2, 4 and 5..13 (note the
//     other order: Qrot before the current inflation). The Markov decay of
//     storage rows 10..53 then runs as its own pass, one row at a time, so
//     each per-lane coefficient is read once; it adds ~1.5k coalesced reads
//     per instance to the ~415k scratch accesses of the shared mode.
// Outputs: cov_out (53, 53, nb) written only at row >= col, mu_out (54, nb).
// Scratch: y (107, 54, nb), c (53, 53, nb).

#include "common.cuh"

namespace slam {

constexpr int kMeanIters = 4;

template <typename T, bool FULL>
__global__ void __launch_bounds__(kThreads)
pose_predict_kernel(const T* __restrict__ cov, const T* __restrict__ mu, const T* __restrict__ rr,
                    const T* __restrict__ coeff, const T* __restrict__ offs,
                    const T* __restrict__ q0m, const T* __restrict__ scal,
                    const T* __restrict__ aux, T* __restrict__ cov_out, T* __restrict__ mu_out,
                    T* __restrict__ y_s, T* __restrict__ c_s, long long nb) {
  constexpr int N = kPoseN, S = kPoseS, K = kPoseSig;
  const long long b = instance_index();
  if (b >= nb) return;
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

template <typename T, bool FULL>
int launch_pose_predict(const void* cov, const void* mu, const void* rr, const void* coeff,
                        const void* offs, const void* q0m, const void* scal, const void* aux,
                        void* cov_out, void* mu_out, void* y, void* c, long long nb, void* stream) {
  if (FULL && aux == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  pose_predict_kernel<T, FULL><<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cov), static_cast<const T*>(mu), static_cast<const T*>(rr),
      static_cast<const T*>(coeff), static_cast<const T*>(offs), static_cast<const T*>(q0m),
      static_cast<const T*>(scal), static_cast<const T*>(aux), static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), static_cast<T*>(y), static_cast<T*>(c), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_POSE_PREDICT_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* cov, const void* mu, const void* rr, const void* coeff,          \
                      const void* offs, const void* q0m, const void* scal, void* cov_out,          \
                      void* mu_out, void* y, void* c, long long nb, void* stream) {                \
    return slam::launch_pose_predict<T, false>(cov, mu, rr, coeff, offs, q0m, scal, nullptr,       \
                                               cov_out, mu_out, y, c, nb, stream);                 \
  }
#define SLAM_POSE_PREDICT_FULL_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* cov, const void* mu, const void* rr, const void* coeff,          \
                      const void* offs, const void* q0m, const void* scal, const void* aux,        \
                      void* cov_out, void* mu_out, void* y, void* c, long long nb, void* stream) {  \
    return slam::launch_pose_predict<T, true>(cov, mu, rr, coeff, offs, q0m, scal, aux, cov_out,   \
                                              mu_out, y, c, nb, stream);                           \
  }

SLAM_POSE_PREDICT_ENTRY(slam_pose_predict_f32, float)
SLAM_POSE_PREDICT_ENTRY(slam_pose_predict_f64, double)
SLAM_POSE_PREDICT_FULL_ENTRY(slam_pose_predict_full_f32, float)
SLAM_POSE_PREDICT_FULL_ENTRY(slam_pose_predict_full_f64, double)
