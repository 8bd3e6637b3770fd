// The warp-per-instance body of K2, the fused 53-DOF PoseUKF prediction, in
// its shared and its full (banked) mode; K5 runs it before its updates.
//
// Replaces, one warp per instance, the TPU kernel models/pose_fused.py::
// _pose_predict_body (launched by _pose_predict_lanes): the kept equilibrated
// factor, the 107 propagated sigma points, the quaternion mean by Karcher
// iterations, the flat means and every deviation, and the half-triangle
// reconstruct ½·Σ D·Dᵀ + Q. Its results are those of the first, one-thread
// design of K2 bit for bit: every output is made by one lane with that
// design's expressions and in its order of summation; the lanes share out
// independent outputs only.
//
// What bounds it on Hopper, and what the design does about it. The function
// is memory-bound (the valid covariance half read and written, 0.79 ms at
// bank 131 072 in float32), but the one-thread design held the factor
// (53 x 53) and the points (107 x 54) in bank-last global scratch: ~n³/6
// dependent read-modify-writes of the factor through L2, and the reconstruct
// read the points 2·107·1431 times from scratch far larger than L2 (~1% of
// the bound). Here both live in the warp's tile of shared memory and there
// is no global scratch. The points overwrite the factor's columns as those
// die, so one buffer holds both; the reconstruct gives each lane 4 x 4
// output entries in registers, so it loads two operands per four FMAs.
//
// The warp's tile (T units; entry (r, c) of the factor at f[c·53 + r]):
//   [0, 107·55)        the points, point i's storage row r at i·55 + r (an
//                      odd stride: 32 lanes writing one row of 32 points hit
//                      32 banks); after stages 3 and 4 the deviations, tangent
//                      row k at storage row k + (k >= 6) (row 6 is then dead)
//   [3637, 3637+53²)   the factor (warp_factor.cuh, ld 53). Points are made
//                      32 at a time, point i reading only column (i − 1)/2:
//                      batch t (points 32t…) reads columns ≥ 16t − 1, and its
//                      rows end at entry ≤ 3637 + (16t − 1)·53 for t = 1…3,
//                      so no batch overwrites a column that it or a later
//                      batch still reads
//   terms              in the dead factor tail: the Karcher terms of the 107
//                      points (scale and the three vector components, K each)
//   d, dinv            D and D^-1 (53 each)
//   mean               the 54 storage rows of μ_in
//   b3, wvq            the rotated orientation block of Q (3 x 3) and the
//                      current inflation
//   cf, of             full mode only: the instance's Markov coefficients
//                      and rest points (54 each)
// 6616 floats (26.5 KB) in shared mode, 6724 in full mode: 8 warps an SM in
// float32, 4 in float64.
#pragma once

#include "warp_factor.cuh"

namespace slam {

constexpr int kMeanIters = 4;
constexpr int kPtLd = 55;          // point row stride (odd)
constexpr int kFactorAt = 3637;    // the factor's base: see the header
constexpr int kFactorLd = warp_ld(kPoseN);

struct PredictTile {
  int terms, d, dinv, mean, b3, wvq, cf, of, size;
  __host__ __device__ explicit PredictTile(bool full) {
    terms = kPoseSig * kPtLd;
    d = kFactorAt + kPoseN * kFactorLd;
    dinv = d + kPoseN;
    mean = dinv + kPoseN;
    b3 = mean + kPoseS;
    wvq = b3 + 9;
    cf = wvq + 1;
    of = cf + (full ? kPoseS : 0);
    size = of + (full ? kPoseS : 0);
  }
};

// Sigma point i's storage row of a Markov state in full mode, m + δ with δ =
// sign·L̃(k, j)·D_k, rounded as the first design rounded it. That design made
// the full mode's Markov rows in a pass of their own; its compiler unrolled
// the loop over the points by four and folded the sign, so that points i = 1,
// 2, 3 (mod 4) became one FMA each and a point i = 0 (mod 4) m − round(L̃·D)
// (its product and its add in two blocks). Both forms are made and one is
// selected: neighbouring lanes hold points of every residue, and branches
// would run in turn.
template <typename T>
__device__ __forceinline__ T markov_point(int i, T sign, T m, T l, T d) {
  const T fused = fma_rn(sign * l, d, m), apart = m - mul_rn(l, d);
  return i == 0 ? m + T(0) : (i & 3) == 0 ? apart : fused;
}

// One warp, instance b (its tile s holds the lower covariance half at the
// factor's place, the mean, and in full mode cf/of): the whole prediction,
// cov_out's valid half and mu_out written to global memory (bank-last).
// coeff/offs are the Markov vectors (the tile's in full mode, the shared
// ones in shared mode); the other operands are as pose_predict.cu describes.
template <typename T, bool FULL>
__device__ void warp_predict(T* s, const PredictTile& t, long long b, const T* __restrict__ rr,
                             const T* coeff, const T* offs, const T* __restrict__ q0m,
                             const T* __restrict__ scal, const T* __restrict__ aux, T* cov_out, T* mu_out,
                             long long nb) {
  constexpr int N = kPoseN, S = kPoseS, K = kPoseSig;
  const int lane = threadIdx.x % kWarpSize;
  T* const c = s + kFactorAt;
  T* const dvec = s + t.d;
  const T* const m = s + t.mean;
  auto Y = [&](int i, int r) -> T& { return s[i * kPtLd + r]; };

  T dt, lat0, mradinv, earthw, wv_scale;
  if constexpr (FULL) {
    dt = scal[0]; earthw = scal[3];
    lat0 = aux[b]; mradinv = aux[b + nb]; wv_scale = aux[b + 11 * nb];
  } else {
    dt = scal[0]; lat0 = scal[1]; mradinv = scal[2]; earthw = scal[3]; wv_scale = scal[4];
  }
  const T rx = rr[b], ry = rr[b + nb], rz = rr[b + 2 * nb];

  // 1. the kept equilibrated factor; a failed pivot runs on as NaN, as in the
  // one-thread design. Factor column j at row k is c[j·53 + k]·dvec[k].
  warp_factor<T, false>(c, dvec, s + t.dinv, N, kFactorLd);

  // 2. boxplus + process model, lane i % 32 making whole point i, 32 points
  // a batch (see the header for why a batch overwrites no live column)
  const Quat<T> mq{m[3], m[4], m[5], m[6]};
  for (int i0 = 0; i0 < K; i0 += kWarpSize) {
    const int i = i0 + lane;
    if (i < K) {
      const int j = (i - 1) / 2;
      const T sign = (i & 1) ? T(1) : T(-1);
      auto dl = [&](int k) -> T { return i == 0 ? T(0) : sign * (c[j * kFactorLd + k] * dvec[k]); };
      const T px = m[0] + dl(0), py = m[1] + dl(1), pz = m[2] + dl(2);
      const Quat<T> q = qnorm(qmul(mq, qexp(dl(3), dl(4), dl(5))));
      // flats: storage row r = tangent row r - 1
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
      // the first-order-Markov decays (per instance in full mode)
      for (int r = 10; r < S; ++r) {
        const T xs = FULL ? markov_point(i, sign, m[r], c[j * kFactorLd + r - 1], dvec[r - 1]) : m[r] + dl(r - 1);
        Y(i, r) = xs + coeff[r] * (xs - offs[r]);
      }
    }
    __syncwarp();
  }

  // 3. the quaternion mean by fixed Karcher iterations: the lanes make the
  // 107 terms, then every lane sums them in ascending i (the same sums, so
  // the same mean on every lane, in registers); the deviations Log(mean⁻¹·
  // q_i) go in place over storage rows 3..5
  const T inv_n = T(1) / T(K);
  T* const terms = s + t.terms;
  Quat<T> mqo{Y(0, 3), Y(0, 4), Y(0, 5), Y(0, 6)};
  for (int it = 0; it < kMeanIters; ++it) {
    for (int i = lane; i < K; i += kWarpSize) {
      qlog_parts(qmul(qconj(mqo), Quat<T>{Y(i, 3), Y(i, 4), Y(i, 5), Y(i, 6)}), terms[i], terms[K + i],
                 terms[2 * K + i], terms[3 * K + i]);
    }
    __syncwarp();
    T sx = T(0), sy = T(0), sz = T(0);
    for (int i = 0; i < K; ++i) {
      const T sc = terms[i];
      sx = fma_rn(sc, terms[K + i], sx);
      sy = fma_rn(sc, terms[2 * K + i], sy);
      sz = fma_rn(sc, terms[3 * K + i], sz);
    }
    __syncwarp();  // every lane has read the terms before the next iteration writes them
    mqo = qnorm(qmul(mqo, qexp(sx * inv_n, sy * inv_n, sz * inv_n)));
  }
  if (lane == 0) {
    mu_out[b + 3 * nb] = mqo.w;
    mu_out[b + 4 * nb] = mqo.x;
    mu_out[b + 5 * nb] = mqo.y;
    mu_out[b + 6 * nb] = mqo.z;
  }
  for (int i = lane; i < K; i += kWarpSize) {
    T lx, ly, lz;
    qlog(qmul(qconj(mqo), Quat<T>{Y(i, 3), Y(i, 4), Y(i, 5), Y(i, 6)}), lx, ly, lz);
    Y(i, 3) = lx; Y(i, 4) = ly; Y(i, 5) = lz;
  }

  // 4. each flat storage row r (one lane a row): its mean in closed form
  // about the zero point, Y_0 + Σ(Y_i − Y_0)/107, and its deviations
  // (Y_i − Y_0) − d̄ in place, so that the rounding scales with the sigma
  // spread rather than with the value (a running float32 sum of 107
  // gravities, ~9.8, would lose ~1e-5 a predict)
  for (int q = lane; q < S - 4; q += kWarpSize) {  // the 50 flat rows
    const int r = q < 3 ? q : q + 4;
    const T yz = Y(0, r);
    T acc = T(0);
    for (int i = 1; i < K; ++i) acc += Y(i, r) - yz;
    const T dbar = acc * inv_n;
    mu_out[b + r * nb] = yz + dbar;
    for (int i = 0; i < K; ++i) Y(i, r) = (Y(i, r) - yz) - dbar;
  }

  // 5. the per-instance Q pieces (lane 0), then the half-triangle ½ΣDDᵀ + Q
  if (lane == 0) {
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
    T Tm[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Tm[i][j] = R[i][0] * qr(j) + R[i][1] * qr(3 + j) + R[i][2] * qr(6 + j);
    T* const b3 = s + t.b3;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j <= i; ++j)
        b3[3 * i + j] = b3[3 * j + i] = Tm[i][0] * R[j][0] + Tm[i][1] * R[j][1] + Tm[i][2] * R[j][2];
    s[t.wvq] = wv_scale * (m[7] * m[7] + m[8] * m[8] + T(100) * m[9] * m[9]);
  }
  __syncwarp();

  // 4 x 4 entries a lane: block (bc, br), br >= bc, of the 14 x 14 blocks
  // (the last one row wide); each entry sums its 107 products in ascending i
  constexpr int NB4 = (N + 3) / 4;
  const T* const b3 = s + t.b3;
  const T wvq = s[t.wvq];
  T* const co = cov_out + b;
  for (int tile = lane; tile < NB4 * (NB4 + 1) / 2; tile += kWarpSize) {
    int bc = 0, br = tile;
    while (br >= NB4 - bc) {
      br -= NB4 - bc;
      ++bc;
    }
    br += bc;
    int rc[4], rr4[4];  // storage rows of the tile's tangent columns and rows
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kc = min(4 * bc + u, N - 1), kr = min(4 * br + u, N - 1);
      rc[u] = kc + (kc >= 6);
      rr4[u] = kr + (kr >= 6);
    }
    T acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
    for (int i = 0; i < K; ++i) {
      const T* yi = s + i * kPtLd;
      T a[4], e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = yi[rc[u]];
        e[u] = yi[rr4[u]];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * e[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int cc = 4 * bc + u, r = 4 * br + v;
        if (r >= N || r < cc) continue;
        T q;
        if constexpr (FULL) q = q0m[(static_cast<long long>(cc) * N + r) * nb + b];
        else q = q0m[cc * N + r];
        T val = T(0.5) * acc[u][v] + q;
        if (cc >= 3 && r < 6) val += b3[3 * (r - 3) + (cc - 3)];
        if (cc == r && cc >= 46 && cc < 50) val += wvq;
        co[(static_cast<long long>(cc) * N + r) * nb] = val;
      }
  }
}

// The block's W = 2^log_w instances b0 + w, one warp each, tiles `stride`
// apart: the lower covariance halves, the means and (full mode) the Markov
// vectors loaded bank-minor (block_walk), then warp_predict. The block is
// synchronized on entry to warp_predict; the caller synchronizes it before
// reusing the tiles or reading the outputs.
template <typename T, bool FULL>
__device__ __forceinline__ void block_predict(const T* cov, const T* mu, const T* __restrict__ rr,
                                              const T* __restrict__ coeff, const T* __restrict__ offs,
                                              const T* __restrict__ q0m, const T* __restrict__ scal,
                                              const T* __restrict__ aux, T* cov_out, T* mu_out, long long nb,
                                              int log_w, int stride) {
  constexpr int N = kPoseN;
  const PredictTile t(FULL);
  T* const base = warp_smem<T>();
  const long long b0 = static_cast<long long>(blockIdx.x) << log_w;
  const int w = threadIdx.x / kWarpSize;
  const Strides gc{1, nb, N * nb}, gv{1, nb, kPoseS * nb};
  block_walk(gc, N, N, true, log_w, b0, nb, [&](int i, int r, int c) {
    base[i * stride + kFactorAt + c * kFactorLd + r] = cov[(b0 + i) + r * nb + c * (N * nb)];
  });
  block_walk(gv, kPoseS, 1, false, log_w, b0, nb, [&](int i, int r, int) {
    base[i * stride + t.mean + r] = mu[(b0 + i) + r * nb];
  });
  if constexpr (FULL) {
    block_walk(gv, kPoseS, 1, false, log_w, b0, nb, [&](int i, int r, int) {
      base[i * stride + t.cf + r] = coeff[(b0 + i) + r * nb];
      base[i * stride + t.of + r] = offs[(b0 + i) + r * nb];
    });
  }
  __syncthreads();
  if (b0 + w < nb) {
    T* const s = base + w * stride;
    const T* cf = FULL ? s + t.cf : coeff;
    const T* of = FULL ? s + t.of : offs;
    warp_predict<T, FULL>(s, t, b0 + w, rr, cf, of, q0m, scal, aux, cov_out, mu_out, nb);
  }
}

}  // namespace slam
