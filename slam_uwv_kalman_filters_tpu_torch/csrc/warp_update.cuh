// The warp-per-instance body of K3, the in-kernel-model PoseUKF update.
//
// Replaces, one warp per instance, the TPU kernel models/pose_update_fused.py::
// _make_update_model_kernel (launched by _pose_update_model_lanes): the kept
// equilibrated factor, h on the 107 sigma points, S, C, the m x m gain, the
// gate, the correction and the downdate. Its function and its results are
// those of its first design, one thread per instance, bit for bit: every
// output is made by one lane, in the one-thread body's order and with its
// expressions; the lanes share out independent outputs only. K5 runs it too,
// after its predict (block_update_model), and K4 (pose_update_tail.cu) runs
// its gain stages (warp_gain_and_mean) and its downdate (block_downdate).
//
// What bounds it on Hopper, and what the design does about it. The function
// is memory-bound (the valid half of the covariance read and written, 0.47
// ms at bank 131 072 in float32), but the one-thread body made ~n³/6
// dependent read-modify-writes of its factor through L2 in global scratch,
// with its measurements and gain in more scratch and 254 registers a thread
// (1% of the bound). Here the factor, D and D^-1 (warp_factor.cuh), the mean,
// the 107 measurements, C and then W live in the warp's tile of shared
// memory; no global scratch. What is left is the factor's shared-memory
// traffic and its n dependent steps, which many resident warps hide: the tile
// is sized by the model's m (12.5 KB at m = 1, 15.9 KB at m = 6 in float32),
// so 12 to 16 warps fit an SM.
//
// The warp's tile (T units, M = the model's measurement dimension):
//   [0, n·ld)         the factor, column-major (warp_factor.cuh), ld = n | 1
//   d, dinv           D and D^-1 (n each)
//   mean              the 54 storage rows of μ, then of the updated mean
//   z0                h at the zero point (M)
//   zs                Z(sg, j, i) = h at μ ⊞ (±column j), sg 0 for +, at
//                     zs[(sg·n + j)·M + i]; after C is made, corr (n)
//   cw                C(i, k) at cw[i·n + k], then W in place
//   sm                S (M x M, symmetric), then its Cholesky factor L_S in
//                     its lower half
//   nu, y, idg        ν, y = L_S^-1·ν and 1 / L_S(i, i) (M each)
//   m2, acc           the NIS and the gate (1 accepted, 0 rejected)
#pragma once

#include "pose_bodies.cuh"
#include "warp_factor.cuh"

namespace slam {

struct UpdateTile {
  int ld, d, dinv, mean, z0, zs, cw, sm, nu, y, idg, m2, acc, size;
  __host__ __device__ explicit UpdateTile(int M) : ld(warp_ld(kPoseN)) {
    constexpr int N = kPoseN;
    d = N * ld;
    dinv = d + N;
    mean = dinv + N;
    z0 = mean + kPoseS;
    zs = z0 + M;
    cw = zs + 2 * N * M;
    sm = cw + M * N;
    nu = sm + M * M;
    y = nu + M;
    idg = y + M;
    m2 = idg + M;
    acc = m2 + 1;
    size = acc + 1;
  }
};

// Stages 4-6 of the update, one warp: from S (M x M, both halves, in `sm`),
// ν, C(i, k) at cw[i·53 + k] and the 54 storage rows of μ in `m`:
//   4. lane 0: the M x M Cholesky of S in place (lower half), idg = 1 /
//      L_S(i, i), y = L_S^-1·ν, m2 = |y|² and the gate (a threshold < 0
//      accepts any; a NaN S rejects) into *m2_slot and *acc_slot (1 or 0);
//   5. W = C·L_S^-T by forward substitution, one lane per column k, in place;
//      corr(k) = Σ_i W(i, k)·y_i into `corr` (53);
//   6. the updated mean in place, one lane per storage row: μ ⊞ corr where
//      accepted, else μ.
// The expressions and their order are those of the one-thread update tail
// that K3 and K4 first ran, so its bits are kept. K3, K4 and K5 call it.
template <typename T>
__device__ __forceinline__ void warp_gain_and_mean(int M, T thr, T* sm, const T* nu, T* y, T* idg, T* cw,
                                                   T* corr, T* m, T* m2_slot, T* acc_slot) {
  constexpr int N = kPoseN;
  const int lane = threadIdx.x % kWarpSize;
  auto C = [&](int i, int k) -> T& { return cw[i * N + k]; };

  // 4. lane 0: the M x M Cholesky of S (in place, lower half), y = L_S^-1·ν,
  // m2 = |y|² and the gate (a threshold < 0 accepts any; a NaN S rejects)
  if (lane == 0) {
    for (int j = 0; j < M; ++j) {
      T sj = sm[j * M + j];
      for (int k = 0; k < j; ++k) sj -= sm[j * M + k] * sm[j * M + k];
      sm[j * M + j] = d_sqrt(sj);
      const T inv = T(1) / sm[j * M + j];
      for (int i = j + 1; i < M; ++i) {
        T u = sm[i * M + j];
        for (int k = 0; k < j; ++k) u -= sm[i * M + k] * sm[j * M + k];
        sm[i * M + j] = u * inv;
      }
    }
    for (int i = 0; i < M; ++i) idg[i] = T(1) / sm[i * M + i];
    for (int i = 0; i < M; ++i) {
      T u = nu[i];
      for (int kk = 0; kk < i; ++kk) u -= sm[i * M + kk] * y[kk];
      y[i] = u * idg[i];
    }
    T m2 = T(0);
    for (int i = 0; i < M; ++i) m2 += y[i] * y[i];
    *m2_slot = m2;
    *acc_slot = ((m2 <= thr) || (thr < T(0))) ? T(1) : T(0);
  }
  __syncwarp();

  // 5. W = C·L_S^-T by forward substitution, one lane per column k, in place;
  // then corr(k) = Σ_i W(i, k)·y_i
  for (int k = lane; k < N; k += kWarpSize) {
    for (int i = 0; i < M; ++i) {
      T u = C(i, k);
      for (int kk = 0; kk < i; ++kk) u -= sm[i * M + kk] * C(kk, k);
      C(i, k) = u * idg[i];
    }
    T c = T(0);
    for (int i = 0; i < M; ++i) c += C(i, k) * y[i];
    corr[k] = c;
  }
  __syncwarp();

  // 6. the updated mean in place, one lane per storage row: μ ⊞ corr where
  // accepted, else μ (read everything first, then write)
  const bool accept = *acc_slot != T(0);
  auto updated = [&](int r) -> T {
    if (r >= 3 && r < 7) {
      const Quat<T> qn = qnorm(qmul(Quat<T>{m[3], m[4], m[5], m[6]}, qexp(corr[3], corr[4], corr[5])));
      return accept ? (r == 3 ? qn.w : r == 4 ? qn.x : r == 5 ? qn.y : qn.z) : m[r];
    }
    return accept ? m[r] + corr[r < 3 ? r : r - 1] : m[r];
  };
  const int r1 = lane + kWarpSize;
  const T v0 = updated(lane), v1 = r1 < kPoseS ? updated(r1) : T(0);
  __syncwarp();
  m[lane] = v0;
  if (r1 < kPoseS) m[r1] = v1;
  __syncwarp();
}

// One warp, instance b (its tile s holds the valid covariance half and the
// mean): everything up to the downdate, which the kernel does block-wide.
// `aux` holds the instance's five model values, `z` and `rmat` point at the
// instance (element i of z at z[i·nb], R(i, k) at rmat[(i·M + k)·nb]).
template <typename T>
__device__ void warp_update_model(T* s, const UpdateTile& t, int model, const T* aux, const T* __restrict__ msc,
                                  T thr, const T* __restrict__ z, const T* __restrict__ rmat, long long nb) {
  constexpr int N = kPoseN;
  const int M = model_dim(model), lane = threadIdx.x % kWarpSize, ld = t.ld;
  T* const d = s + t.d;
  T* const m = s + t.mean;
  T* const z0 = s + t.z0;
  T* const zs = s + t.zs;
  T* const cw = s + t.cw;
  T* const sm = s + t.sm;
  auto Z = [&](int sg, int j, int i) -> T& { return zs[(sg * N + j) * M + i]; };
  auto C = [&](int i, int k) -> T& { return cw[i * N + k]; };

  // 1. the kept equilibrated factor; a failed pivot runs on as NaN, as in the
  // one-thread body (the gate then keeps the prior)
  warp_factor<T, false>(s, d, s + t.dinv, N, ld);

  // 2. h at the zero point (every lane, lane 0 keeps it), then at μ ⊞
  // (±column j), lane j % 32, in the one-thread body's loop nest (the sign
  // outside, so that the compiler sees the same expressions)
  {
    T out[kMaxM];
    measure<T>(model, m, [](int) { return T(0); }, aux, msc, out);
#pragma unroll
    for (int i = 0; i < kMaxM; ++i)
      if (lane == 0 && i < M) z0[i] = out[i];
  }
  for (int sg = 0; sg < 2; ++sg) {
    const T sign = sg == 0 ? T(1) : T(-1);
    for (int j = lane; j < N; j += kWarpSize) {
      T out[kMaxM];
      auto dl = [&](int k) -> T { return sign * (s[j * ld + k] * d[k]); };
      measure<T>(model, m, dl, aux, msc, out);
#pragma unroll
      for (int i = 0; i < kMaxM; ++i)
        if (i < M) Z(sg, j, i) = out[i];
    }
  }
  __syncwarp();

  // 3. the mean about the zero point and ν, lane i for component i (its ±
  // sums in ascending j, as the one-thread body accumulates them)
  const T inv_n = T(1) / T(kPoseSig);
  T* const nu = s + t.nu;
  T* const dzbar = s + t.y;  // y is written only after S, C and ν are read
  if (lane < M) {
    const int i = lane;
    T zp = T(0), zm = T(0);
    for (int j = 0; j < N; ++j) zp += Z(0, j, i) - z0[i];
    for (int j = 0; j < N; ++j) zm += Z(1, j, i) - z0[i];
    dzbar[i] = (zp + zm) * inv_n;
    nu[i] = (z[i * nb] - z0[i]) - dzbar[i];
  }
  __syncwarp();

  // S(i, k), k <= i, one lane per entry; C(i, k) = ½·D_k·Σ_{j<=k} L̃(k, j)·
  // (Z⁺_j − Z⁻_j), one lane per row k: k = lane and, for the rows past 31,
  // k = n − 1 − lane (so each lane sums ~n terms)
  {
    int p = lane, i = 0;
    while (i < M && p > i) p -= ++i;
    if (i < M) {
      const int k = p;
      const T dz0i = -dzbar[i], dz0k = -dzbar[k];
      T sp = T(0), sn = T(0);
      for (int j = 0; j < N; ++j) {
        sp += ((Z(0, j, i) - z0[i]) - dzbar[i]) * ((Z(0, j, k) - z0[k]) - dzbar[k]);
        sn += ((Z(1, j, i) - z0[i]) - dzbar[i]) * ((Z(1, j, k) - z0[k]) - dzbar[k]);
      }
      sm[i * M + k] = sm[k * M + i] = T(0.5) * (sp + sn + dz0i * dz0k) + rmat[(i * M + k) * nb];
    }
  }
  for (int pass = 0; pass < 2; ++pass) {
    const int k = pass == 0 ? lane : N - 1 - lane;
    if (pass == 1 && k < kWarpSize) break;
    for (int i = 0; i < M; ++i) {
      T acc = T(0);
      for (int j = 0; j <= k; ++j) acc += s[j * ld + k] * (Z(0, j, i) - Z(1, j, i));
      C(i, k) = T(0.5) * d[k] * acc;
    }
  }
  __syncwarp();

  // 4-6. the gain, the gate, W, the correction (into the dead Z) and the
  // updated mean
  warp_gain_and_mean<T>(M, thr, sm, s + t.nu, s + t.y, s + t.idg, cw, zs, m, s + t.m2, s + t.acc);
}

// The block's downdate, bank-minor (block_walk): cov − W·Wᵀ on the valid half
// of each instance whose gate accepted (tile entry `acc` not 0), else the
// prior, prior(i, r, c, e) for entry (r, c) of tile i, e its index in
// cov_out; W(i, k) at tile entry cw + i·53 + k, the tiles `stride` apart.
// Each entry is read and written by one thread, so a prior read from cov_out
// itself is fine. K3, K4 and K5 call it.
template <typename T, typename Prior>
__device__ __forceinline__ void block_downdate(int M, int cw, int acc, Prior prior_of, T* cov_out, long long nb,
                                               int log_w, int stride) {
  constexpr int N = kPoseN;
  const T* const base = warp_smem<T>();
  const long long b0 = static_cast<long long>(blockIdx.x) << log_w;
  const Strides gc{1, nb, N * nb};
  block_walk(gc, N, N, true, log_w, b0, nb, [&](int i, int r, int c) {
    const T* s = base + i * stride;
    const long long e = (b0 + i) + r * nb + c * (N * nb);
    const T prior = prior_of(i, r, c, e);
    if (s[acc] != T(0)) {
      T a = T(0);
      for (int k = 0; k < M; ++k) a += s[cw + k * N + c] * s[cw + k * N + r];
      cov_out[e] = prior - a;
    } else {
      cov_out[e] = prior;
    }
  });
}

// The block's W = 2^log_w instances b0 + w, one warp each, tiles `stride`
// (>= UpdateTile(m).size) apart: the valid covariance halves and the means
// loaded bank-minor (block_walk), warp_update_model, then the downdate
// cov − W·Wᵀ on the valid half where accepted (else the prior), the mean, ν,
// the NIS and the gate written back, bank-minor. The downdate reads the prior
// a second time rather than keep a second tile, and each entry is read and
// written by one thread, so cov/cov_out and mu/mu_out may be the same arrays
// (K5 updates in place). The caller synchronizes the block before a call
// that reuses the tiles or reads what the block wrote.
template <typename T>
__device__ __forceinline__ void block_update_model(int model, int banked_aux, const T* __restrict__ z,
                                                   const T* __restrict__ rmat, const T* mu, const T* cov,
                                                   const T* __restrict__ scal, const T* __restrict__ msc,
                                                   const T* __restrict__ aux_b, T* cov_out, T* mu_out,
                                                   T* __restrict__ m2_out, T* __restrict__ acc_out,
                                                   T* __restrict__ nu_out, long long nb, int log_w, int stride) {
  constexpr int N = kPoseN;
  const int M = model_dim(model);
  const UpdateTile t(M);
  T* const base = warp_smem<T>();
  const long long b0 = static_cast<long long>(blockIdx.x) << log_w;
  const int w = threadIdx.x / kWarpSize;
  // bank-last (col, row, nb) matrices and (row, nb) vectors; a vector's
  // column stride only steers block_walk's lanes along its rows
  const Strides gc{1, nb, N * nb}, gv{1, nb, kPoseS * nb};
  block_walk(gc, N, N, true, log_w, b0, nb, [&](int i, int r, int c) {
    base[i * stride + c * t.ld + r] = cov[(b0 + i) + r * nb + c * (N * nb)];
  });
  block_walk(gv, kPoseS, 1, false, log_w, b0, nb, [&](int i, int r, int) {
    base[i * stride + t.mean + r] = mu[(b0 + i) + r * nb];
  });
  __syncthreads();
  if (b0 + w < nb) {
    const long long b = b0 + w;
    T aux[5];
    for (int i = 0; i < 5; ++i) aux[i] = banked_aux ? aux_b[b + i * nb] : scal[1 + i];
    warp_update_model<T>(base + w * stride, t, model, aux, msc, scal[0], z + b, rmat + b, nb);
  }
  __syncthreads();
  // the prior read a second time rather than kept in a second tile
  block_downdate<T>(M, t.cw, t.acc, [&](int, int, int, long long e) { return cov[e]; }, cov_out, nb, log_w, stride);
  block_walk(gv, kPoseS, 1, false, log_w, b0, nb, [&](int i, int r, int) {
    mu_out[(b0 + i) + r * nb] = base[i * stride + t.mean + r];
  });
  block_walk(gv, M, 1, false, log_w, b0, nb, [&](int i, int r, int) {
    nu_out[(b0 + i) + r * nb] = base[i * stride + t.nu + r];
  });
  block_walk(gv, 1, 1, false, log_w, b0, nb, [&](int i, int, int) {
    m2_out[b0 + i] = base[i * stride + t.m2];
    acc_out[b0 + i] = base[i * stride + t.acc];
  });
}

}  // namespace slam
