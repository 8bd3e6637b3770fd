// K4 · the generic-h PoseUKF update tail.
//
// Replaces the TPU kernel models/pose_update_fused.py::_make_update_kernel
// (body _update_tail, then _update_tail_from_sc; launched by
// _pose_update_lanes): the update of a measurement model h that ran outside
// the kernel. One warp per instance, W = 2^log_w instances a block:
//   1. S = ½·Σ dz·dzᵀ + R, one lane per entry (i, k <= i), and C = ½·Σ δ·dzᵀ,
//      one lane per column k (k = lane, lane + 32), each a sum over all 107
//      sigma points in ascending order (the ± pairs are never folded);
//   2. K3's gain stages (warp_update.cuh::warp_gain_and_mean): the m x m
//      Cholesky of S, W = C·L_S^-T by ascending forward substitution, y =
//      L_S^-1·ν, m2 = |y|², the gate as a select (a threshold < 0 accepts
//      any; a NaN S leaves the instance bit-identical to its prior) and the
//      correction μ ⊞ W·y;
//   3. the half-triangle downdate cov − W·Wᵀ, block-wide
//      (warp_update.cuh::block_downdate).
// m is a template parameter, 1 … kMaxM = 6 (every m the JAX package passes:
// 1, 2, 3, 6); the wrapper refuses a larger one. Every output is made by one
// lane with the expressions and the order of the first design (one thread
// per instance), so the results are its bits.
//
// Bound on Hopper: memory, and the deltas (107 x 53 an instance: 2.97 GB of
// the 4.9 GB moved at bank 131 072 in float32) are most of it. Every operand
// is read from device memory once, coalesced and asynchronously: the block
// copies its W instances' rows (contiguous per row in the bank-last layout)
// into the warps' tiles with cp.async. The mean, dz and ν go with the first
// chunk of kTailChunk points of the deltas; the chunks then stream through
// two staging buffers, so the next chunk's copy overlaps this chunk's
// multiply-adds, and the copy transposes them (instance-major), so a warp
// reads its own rows without bank conflicts. Once C is made, the prior
// covariance's valid half is copied into the dead dz and staging buffers
// while the gain runs, and the downdate reads it there. No global scratch,
// and no load waits on the one before it. The first design kept C and then W
// in bank-last global scratch, re-read dz once per 8 columns and read W 2m
// times per valid covariance entry through L2.
//
// The warp's tile (T units, M = the measurement dimension):
//   mean              the 54 storage rows of μ, then of the updated mean
//   corr              the correction W·y (53)
//   nu, y, idg        ν, y = L_S^-1·ν and 1 / L_S(i, i) (M each)
//   m2, acc           the NIS and the gate (1 accepted, 0 rejected)
//   sm                S (M x M, symmetric), then L_S in its lower half
//   cw                C(i, k) at cw[i·53 + k], then W in place
//   dz                dz(p, i) at dz[p·M + i], then two staging buffers of
//                     kTailStage entries; once C is made, the prior's
//                     valid half, entry (r, c) at dz + c·53 − c(c − 1)/2 + r − c
// padded to 4 mod 32 entries, so that the block's copies write W instances ×
// 4 rows a warp instruction into 32 distinct float32 banks.
//
// Operands (bank-last): deltas (107, 53, nb), dz (107, m, nb), nu (m, nb),
// R (m, m, nb), mu (54, nb), cov (53, 53, nb) half-valid, thr (by value).
// Outputs: cov_out (53, 53, nb) valid half, mu_out (54, nb), m2 (nb), acc
// (nb) as 1/0. No scratch.

#include "warp_update.cuh"

namespace slam {

constexpr int kTailChunk = 8;                     // sigma points a staging buffer holds
constexpr int kTailStage = kTailChunk * kPoseN;   // its entries
constexpr int kHalf = kPoseN * (kPoseN + 1) / 2;  // 1431 entries of a valid half

struct TailTile {
  int mean, corr, nu, y, idg, m2, acc, sm, cw, dz, stage, prior, size;
  __host__ __device__ explicit TailTile(int M) {
    mean = 0;
    corr = mean + kPoseS;
    nu = corr + kPoseN;
    y = nu + M;
    idg = y + M;
    m2 = idg + M;
    acc = m2 + 1;
    sm = acc + 1;
    cw = sm + M * M;
    dz = prior = cw + M * kPoseN;
    stage = dz + kPoseSig * M;
    const int end = stage + 2 * kTailStage;
    size = (end > prior + kHalf ? end : prior + kHalf) + 31;
    size -= (size - 4) % 32;
  }
};

// cp.async of one element, global -> shared, and its group fences (the host
// pass of a header sees a plain copy)
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int PENDING>
__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
#endif
}

// Rows [0, R) of a bank-last (R, nb) array, from src (the block's first
// instance's row 0), into tile offset `off` of each of the block's warps, as
// cp.async (uncommitted): thread f copies instance f % W of row f / W, so the
// W instances of a row are read together.
template <typename T>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src, int rows, T* base, int stride, int off,
                                          int log_w, long long b0, long long nb) {
  const int W = 1 << log_w;
  for (int f = threadIdx.x; f < (rows << log_w); f += blockDim.x) {
    const int w = f & (W - 1), r = f >> log_w;
    if (b0 + w < nb) copy_async(base + w * stride + off + r, src + r * nb + w);
  }
}

// Chunk c of the deltas (points c·kTailChunk …) into staging buffer `buf`.
template <typename T>
__device__ __forceinline__ void stage_deltas(const T* __restrict__ deltas, T* base, int stride, int stage, int c,
                                             int buf, int log_w, long long b0, long long nb) {
  const int p0 = c * kTailChunk;
  const int rows = ((p0 + kTailChunk < kPoseSig ? p0 + kTailChunk : kPoseSig) - p0) * kPoseN;
  copy_rows(deltas + static_cast<long long>(p0) * kPoseN * nb + b0, rows, base, stride,
            stage + buf * kTailStage, log_w, b0, nb);
}

template <typename T, int M>
__global__ void __launch_bounds__(kWarpSize* kMaxWarps)
pose_update_tail_kernel(const T* __restrict__ deltas, const T* __restrict__ dz, const T* __restrict__ nu_in,
                        const T* __restrict__ rmat, const T* __restrict__ mu, const T* __restrict__ cov, T thr,
                        T* __restrict__ cov_out, T* __restrict__ mu_out, T* __restrict__ m2_out,
                        T* __restrict__ acc_out, long long nb, int log_w) {
  constexpr int N = kPoseN, K = kPoseSig, P = kTailChunk, chunks = (K + P - 1) / P;
  const TailTile t(M);
  const int stride = t.size;
  T* const base = warp_smem<T>();
  const long long b0 = static_cast<long long>(blockIdx.x) << log_w;
  const int w = threadIdx.x / kWarpSize, lane = threadIdx.x % kWarpSize;
  const bool live = b0 + w < nb;

  // the mean, dz and ν with the first chunk of the deltas (one group)
  copy_rows(mu + b0, kPoseS, base, stride, t.mean, log_w, b0, nb);
  copy_rows(dz + b0, K * M, base, stride, t.dz, log_w, b0, nb);
  copy_rows(nu_in + b0, M, base, stride, t.nu, log_w, b0, nb);
  stage_deltas(deltas, base, stride, t.stage, 0, 0, log_w, b0, nb);
  copy_async_commit();

  T* const s = base + w * stride;
  const T* const z = s + t.dz;
  T* const sm = s + t.sm;
  // 1. S(i, k) = ½·Σ_p dz(p, i)·dz(p, k) + R(i, k), k <= i, one lane per
  // entry, once the first group is in; C(i, k) = ½·Σ_p δ(p, k)·dz(p, i),
  // lane k and k + 32, chunk by chunk
  const int k1 = lane + kWarpSize;
  T acc0[M], acc1[M];
#pragma unroll
  for (int i = 0; i < M; ++i) acc0[i] = acc1[i] = T(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_deltas(deltas, base, stride, t.stage, c + 1, (c + 1) & 1, log_w, b0, nb);
      copy_async_commit();
      copy_async_wait<1>();
    } else {
      copy_async_wait<0>();
    }
    __syncthreads();  // chunk c (and with chunk 0 the mean, dz and ν) is in every warp's tile
    if (live && c == 0) {
      int p = lane, i = 0;
      while (i < M && p > i) p -= ++i;
      if (i < M) {
        const int k = p;
        T sacc = T(0);
        for (int q = 0; q < K; ++q) sacc += z[q * M + i] * z[q * M + k];
        sm[i * M + k] = sm[k * M + i] = T(0.5) * sacc + rmat[(b0 + w) + static_cast<long long>(i * M + k) * nb];
      }
    }
    if (live) {
      const T* st = s + t.stage + (c & 1) * kTailStage;
      const int p0 = c * P, pn = (p0 + P < K ? p0 + P : K) - p0;
      for (int q = 0; q < pn; ++q) {
        const T dv0 = st[q * N + lane];
        const T dv1 = k1 < N ? st[q * N + k1] : T(0);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const T zp = z[(p0 + q) * M + i];
          acc0[i] += dv0 * zp;
          acc1[i] += dv1 * zp;
        }
      }
    }
    __syncthreads();  // every warp is done with buffer c & 1 (after the last chunk, with dz)
  }

  // 2. the prior's valid half into the dead dz and staging buffers, in
  // flight while each warp makes W, the gate and the mean
  const Strides gc{1, nb, N * nb};
  block_walk(gc, N, N, true, log_w, b0, nb, [&](int i, int r, int c) {
    copy_async(base + i * stride + t.prior + c * N - c * (c - 1) / 2 + r - c, cov + (b0 + i) + r * nb + c * (N * nb));
  });
  copy_async_commit();
  if (live) {
    T* const cw = s + t.cw;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      cw[i * N + lane] = T(0.5) * acc0[i];
      if (k1 < N) cw[i * N + k1] = T(0.5) * acc1[i];
    }
    __syncwarp();
    warp_gain_and_mean<T>(M, thr, sm, s + t.nu, s + t.y, s + t.idg, cw, s + t.corr, s + t.mean, s + t.m2,
                          s + t.acc);
  }
  copy_async_wait<0>();
  __syncthreads();

  // 3. the downdate from the staged prior, the mean, the NIS and the gate,
  // bank-minor
  block_downdate<T>(
      M, t.cw, t.acc,
      [&](int i, int r, int c, long long) { return base[i * stride + t.prior + c * N - c * (c - 1) / 2 + r - c]; },
      cov_out, nb, log_w, stride);
  const Strides gv{1, nb, kPoseS * nb};
  block_walk(gv, kPoseS, 1, false, log_w, b0, nb, [&](int i, int r, int) {
    mu_out[(b0 + i) + r * nb] = base[i * stride + t.mean + r];
  });
  block_walk(gv, 1, 1, false, log_w, b0, nb, [&](int i, int, int) {
    m2_out[b0 + i] = base[i * stride + t.m2];
    acc_out[b0 + i] = base[i * stride + t.acc];
  });
}

// The launch's warps per block as log2, or a negated cudaError_t; `resident`
// receives the warps an SM keeps.
template <typename T, int M>
int pose_update_tail_log_w(long long nb, int* resident) {
  if (nb < 1) return -static_cast<int>(cudaErrorInvalidValue);
  static const long long max_bytes = opt_in_smem(pose_update_tail_kernel<T, M>);
  if (max_bytes < 0) return static_cast<int>(max_bytes);
  const long long bytes = static_cast<long long>(TailTile(M).size) * sizeof(T);
  const int log_w = resident_warps_log2(pose_update_tail_kernel<T, M>, nb, bytes, max_bytes, resident);
  if (log_w < -1) return log_w + 1;
  return log_w < 0 ? -static_cast<int>(cudaErrorInvalidValue) : log_w;
}

template <typename T, int M>
int launch_m(const void* d, const void* dz, const void* nu, const void* r, const void* mu, const void* cov,
             double thr, void* cov_out, void* mu_out, void* m2, void* acc, long long nb, cudaStream_t stream) {
  const int log_w = pose_update_tail_log_w<T, M>(nb, nullptr);
  if (log_w < 0) return -log_w;
  const size_t bytes = static_cast<size_t>(TailTile(M).size) * sizeof(T) << log_w;
  const unsigned blocks = static_cast<unsigned>((nb + (1LL << log_w) - 1) >> log_w);
  pose_update_tail_kernel<T, M><<<blocks, kWarpSize << log_w, bytes, stream>>>(
      static_cast<const T*>(d), static_cast<const T*>(dz), static_cast<const T*>(nu), static_cast<const T*>(r),
      static_cast<const T*>(mu), static_cast<const T*>(cov), static_cast<T>(thr), static_cast<T*>(cov_out),
      static_cast<T*>(mu_out), static_cast<T*>(m2), static_cast<T*>(acc), nb, log_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pose_update_tail(int m, const void* d, const void* dz, const void* nu, const void* r, const void* mu,
                            const void* cov, double thr, void* cov_out, void* mu_out, void* m2, void* acc,
                            long long nb, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch_m<T, 1>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, nb, st);
    case 2: return launch_m<T, 2>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, nb, st);
    case 3: return launch_m<T, 3>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, nb, st);
    case 4: return launch_m<T, 4>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, nb, st);
    case 5: return launch_m<T, 5>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, nb, st);
    case 6: return launch_m<T, 6>(d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, nb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The warps per block (or, with `resident`, the warps an SM keeps) of a
// launch at (m, nb), or a negated cudaError_t.
template <typename T>
int pose_update_tail_warps(int m, long long nb, bool resident) {
  int res = 0, log_w = -static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 1: log_w = pose_update_tail_log_w<T, 1>(nb, &res); break;
    case 2: log_w = pose_update_tail_log_w<T, 2>(nb, &res); break;
    case 3: log_w = pose_update_tail_log_w<T, 3>(nb, &res); break;
    case 4: log_w = pose_update_tail_log_w<T, 4>(nb, &res); break;
    case 5: log_w = pose_update_tail_log_w<T, 5>(nb, &res); break;
    case 6: log_w = pose_update_tail_log_w<T, 6>(nb, &res); break;
    default: break;
  }
  return log_w < 0 ? log_w : (resident ? res : 1 << log_w);
}

}  // namespace slam

#define SLAM_POSE_UPDATE_TAIL_ENTRY(NAME, T)                                                                 \
  extern "C" int NAME(int m, const void* d, const void* dz, const void* nu, const void* r, const void* mu,    \
                      const void* cov, double thr, void* cov_out, void* mu_out, void* m2, void* acc,          \
                      long long nb, void* stream) {                                                          \
    return slam::launch_pose_update_tail<T>(m, d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, nb,     \
                                            stream);                                                        \
  }                                                                                                          \
  extern "C" int NAME##_warps(int m, long long nb) { return slam::pose_update_tail_warps<T>(m, nb, false); } \
  extern "C" int NAME##_resident(int m, long long nb) { return slam::pose_update_tail_warps<T>(m, nb, true); }

SLAM_POSE_UPDATE_TAIL_ENTRY(slam_pose_update_tail_f32, float)
SLAM_POSE_UPDATE_TAIL_ENTRY(slam_pose_update_tail_f64, double)
