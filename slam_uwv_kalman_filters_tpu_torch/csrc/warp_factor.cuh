// The warp-per-matrix equilibrated Cholesky core of K1, K2, K3, K5, K8, K11
// and K12.
//
// Replaces, for all of them, the TPU core ops/kernels.py::
// equilibrated_sigma_columns (and, for K12, the factor of _cholesky_lanes_
// kernel). The function and the operation order are those of the first
// (one-thread) kernels' core: L = D·chol(D^-1·A·D^-1), D = sqrt(max(diag A,
// tiny)), only the lower half (row >= col) of A read; right-looking, column
// j scaled by the reciprocal of its pivot, then the trailing columns
// downdated in ascending j, each entry by one multiply-add. So the results
// are that core's bits.
//
// One warp factors one matrix in dynamic shared memory. Per warp the block's
// shared memory holds a tile: the matrix column-major with an odd leading
// dimension ld (entry (r, c) at s[c*ld + r]), then D and D^-1 (n each), then
// whatever the kernel adds (K8: the right-hand sides; K3: see
// warp_update.cuh; K11: see warp_markers.cuh). Lanes own rows: row r belongs
// to lane r % 32, so n <= 64 gives a lane two rows, whose column-j entries
// it keeps in registers through step j. Every lane reads the pivot and l_kj from one shared address (a
// broadcast); a warp walking a row (stride ld) hits 32 distinct banks because
// ld is odd. There is no global scratch and no per-lane array indexed by a
// loop variable.
//
// A block holds W = 2^log_w warps and W consecutive instances. Global arrays
// are read and written through element strides (bank, row, col), so the
// bank-last lanes layout and the bank-first layout go in without a copy:
// where the bank axis is the minor one the whole block walks its W instances
// fastest (W·sizeof(T) contiguous bytes per entry); otherwise each warp walks
// its own matrix with its lanes along the axis of the smaller stride.
#pragma once

#include "common.cuh"

namespace slam {

constexpr int kWarpSize = 32;
constexpr int kMaxWarpsLog2 = 3;     // at most 8 warps (instances) per block
constexpr int kMaxWarps = 1 << kMaxWarpsLog2;
constexpr int kSpreadBlocks = 264;   // fewer warps per block until the grid has two blocks per SM

// element strides of a banked matrix argument: bank, row, column
struct Strides {
  long long bank, row, col;
};

__host__ __device__ constexpr int warp_ld(int n) { return n | 1; }

template <typename T>
__device__ __forceinline__ T* warp_smem() {
  extern __shared__ __align__(16) unsigned char slam_warp_smem[];
  return reinterpret_cast<T*>(slam_warp_smem);
}

// Calls f(w, r, c) for every instance w of the block with b0 + w < nb and
// every (r, c) of an R x C grid (only r >= c where `lower`), in the order the
// header describes. The caller synchronizes the block before and after.
template <typename F>
__device__ __forceinline__ void block_walk(const Strides& g, int R, int C, bool lower, int log_w, long long b0,
                                           long long nb, F f) {
  const int W = 1 << log_w;
  if (g.bank == 1 && W > 1) {
    for (int c = 0; c < C; ++c) {
      const int r0 = lower ? c : 0;
      const int count = (R - r0) << log_w;
      for (int i = threadIdx.x; i < count; i += blockDim.x) {
        const int w = i & (W - 1);
        if (b0 + w < nb) f(w, r0 + (i >> log_w), c);
      }
    }
    return;
  }
  const int w = threadIdx.x / kWarpSize, lane = threadIdx.x % kWarpSize;
  if (b0 + w >= nb) return;
  if (g.col <= g.row) {  // lanes along the columns
    for (int r = 0; r < R; ++r) {
      const int cend = lower && r + 1 < C ? r + 1 : C;
      for (int c = lane; c < cend; c += kWarpSize) f(w, r, c);
    }
  } else {  // lanes along the rows
    for (int c = 0; c < C; ++c) {
      for (int r = (lower ? c : 0) + lane; r < R; r += kWarpSize) f(w, r, c);
    }
  }
}

// One warp: the lower half of A in s (column-major, ld) -> the equilibrated
// factor L̃ = chol(D^-1·A·D^-1) in place with explicit zeros above the
// diagonal (factor column j is s[j*ld + r]·D_r), D in d and D^-1 in dinv.
// Returns false at the first pivot that is not positive (or NaN), the same
// value on every lane; with STOP it stops there, without it factors on (the
// NaN then runs through the rest of the factor, as the first one-thread
// kernels did). Without ZERO_UPPER the strict upper half is neither read nor
// written, so a caller may keep other data there (K11 keeps its augmented
// covariance).
template <typename T, bool STOP = true, bool ZERO_UPPER = true>
__device__ bool warp_factor(T* s, T* d, T* dinv, int n, int ld) {
  bool fine = true;
  const int r0 = threadIdx.x % kWarpSize, r1 = r0 + kWarpSize;
  for (int r = r0; r < n; r += kWarpSize) {
    d[r] = d_sqrt(d_max(s[r * ld + r], d_tiny(T(0))));
    dinv[r] = T(1) / d[r];
  }
  __syncwarp();
  const T di0 = r0 < n ? dinv[r0] : T(0), di1 = r1 < n ? dinv[r1] : T(0);
  for (int c = 0; c < n; ++c) {
    const T dc = dinv[c];
    if (r0 >= c && r0 < n) s[c * ld + r0] *= dc * di0;
    if (r1 >= c && r1 < n) s[c * ld + r1] *= dc * di1;
  }
  for (int j = 0; j < n; ++j) {
    __syncwarp();
    T* cj = s + j * ld;
    const T piv = d_sqrt(cj[j]);
    if (!(piv > T(0))) {
      if (STOP) return false;
      fine = false;
    }
    const T inv = T(1) / piv;
    T x0 = T(0), x1 = T(0);
    if (r0 > j && r0 < n) { x0 = cj[r0] * inv; cj[r0] = x0; }
    if (r1 > j && r1 < n) { x1 = cj[r1] * inv; cj[r1] = x1; }
    __syncwarp();  // every lane has read the diagonal; column j below it is final
    if (ZERO_UPPER) {
      if (r0 < j) cj[r0] = T(0);
      if (r1 < j) cj[r1] = T(0);
    }
    if (r0 == j) cj[r0] = piv;
    if (r1 == j) cj[r1] = piv;
    int k = j + 1;
#pragma unroll 4
    for (; k < n && k < kWarpSize; ++k) {  // rows r0 and r1 may lie at or below k
      const T lkj = cj[k];
      T* ck = s + k * ld;
      if (r0 >= k && r0 < n) ck[r0] -= lkj * x0;
      if (r1 < n) ck[r1] -= lkj * x1;
    }
#pragma unroll 4
    for (; k < n; ++k) {  // only r1 can lie at or below k
      const T lkj = cj[k];
      T* ck = s + k * ld;
      if (r1 >= k && r1 < n) ck[r1] -= lkj * x1;
    }
  }
  __syncwarp();
  return fine;
}

// ---- host side -------------------------------------------------------------

// The largest dynamic shared memory a block of `kernel` may use, raised from
// the default 48 KB to the device's opt-in limit (227 KB on Hopper). Call it
// once per kernel instantiation (a function-local static); on failure the
// negated cudaError_t.
template <typename Kernel>
inline long long opt_in_smem(Kernel kernel) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err == cudaSuccess ? bytes : -static_cast<long long>(err);
}

// log2 of the warps per block for a tile of `tile_bytes` per warp (plus the
// flag): at most kMaxWarps, within `max_bytes`, and fewer while the bank
// would give fewer than kSpreadBlocks blocks. -1 if one warp does not fit.
inline int warps_log2(long long nb, long long tile_bytes, long long max_bytes) {
  const long long per_warp = tile_bytes + static_cast<long long>(sizeof(int));
  if (per_warp > max_bytes) return -1;
  int log_w = kMaxWarpsLog2;
  while (log_w > 0 && ((per_warp << log_w) > max_bytes || (nb >> log_w) < kSpreadBlocks)) --log_w;
  return log_w;
}

// log2 of the warps per block for a kernel whose warps take `warp_bytes`
// each (block-wide extras included): among the block sizes the bank spreads
// over kSpreadBlocks blocks (one warp always), the largest that keeps
// kResidentWarps warps resident on an SM, or else the widest that keeps the
// most (the occupancy calculator counts shared memory and registers). More
// warps a block coalesce more of a bank-last walk; more warps an SM hide more
// of each warp's latency. -1 if one warp does not fit, or the negated
// cudaError_t of a failed query minus 1; `resident`, where given, receives
// the warps an SM keeps at the chosen size.
constexpr int kResidentWarps = 12;

template <typename Kernel>
inline int resident_warps_log2(Kernel kernel, long long nb, long long warp_bytes, long long max_bytes,
                               int* resident = nullptr) {
  int best = -1, best_warps = 0, chosen = -1, chosen_warps = 0;
  for (int log_w = 0; log_w <= kMaxWarpsLog2; ++log_w) {
    if ((warp_bytes << log_w) > max_bytes || (log_w > 0 && (nb >> log_w) < kSpreadBlocks)) break;
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kWarpSize << log_w, static_cast<size_t>(warp_bytes << log_w));
    if (err != cudaSuccess) return -1 - static_cast<int>(err);
    const int warps = blocks << log_w;
    if (warps > 0 && warps >= best_warps) best = log_w, best_warps = warps;
    if (warps >= kResidentWarps) chosen = log_w, chosen_warps = warps;
  }
  if (resident) *resident = chosen >= 0 ? chosen_warps : best_warps;
  return chosen >= 0 ? chosen : best;
}

}  // namespace slam
