// K12 · the lower Cholesky factor of a bank of SPD matrices.
//
// Replaces the TPU kernel ops/kernels.py::_cholesky_lanes_kernel (launched by
// _cholesky_lanes from cholesky_banked / cholesky_fast) together with the
// wrapper's equilibration and back-scaling around it: per matrix,
// L = D·chol(D^-1·A·D^-1), D = sqrt(max(diag A, tiny)), written with explicit
// zeros above the diagonal. A matrix with a pivot that is not positive (or
// NaN) is written all NaN, as a failed library factorization is in the plain
// version.
//
// Bound on Hopper: memory, as a function (the lower half read, the whole
// factor written: ~n² elements per matrix against ~n³/3 FMAs; 0.66 ms at
// bank 131 072, n = 53, float32). Its first design gave each thread one
// matrix and ran a one-thread equilibrated core with the output as scratch,
// so the ~n³/6 read-modify-writes of the factor went through L2, and its
// wrapper copied the bank-first input into the lanes layout and the factor
// back (41% of the call). Here one warp factors one matrix in shared memory
// (warp_factor.cuh, that core's operation order, so float64 agrees with the
// first design to rounding), the block's warps load their
// matrices' lower halves and write their factors through element strides
// (block_walk), so either layout and strided views go in and out without a
// copy. What is left is the factor's shared-memory traffic, as in K1.
//
// Inputs: a, element strides ga (bank, row, col), lower half (row >= col)
// read. Output: out (n x n per instance), element strides go (bank, row,
// col), L(r, c) = s[c·ld + r]·D_r. Lanes layout: a and out (n, n, N) in
// (col, row, N) order; bank-first: (N, n, n).

#include "warp_factor.cuh"

namespace slam {

template <typename T>
__global__ void __launch_bounds__(kWarpSize* kMaxWarps)
cholesky_kernel(const T* __restrict__ a, Strides ga, T* __restrict__ out, Strides go, int n, long long nb,
                int log_w) {
  const int ld = warp_ld(n), tile = n * ld + 2 * n;
  T* const base = warp_smem<T>();
  int* const ok = reinterpret_cast<int*>(base + (tile << log_w));
  const long long b0 = static_cast<long long>(blockIdx.x) << log_w;
  const int w = threadIdx.x / kWarpSize;
  block_walk(ga, n, n, true, log_w, b0, nb, [&](int i, int r, int c) {
    base[i * tile + c * ld + r] = a[(b0 + i) * ga.bank + r * ga.row + c * ga.col];
  });
  __syncthreads();
  if (b0 + w < nb) {
    T* s = base + w * tile;
    const bool fine = warp_factor(s, s + n * ld, s + n * ld + n, n, ld);
    if (threadIdx.x % kWarpSize == 0) ok[w] = fine;
  }
  __syncthreads();
  block_walk(go, n, n, false, log_w, b0, nb, [&](int i, int r, int c) {
    const T* s = base + i * tile;
    const T v = !ok[i] ? d_nan(T(0)) : r < c ? T(0) : s[c * ld + r] * s[n * ld + r];
    out[(b0 + i) * go.bank + r * go.row + c * go.col] = v;
  });
}

// The launch's warps per block as log2, or a negated cudaError_t.
template <typename T>
int cholesky_log_w(int n, long long nb) {
  if (n < 1 || n > kMaxN || nb < 1) return -static_cast<int>(cudaErrorInvalidValue);
  static const long long max_bytes = opt_in_smem(cholesky_kernel<T>);
  if (max_bytes < 0) return static_cast<int>(max_bytes);
  const long long tile = static_cast<long long>(n) * warp_ld(n) + 2 * n;
  const int log_w = warps_log2(nb, tile * static_cast<long long>(sizeof(T)), max_bytes);
  return log_w < 0 ? -static_cast<int>(cudaErrorInvalidValue) : log_w;
}

template <typename T>
int launch_cholesky(const void* a, Strides ga, void* out, Strides go, int n, long long nb, void* stream) {
  const int log_w = cholesky_log_w<T>(n, nb);
  if (log_w < 0) return -log_w;
  const long long tile = static_cast<long long>(n) * warp_ld(n) + 2 * n;
  const size_t bytes = static_cast<size_t>((tile * sizeof(T) + sizeof(int)) << log_w);
  const unsigned blocks = static_cast<unsigned>((nb + (1LL << log_w) - 1) >> log_w);
  cholesky_kernel<T><<<blocks, kWarpSize << log_w, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), ga, static_cast<T*>(out), go, n, nb, log_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_CHOLESKY_ENTRY(NAME, T)                                                                          \
  extern "C" int NAME(const void* a, long long a_bank, long long a_row, long long a_col, void* out,            \
                      long long o_bank, long long o_row, long long o_col, int n, long long nb, void* stream) { \
    return slam::launch_cholesky<T>(a, {a_bank, a_row, a_col}, out, {o_bank, o_row, o_col}, n, nb, stream);   \
  }                                                                                                            \
  extern "C" int NAME##_warps(int n, long long nb) {                                                           \
    const int log_w = slam::cholesky_log_w<T>(n, nb);                                                          \
    return log_w < 0 ? log_w : 1 << log_w;                                                                     \
  }

SLAM_CHOLESKY_ENTRY(slam_cholesky_f32, float)
SLAM_CHOLESKY_ENTRY(slam_cholesky_f64, double)
