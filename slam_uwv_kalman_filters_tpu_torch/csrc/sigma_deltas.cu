// K1 · sigma-point deltas of a bank of SPD matrices.
//
// Replaces the TPU kernel ops/kernels.py::_sigma_deltas_kernel (launched by
// _sigma_deltas_lanes) and its core equilibrated_sigma_columns: the
// equilibrated Cholesky L = D·chol(D^-1·A·D^-1) of each (n, n) matrix and the
// ukfom deltas (2n+1, n): row 0 zero, rows 2j+1 / 2j+2 = ±column j of L. A
// matrix with a pivot that is not positive (or NaN) gets NaN in all of its
// ±rows, as the plain version's failed library factorization gives.
//
// Bound on Hopper: memory, as a function (the lower half read, (2n+1)·n
// outputs written, ~n³/3 FMAs: 1.11 ms at bank 131 072, n = 53, float32;
// 2.2 µs at bank 256). Its first design, one thread per matrix with the
// factor in bank-last global scratch, made ~n³/6 dependent read-modify-writes
// through L2: 4.2 ms at bank 256, where two SMs did all the work, and ~4 ms
// for one matrix. Here one warp factors one matrix in shared memory
// (warp_factor.cuh): no global scratch, every SM busy from a few hundred
// matrices up, and a step's downdate spread over the lanes. What is left is
// the shared-memory traffic of the factor (~n³/6 loads and stores, over 132
// SMs at large banks) and the n dependent steps of one warp at small banks.
// The deltas are written from shared memory once the factor is done, through
// the output's strides.
//
// Inputs: a, with element strides ga (bank, row, col), lower half read.
// Output: out (2n+1, n) per instance, element strides go (bank, row, col).
// Lanes layout: a (n, n, N) in (col, row, N) order, out (2n+1, n, N); bank-first:
// a (N, n, n), out (N, 2n+1, n).

#include "warp_factor.cuh"

namespace slam {

template <typename T>
__global__ void __launch_bounds__(kWarpSize* kMaxWarps)
sigma_deltas_kernel(const T* __restrict__ a, Strides ga, T* __restrict__ out, Strides go, int n, long long nb,
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
  block_walk(go, 2 * n + 1, n, false, log_w, b0, nb, [&](int i, int p, int r) {
    const T* s = base + i * tile;
    T v = T(0);
    if (p > 0) {
      const int j = (p - 1) >> 1;
      v = ok[i] ? s[j * ld + r] * s[n * ld + r] : d_nan(T(0));
      if (!(p & 1)) v = -v;
    }
    out[(b0 + i) * go.bank + p * go.row + r * go.col] = v;
  });
}

template <typename T>
int launch_sigma_deltas(const void* a, Strides ga, void* out, Strides go, int n, long long nb, void* stream) {
  if (n < 1 || n > kMaxN || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  static const long long max_bytes = opt_in_smem(sigma_deltas_kernel<T>);
  if (max_bytes < 0) return static_cast<int>(-max_bytes);
  const long long tile = static_cast<long long>(n) * warp_ld(n) + 2 * n;
  const int log_w = warps_log2(nb, tile * static_cast<long long>(sizeof(T)), max_bytes);
  if (log_w < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>((tile * sizeof(T) + sizeof(int)) << log_w);
  const unsigned blocks = static_cast<unsigned>((nb + (1LL << log_w) - 1) >> log_w);
  const int threads = kWarpSize << log_w;
  sigma_deltas_kernel<T><<<blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), ga, static_cast<T*>(out), go, n, nb, log_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

extern "C" int slam_sigma_deltas_f32(const void* a, long long a_bank, long long a_row, long long a_col, void* out,
                                     long long o_bank, long long o_row, long long o_col, int n, long long nb,
                                     void* stream) {
  return slam::launch_sigma_deltas<float>(a, {a_bank, a_row, a_col}, out, {o_bank, o_row, o_col}, n, nb, stream);
}

extern "C" int slam_sigma_deltas_f64(const void* a, long long a_bank, long long a_row, long long a_col, void* out,
                                     long long o_bank, long long o_row, long long o_col, int n, long long nb,
                                     void* stream) {
  return slam::launch_sigma_deltas<double>(a, {a_bank, a_row, a_col}, out, {o_bank, o_row, o_col}, n, nb, stream);
}
