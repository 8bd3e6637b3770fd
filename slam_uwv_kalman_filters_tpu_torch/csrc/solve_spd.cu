// K8 · X = A^-1·B for a bank of SPD systems.
//
// Replaces the TPU kernel ops/kernels.py::_solve_spd_kernel (launched by
// _solve_spd_lanes): the equilibrated Cholesky L = D·chol(D^-1·A·D^-1) of
// each (n, n) matrix (warp_factor.cuh, K1's core), then the forward
// substitution L·Y = B (right-looking, as the TPU kernel: each finished y_j is
// subtracted from the rows below) and the backward substitution Lᵀ·X = Y
// (inner products, descending). Division is by the reciprocal of the pivot,
// as on the TPU. A system with a pivot that is not positive (or NaN) gets an
// all-NaN X, as the plain version's failed library factorization gives.
//
// Bound on Hopper: memory, as a function (the lower half and B read, X
// written, ~n³/3 + 2n²k FMAs: 2.2 µs for the smoother's 256 systems of
// n = k = 53 in float32). Its first design was two launches through a global
// scratch of the factor: one thread per system factored it (~n³/6 dependent
// read-modify-writes through L2, two SMs busy at bank 256), then one thread
// per system and right-hand side substituted, 4.1 ms in all. Here one launch
// does everything, one warp per system: the warp factors the system in shared
// memory, scales row r of the factor by D_r once, then runs both
// substitutions with the right-hand sides spread over the lanes (column c on
// lane c % 32; any k, in chunks of up to 64 columns), Y in shared memory
// beside the factor and L read by broadcast; X is written through strides.
// What is left is the n dependent steps of each pass on one warp.
//
// Inputs: a with element strides ga (bank, row, col), lower half read; b
// (n, k) per instance with strides gb. Output: x (n, k) per instance with
// strides gx. Lanes layout: a (n, n, N) in (col, row, N) order, b and x
// (n, k, N); bank-first: a (N, n, n), b and x (N, n, k).

#include "warp_factor.cuh"

namespace slam {

// One warp: Y (n x cols, row-major with row stride yld) <- L^-T·L^-1·Y for
// the lower factor L in s (column-major, ld); lane owns columns lane and
// lane + 32.
template <typename T>
__device__ void warp_substitute(const T* s, int ld, int n, T* y, int yld, int cols) {
  const int c0 = threadIdx.x % kWarpSize, c1 = c0 + kWarpSize;
  const bool a0 = c0 < cols, a1 = c1 < cols;
  for (int j = 0; j < n; ++j) {  // forward: L·Y = B
    const T* cj = s + j * ld;
    const T inv = T(1) / cj[j];
    T* yj = y + j * yld;
    T y0 = T(0), y1 = T(0);
    if (a0) { y0 = yj[c0] * inv; yj[c0] = y0; }
    if (a1) { y1 = yj[c1] * inv; yj[c1] = y1; }
#pragma unroll 4
    for (int r = j + 1; r < n; ++r) {
      const T l = cj[r];
      T* yr = y + r * yld;
      if (a0) yr[c0] -= l * y0;
      if (a1) yr[c1] -= l * y1;
    }
  }
  for (int j = n - 1; j >= 0; --j) {  // backward: Lᵀ·X = Y
    const T* cj = s + j * ld;
    T* yj = y + j * yld;
    T acc0 = a0 ? yj[c0] : T(0), acc1 = a1 ? yj[c1] : T(0);
#pragma unroll 4
    for (int r = j + 1; r < n; ++r) {
      const T l = cj[r];
      const T* yr = y + r * yld;
      if (a0) acc0 -= l * yr[c0];
      if (a1) acc1 -= l * yr[c1];
    }
    const T inv = T(1) / cj[j];
    if (a0) yj[c0] = acc0 * inv;
    if (a1) yj[c1] = acc1 * inv;
  }
}

// right-hand-side columns a warp holds at once: two a lane. Y's row stride
// is one more, odd, so that lanes walking a column of Y (the loads of a
// transposed B) hit distinct banks.
constexpr int kRhsChunk = 2 * kWarpSize;

__host__ __device__ constexpr int rhs_width(int k) {
  return k >= kRhsChunk ? kRhsChunk : (k + kWarpSize - 1) / kWarpSize * kWarpSize;
}

template <typename T>
__global__ void __launch_bounds__(kWarpSize* kMaxWarps)
solve_spd_kernel(const T* __restrict__ a, Strides ga, const T* __restrict__ b, Strides gb, T* __restrict__ x,
                 Strides gx, int n, int k, long long nb, int log_w) {
  const int ld = warp_ld(n), width = rhs_width(k), yld = width + 1, tile = n * ld + 2 * n + n * yld;
  T* const base = warp_smem<T>();
  int* const ok = reinterpret_cast<int*>(base + (tile << log_w));
  const long long b0 = static_cast<long long>(blockIdx.x) << log_w;
  const int w = threadIdx.x / kWarpSize;
  const bool live = b0 + w < nb;
  block_walk(ga, n, n, true, log_w, b0, nb, [&](int i, int r, int c) {
    base[i * tile + c * ld + r] = a[(b0 + i) * ga.bank + r * ga.row + c * ga.col];
  });
  __syncthreads();
  T* const s = base + w * tile;
  if (live) {
    const bool fine = warp_factor(s, s + n * ld, s + n * ld + n, n, ld);
    if (fine) {  // L(r, c) = s(c, r)·D_r, each lane its own rows
      for (int r = threadIdx.x % kWarpSize; r < n; r += kWarpSize) {
        const T dr = s[n * ld + r];
        for (int c = 0; c <= r; ++c) s[c * ld + r] *= dr;
      }
    }
    if (threadIdx.x % kWarpSize == 0) ok[w] = fine;
  }
  for (int c0 = 0; c0 < k; c0 += width) {
    const int cols = k - c0 < width ? k - c0 : width;
    __syncthreads();  // the flags are set and the previous chunk is written out
    block_walk(gb, n, cols, false, log_w, b0, nb, [&](int i, int r, int c) {
      base[i * tile + n * ld + 2 * n + r * yld + c] = b[(b0 + i) * gb.bank + r * gb.row + (c0 + c) * gb.col];
    });
    __syncthreads();
    if (live && ok[w]) warp_substitute(s, ld, n, s + n * ld + 2 * n, yld, cols);
    __syncthreads();
    block_walk(gx, n, cols, false, log_w, b0, nb, [&](int i, int r, int c) {
      x[(b0 + i) * gx.bank + r * gx.row + (c0 + c) * gx.col] =
          ok[i] ? base[i * tile + n * ld + 2 * n + r * yld + c] : d_nan(T(0));
    });
  }
}

template <typename T>
int launch_solve_spd(const void* a, Strides ga, const void* b, Strides gb, void* x, Strides gx, int n, int k,
                     long long nb, void* stream) {
  if (n < 1 || n > kMaxN || k < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  static const long long max_bytes = opt_in_smem(solve_spd_kernel<T>);
  if (max_bytes < 0) return static_cast<int>(-max_bytes);
  const long long tile = static_cast<long long>(n) * (warp_ld(n) + 2 + rhs_width(k) + 1);
  const int log_w = warps_log2(nb, tile * static_cast<long long>(sizeof(T)), max_bytes);
  if (log_w < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>((tile * sizeof(T) + sizeof(int)) << log_w);
  const unsigned blocks = static_cast<unsigned>((nb + (1LL << log_w) - 1) >> log_w);
  const int threads = kWarpSize << log_w;
  solve_spd_kernel<T><<<blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), ga, static_cast<const T*>(b), gb, static_cast<T*>(x), gx, n, k, nb, log_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

extern "C" int slam_solve_spd_f32(const void* a, long long a_bank, long long a_row, long long a_col, const void* b,
                                  long long b_bank, long long b_row, long long b_col, void* x, long long x_bank,
                                  long long x_row, long long x_col, int n, int k, long long nb, void* stream) {
  return slam::launch_solve_spd<float>(a, {a_bank, a_row, a_col}, b, {b_bank, b_row, b_col}, x,
                                       {x_bank, x_row, x_col}, n, k, nb, stream);
}

extern "C" int slam_solve_spd_f64(const void* a, long long a_bank, long long a_row, long long a_col, const void* b,
                                  long long b_bank, long long b_row, long long b_col, void* x, long long x_bank,
                                  long long x_row, long long x_col, int n, int k, long long nb, void* stream) {
  return slam::launch_solve_spd<double>(a, {a_bank, a_row, a_col}, b, {b_bank, b_row, b_col}, x,
                                        {x_bank, x_row, x_col}, n, k, nb, stream);
}
