// K1 · sigma-point deltas of a bank of SPD matrices.
//
// Replaces the TPU kernel ops/kernels.py::_sigma_deltas_kernel (launched by
// _sigma_deltas_lanes) and its core equilibrated_sigma_columns: the
// equilibrated Cholesky L = D·chol(D^-1·A·D^-1) of each (n, n) matrix and the
// ukfom deltas (2n+1, n): row 0 zero, rows 2j+1 / 2j+2 = ±column j of L.
//
// Bound on Hopper: memory. One thread per instance keeps the whole factor in a
// bank-last global scratch (n²/2 entries per instance, ~n³/6 read-modify-
// writes of it), and writes (2n+1)·n outputs. Every access is coalesced (the
// bank is the minor axis) but the working set of a 100k bank is far beyond L2,
// so the scratch traffic, not the ~n³/3 FMAs, sets the time. This first
// version takes that cost for simplicity; a later one keeps a panel of the
// factor in shared memory or registers (one warp per instance).
//
// Inputs: a (n, n, nb) in (col, row, nb) order, lower half read.
// Outputs: out (2n+1, n, nb). Scratch: s (n, n, nb).

#include "common.cuh"

namespace slam {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sigma_deltas_kernel(const T* __restrict__ a, T* __restrict__ out, T* __restrict__ scratch, int n,
                    long long nb) {
  const long long b = instance_index();
  if (b >= nb) return;
  const T* ai = a + b;
  T* oi = out + b;
  T* si = scratch + b;
  T dvec[kMaxN];
  for (int r = 0; r < n; ++r) oi[static_cast<long long>(r) * nb] = T(0);
  auto emit = [&](int j, T piv) {
    const long long plus = static_cast<long long>(2 * j + 1) * n;
    const long long minus = plus + n;
    for (int r = 0; r < n; ++r) {
      const T l = r < j ? T(0) : r == j ? piv : si[(static_cast<long long>(j) * n + r) * nb];
      const T v = l * dvec[r];
      oi[(plus + r) * nb] = v;
      oi[(minus + r) * nb] = -v;
    }
  };
  equilibrated_core<T, false>(ai, si, nb, n, dvec, emit);
}

template <typename T>
int launch_sigma_deltas(const void* a, void* out, void* scratch, int n, long long nb, void* stream) {
  sigma_deltas_kernel<T><<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(out), static_cast<T*>(scratch), n, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

extern "C" int slam_sigma_deltas_f32(const void* a, void* out, void* scratch, int n, long long nb,
                                     void* stream) {
  return slam::launch_sigma_deltas<float>(a, out, scratch, n, nb, stream);
}

extern "C" int slam_sigma_deltas_f64(const void* a, void* out, void* scratch, int n, long long nb,
                                     void* stream) {
  return slam::launch_sigma_deltas<double>(a, out, scratch, n, nb, stream);
}
